"""Metric recorders + collection plumbing.

The port's own copy of ``tpu3fs/monitor/recorder.py``,
unchanged but for its imports.

Re-expresses src/common/monitor (Recorder.h:32 — counter, distribution,
OperationRecorder latency family, tag sets; Monitor.cc periodic collection)
and the monitor_collector service (src/monitor_collector/
MonitorCollectorService.h:24-31 — services push Sample batches, the collector
batch-commits to ClickHouse). Here: thread-safe recorders register in a
Monitor registry; collect() snapshots-and-resets; sinks are pluggable (JSONL
file, RPC collector, or the ClickHouse schema in deploy/sql for a real
deployment).
"""

from __future__ import annotations

import json
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Sample:
    name: str
    ts: float
    tags: Dict[str, str]
    value: float = 0.0
    count: int = 0
    # distribution extras
    min: float = 0.0
    max: float = 0.0
    mean: float = 0.0
    p50: float = 0.0
    p90: float = 0.0
    p99: float = 0.0


class _Recorder:
    def __init__(self, name: str, tags: Optional[Dict[str, str]] = None,
                 monitor: Optional["Monitor"] = None):
        self.name = name
        self.tags = dict(tags or {})
        self._lock = threading.Lock()
        (monitor or Monitor.default()).register(self)

    def collect(self, now: float) -> List[Sample]:  # pragma: no cover
        raise NotImplementedError


class CounterRecorder(_Recorder):
    """Monotonic event counter, reported as a delta per collection window;
    ``total`` keeps the count since creation, which ``collect`` does not
    reset (a reader in the process takes differences of it)."""

    def __init__(self, name, tags=None, monitor=None):
        super().__init__(name, tags, monitor)
        self._value = 0
        self._total = 0

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._value += n
            self._total += n

    @property
    def total(self) -> int:
        return self._total

    def collect(self, now: float) -> List[Sample]:
        with self._lock:
            v, self._value = self._value, 0
        if v == 0:
            return []
        return [Sample(self.name, now, self.tags, value=float(v), count=int(v))]


class ValueRecorder(_Recorder):
    """Gauge: reports the last set() value each collection window
    (ref monitor::ValueRecorder — disk capacity/free, queue depths)."""

    def __init__(self, name, tags=None, monitor=None):
        super().__init__(name, tags, monitor)
        self._value: Optional[float] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def collect(self, now: float) -> List[Sample]:
        with self._lock:
            if self._value is None:
                return []
            v = self._value
        return [Sample(self.name, now, self.tags, value=v, count=1)]


class DistributionRecorder(_Recorder):
    """Value distribution via reservoir sampling (the reference uses TDigest;
    a bounded reservoir gives the same quantile reporting contract)."""

    RESERVOIR = 1024

    def __init__(self, name, tags=None, monitor=None):
        super().__init__(name, tags, monitor)
        self._reset()

    def _reset(self):
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._sample: List[float] = []

    def record(self, value: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += value
            self._min = min(self._min, value)
            self._max = max(self._max, value)
            if len(self._sample) < self.RESERVOIR:
                self._sample.append(value)
            else:
                i = random.randrange(self._count)
                if i < self.RESERVOIR:
                    self._sample[i] = value

    def collect(self, now: float) -> List[Sample]:
        with self._lock:
            if self._count == 0:
                return []
            count, total = self._count, self._sum
            mn, mx = self._min, self._max
            sample = sorted(self._sample)
            self._reset()

        def q(p: float) -> float:
            return sample[min(len(sample) - 1, int(p * len(sample)))]

        return [
            Sample(
                self.name, now, self.tags,
                value=total, count=count, min=mn, max=mx,
                mean=total / count, p50=q(0.5), p90=q(0.9), p99=q(0.99),
            )
        ]


class LatencyRecorder:
    """Operation wrapper: success/failure counts + latency distribution
    (ref monitor::OperationRecorder)."""

    def __init__(self, name, tags=None, monitor=None):
        self.succeeded = CounterRecorder(f"{name}.succeeded", tags, monitor)
        self.failed = CounterRecorder(f"{name}.failed", tags, monitor)
        self.latency = DistributionRecorder(f"{name}.latency_us", tags, monitor)

    class _Op:
        def __init__(self, rec: "LatencyRecorder"):
            self._rec = rec
            self.ok = True

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def fail(self):
            self.ok = False

        def __exit__(self, exc_type, exc, tb):
            dt_us = (time.perf_counter() - self._t0) * 1e6
            if exc_type is not None or not self.ok:
                self._rec.failed.add()
            else:
                self._rec.succeeded.add()
            self._rec.latency.record(dt_us)
            return False

    def record(self) -> "_Op":
        return LatencyRecorder._Op(self)


class Monitor:
    """Registry + collection loop + sinks."""

    _default: Optional["Monitor"] = None
    _default_lock = threading.Lock()

    def __init__(self):
        self._recorders: List[_Recorder] = []
        self._lock = threading.Lock()
        self._sinks = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @classmethod
    def default(cls) -> "Monitor":
        with cls._default_lock:
            if cls._default is None:
                cls._default = Monitor()
            return cls._default

    def register(self, rec: _Recorder) -> None:
        import weakref

        with self._lock:
            # weak registration: recorders die with their owning service, so
            # short-lived services (tests, restarts) don't leak registry slots
            self._recorders.append(weakref.ref(rec))

    def add_sink(self, sink) -> None:
        if sink not in self._sinks:  # re-registration must not double-write
            self._sinks.append(sink)

    def collect(self) -> List[Sample]:
        now = time.time()
        out: List[Sample] = []
        with self._lock:
            live = []
            for ref in self._recorders:
                rec = ref()
                if rec is not None:
                    live.append(ref)
            self._recorders = live
            recorders = [ref() for ref in live]
        for rec in recorders:
            if rec is not None:
                out.extend(rec.collect(now))
        for sink in self._sinks:
            try:
                sink.write(out)
            except Exception as e:  # a flaky sink must not stop collection
                import sys

                print(f"monitor sink error: {e!r}", file=sys.stderr)
        return out

    def start(self, period_s: float = 10.0) -> None:
        def loop():
            while not self._stop.wait(period_s):
                try:
                    self.collect()
                except Exception as e:  # keep the collection thread alive
                    import sys

                    print(f"monitor collect error: {e!r}", file=sys.stderr)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)


class JsonlSink:
    """Append samples to a JSONL file (stand-in for the ClickHouse writer;
    schema for a real deployment in deploy/sql/tpu3fs-monitor.sql)."""

    def __init__(self, path: str):
        self._path = path
        self._lock = threading.Lock()

    def write(self, samples: List[Sample]) -> None:
        if not samples:
            return
        with self._lock, open(self._path, "a") as f:
            for s in samples:
                f.write(json.dumps(s.__dict__) + "\n")


class MemorySink:
    def __init__(self):
        self.samples: List[Sample] = []

    def write(self, samples: List[Sample]) -> None:
        self.samples.extend(samples)


class SqliteSink:
    """QUERYABLE sample store — the ClickHouse-writer stand-in with an
    actual query path (ref src/common/monitor/ClickHouseClient.cc +
    deploy/sql/3fs-monitor.sql; the reference's operators query the sink,
    so a write-only file is not parity). One table, batch inserts, WAL
    journaling; thread-safe via one connection per call."""

    SCHEMA = (
        "CREATE TABLE IF NOT EXISTS samples ("
        " ts REAL, name TEXT, value REAL, count INTEGER,"
        " min REAL, max REAL, mean REAL, p50 REAL, p90 REAL, p99 REAL,"
        " tags TEXT)",
        "CREATE INDEX IF NOT EXISTS idx_samples_name_ts"
        " ON samples(name, ts)",
    )

    def __init__(self, path: str):
        self._path = path
        self._lock = threading.Lock()
        with self._connect() as db:
            for stmt in self.SCHEMA:
                db.execute(stmt)

    def _connect(self):
        import sqlite3

        db = sqlite3.connect(self._path, timeout=30.0)
        db.execute("PRAGMA journal_mode=WAL")
        return db

    def write(self, samples: List[Sample]) -> None:
        if not samples:
            return
        rows = [
            (s.ts, s.name, s.value, s.count, s.min, s.max, s.mean,
             s.p50, s.p90, s.p99, json.dumps(s.tags, sort_keys=True))
            for s in samples
        ]
        with self._lock, self._connect() as db:
            db.executemany(
                "INSERT INTO samples VALUES (?,?,?,?,?,?,?,?,?,?,?)", rows)

    def db_bytes(self) -> int:
        """On-disk footprint (main db + WAL), the retained-bytes gauge."""
        import os

        total = 0
        for suffix in ("", "-wal", "-shm"):
            try:
                total += os.path.getsize(self._path + suffix)
            except OSError:
                pass
        return total

    def compact(self, retention_s: float = 0.0,
                max_bytes: int = 0) -> int:
        """Age/size-capped retention pass: drop raw rows older than the
        retention horizon (they're already rolled up in the collector's
        windowed aggregator), then, while the db still exceeds
        ``max_bytes``, drop the oldest remaining rows in slices. Returns
        rows removed. 0 on either knob disables that axis."""
        import time as _time

        removed = 0
        with self._lock, self._connect() as db:
            if retention_s and retention_s > 0:
                cur = db.execute("DELETE FROM samples WHERE ts < ?",
                                 (_time.time() - retention_s,))
                removed += cur.rowcount
        if removed:
            self._reclaim()
        if max_bytes and max_bytes > 0:
            # size cap: estimate the over-budget row fraction, delete
            # that many OLDEST rows, reclaim, re-check — bounded passes
            # so a misconfigured tiny cap can't loop forever
            for _ in range(6):
                cur_bytes = self.db_bytes()
                if cur_bytes <= max_bytes:
                    break
                with self._lock, self._connect() as db:
                    n = db.execute(
                        "SELECT COUNT(*) FROM samples").fetchone()[0]
                    if n == 0:
                        break
                    frac = 1.0 - max_bytes / cur_bytes
                    k = min(n, max(n // 8, int(n * frac)))
                    row = db.execute(
                        "SELECT ts FROM samples ORDER BY ts LIMIT 1"
                        " OFFSET ?", (k,)).fetchone()
                    if row is None:
                        c = db.execute("DELETE FROM samples")
                    else:
                        c = db.execute(
                            "DELETE FROM samples WHERE ts < ?",
                            (row[0],))
                    removed += c.rowcount
                    if c.rowcount == 0:
                        break
                self._reclaim()
        return removed

    def _reclaim(self) -> None:
        """DELETE leaves pages free inside the file; checkpoint + VACUUM
        so the retained-bytes gauge (and the disk) actually shrink."""
        with self._lock:
            db = self._connect()
            try:
                db.execute("PRAGMA wal_checkpoint(TRUNCATE)")
                db.isolation_level = None  # VACUUM needs autocommit
                db.execute("VACUUM")
            finally:
                db.close()

    def query(self, name_prefix: str = "", since: float = 0.0,
              until: float = 0.0, limit: int = 1000) -> List[Sample]:
        """Newest-first samples filtered by name prefix + time window."""
        q = ("SELECT ts, name, value, count, min, max, mean, p50, p90,"
             " p99, tags FROM samples"
             " WHERE name LIKE ? ESCAPE '\\' AND ts >= ?")
        escaped = (name_prefix.replace("\\", "\\\\")
                   .replace("%", "\\%").replace("_", "\\_"))
        params: list = [escaped + "%", since]
        if until:
            q += " AND ts <= ?"
            params.append(until)
        q += " ORDER BY ts DESC LIMIT ?"
        params.append(max(1, limit))
        with self._lock, self._connect() as db:
            rows = db.execute(q, params).fetchall()
        return [
            Sample(name=r[1], ts=r[0], tags=json.loads(r[10]), value=r[2],
                   count=r[3], min=r[4], max=r[5], mean=r[6], p50=r[7],
                   p90=r[8], p99=r[9])
            for r in rows
        ]
