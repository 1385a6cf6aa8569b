"""Windowed streaming aggregation for the monitor collector.

The port's own copy of ``tpu3fs/monitor/agg.py``, unchanged but for its
imports.

The collector used to be a dumb sample buffer: ``write`` appended rows,
``query`` returned raw rows, and every consumer (admin_cli top, the SLO
engine, drive scripts) re-implemented its own p99 math with a raw-row
scan. This module gives the collector a real time-series layer (the
operator-facing analytical store the reference feeds from
monitor_collector — SURVEY §0 batch-commit to ClickHouse, here kept
queryable in-process):

- per-(name, tags) SERIES with ring-buffer retention: time is cut into
  fixed ``bucket_s`` slots, a series keeps the last ``slots`` of them,
  and every slot holds streaming rollups — value sum + sample count
  (rate for counters), last value by timestamp (gauges), min/max, and a
  FIXED-CENTROID digest of the distribution so p50/p90/p99 are
  queryable over ANY window without raw-row scans;
- ``FixedDigest``: sparse log-spaced buckets (growth ``_GROWTH`` per
  bucket => bounded relative quantile error, ~half the growth factor).
  Incoming ``Sample`` rows are already per-push-window distribution
  summaries (count/min/p50/p90/p99/max from the reservoir recorders);
  ``add_summary`` re-spreads that mass over the inter-quantile segments
  at their geometric midpoints, which merges across windows and
  processes without raw values. Centroid positions are FIXED (a pure
  function of the bucket index), so digests merge by adding counts;
- BOUNDED MEMORY BY CONSTRUCTION: at most ``max_series`` series are
  tracked (new ones beyond the cap are dropped and counted on
  ``monitor.agg_dropped``), each series holds at most ``slots`` slots,
  and each slot's digest is sparse (entries only for buckets its
  summaries touched). ``stats()`` feeds the collector's ``monitor.*``
  self-gauges.

``query(name, tags, window_s)`` returns one ``AggRow`` per matching
series — the shape the ``aggQuery`` RPC ships and the SLO engine
evaluates.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from tpu3fs_torch.monitor.recorder import Sample

# log-spaced digest geometry: buckets cover (1e-3 .. ~3e13) with ~9%
# relative width; values outside clamp to the edge buckets
_MIN_VALUE = 1e-3
_GROWTH = 1.18
_NBUCKETS = 224
_LOG_G = math.log(_GROWTH)


def _bucket_of(v: float) -> int:
    if v <= _MIN_VALUE:
        return 0
    i = int(math.log(v / _MIN_VALUE) / _LOG_G)
    return i if i < _NBUCKETS else _NBUCKETS - 1


def _value_of(i: int) -> float:
    # geometric midpoint of the bucket — the fixed centroid
    return _MIN_VALUE * (_GROWTH ** (i + 0.5))


class FixedDigest:
    """Sparse fixed-centroid histogram: {bucket index: weight}."""

    __slots__ = ("counts", "total")

    def __init__(self):
        self.counts: Dict[int, float] = {}
        self.total = 0.0

    def add(self, value: float, weight: float = 1.0) -> None:
        if weight <= 0.0:
            return
        i = _bucket_of(value)
        self.counts[i] = self.counts.get(i, 0.0) + weight
        self.total += weight

    def add_summary(self, count: int, mn: float, p50: float, p90: float,
                    p99: float, mx: float) -> None:
        """Spread one reservoir summary's mass over its inter-quantile
        segments (each at the segment's geometric midpoint), so merged
        windows keep queryable percentiles."""
        if count <= 0:
            return
        pts = [mn, p50, p90, p99, mx]
        # quantile points must be monotone; recorder summaries are, but
        # a hostile pusher must not corrupt the digest
        for k in range(1, len(pts)):
            if pts[k] < pts[k - 1]:
                pts[k] = pts[k - 1]
        masses = (0.50, 0.40, 0.09, 0.01)
        for (lo, hi), m in zip(zip(pts, pts[1:]), masses):
            mid = math.sqrt(max(lo, _MIN_VALUE) * max(hi, _MIN_VALUE)) \
                if hi > _MIN_VALUE else lo
            self.add(mid, m * count)

    def merge(self, other: "FixedDigest") -> None:
        for i, w in other.counts.items():
            self.counts[i] = self.counts.get(i, 0.0) + w
        self.total += other.total

    def quantile(self, q: float) -> float:
        if self.total <= 0.0:
            return 0.0
        want = min(max(q, 0.0), 1.0) * self.total
        acc = 0.0
        for i in sorted(self.counts):
            acc += self.counts[i]
            if acc >= want:
                return _value_of(i)
        return _value_of(max(self.counts))

    def __len__(self) -> int:
        return len(self.counts)


class _Slot:
    """Rollups of one time bucket of one series."""

    __slots__ = ("start", "vsum", "count", "last", "last_ts",
                 "vmin", "vmax", "digest")

    def __init__(self, start: float):
        self.start = start
        self.vsum = 0.0
        self.count = 0
        self.last = 0.0
        self.last_ts = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.digest: Optional[FixedDigest] = None


def series_key(name: str, tags: Dict[str, str]) -> Tuple:
    return (name,) + tuple(sorted(tags.items()))


class _Series:
    __slots__ = ("name", "tags", "slots", "last_ts", "last_value")

    def __init__(self, name: str, tags: Dict[str, str]):
        self.name = name
        self.tags = dict(tags)
        self.slots: Dict[int, _Slot] = {}  # slot index -> rollups
        self.last_ts = 0.0
        self.last_value = 0.0


@dataclass
class AggRow:
    """One series' rollup over a query window (the aggQuery wire row)."""

    name: str = ""
    tags: Dict[str, str] = field(default_factory=dict)
    window_s: float = 0.0
    count: int = 0          # samples folded into the window
    vsum: float = 0.0       # sum of sample values (counter deltas)
    rate: float = 0.0       # vsum / window_s (counter rate)
    last: float = 0.0       # newest value in the window (gauge)
    last_ts: float = 0.0    # newest sample timestamp of the SERIES
    vmin: float = 0.0
    vmax: float = 0.0
    p50: float = 0.0        # digest quantiles; 0 when no distribution
    p90: float = 0.0
    p99: float = 0.0


class WindowedAggregator:
    """Bounded in-memory rollup store keyed (name, sorted tags)."""

    def __init__(self, *, bucket_s: float = 2.0, slots: int = 150,
                 max_series: int = 8192):
        self.bucket_s = float(bucket_s)
        self.slots = int(slots)
        self.max_series = int(max_series)
        self._series: Dict[Tuple, _Series] = {}
        self._lock = threading.Lock()
        self.dropped = 0        # series beyond the cap (not samples)
        self.ingested = 0

    # -- ingest --------------------------------------------------------------
    def ingest(self, samples: List[Sample]) -> None:
        if not samples:
            return
        with self._lock:
            for s in samples:
                key = series_key(s.name, s.tags or {})
                ser = self._series.get(key)
                if ser is None:
                    if len(self._series) >= self.max_series:
                        self.dropped += 1
                        continue
                    ser = _Series(s.name, s.tags or {})
                    self._series[key] = ser
                self._ingest_one(ser, s)
                self.ingested += 1

    def _ingest_one(self, ser: _Series, s: Sample) -> None:
        idx = int(s.ts // self.bucket_s)
        slot = ser.slots.get(idx)
        if slot is None:
            if len(ser.slots) >= self.slots:
                # ring retention: evict the oldest slot(s)
                for old in sorted(ser.slots)[:len(ser.slots)
                                             - self.slots + 1]:
                    del ser.slots[old]
            slot = _Slot(idx * self.bucket_s)
            ser.slots[idx] = slot
        slot.vsum += s.value
        slot.count += int(s.count) or 1
        if s.ts >= slot.last_ts:
            slot.last_ts = s.ts
            slot.last = s.value
        if s.ts >= ser.last_ts:
            ser.last_ts = s.ts
            ser.last_value = s.value
        # distribution summaries carry quantiles; plain counters/gauges
        # don't (their digest stays unallocated — bounded by shape)
        if s.count > 0 and (s.p99 or s.p90 or s.p50 or s.max != s.min):
            if slot.digest is None:
                slot.digest = FixedDigest()
            slot.digest.add_summary(s.count, s.min, s.p50, s.p90,
                                    s.p99, s.max)
            slot.vmin = min(slot.vmin, s.min)
            slot.vmax = max(slot.vmax, s.max)
        else:
            slot.vmin = min(slot.vmin, s.value)
            slot.vmax = max(slot.vmax, s.value)

    # -- query ---------------------------------------------------------------
    def query(self, name: str = "", tags: Optional[Dict[str, str]] = None,
              window_s: float = 60.0, *, until: float = 0.0,
              prefix: bool = False) -> List[AggRow]:
        """Rollups per matching series over [until - window_s, until].

        ``name`` matches exactly (or as a prefix with ``prefix=True``);
        empty matches all. ``tags`` entries must all match the series'
        tags exactly (series may carry more)."""
        until = until or time.time()
        since = until - window_s
        lo = int(since // self.bucket_s)
        hi = int(until // self.bucket_s)
        out: List[AggRow] = []
        with self._lock:
            for ser in self._series.values():
                if name and not (ser.name.startswith(name) if prefix
                                 else ser.name == name):
                    continue
                if tags and any(ser.tags.get(k) != v
                                for k, v in tags.items()):
                    continue
                row = AggRow(name=ser.name, tags=dict(ser.tags),
                             window_s=window_s, last_ts=ser.last_ts)
                digest: Optional[FixedDigest] = None
                vmin, vmax = float("inf"), float("-inf")
                newest = 0.0
                for idx in range(lo, hi + 1):
                    slot = ser.slots.get(idx)
                    if slot is None:
                        continue
                    row.vsum += slot.vsum
                    row.count += slot.count
                    vmin = min(vmin, slot.vmin)
                    vmax = max(vmax, slot.vmax)
                    if slot.last_ts >= newest:
                        newest = slot.last_ts
                        row.last = slot.last
                    if slot.digest is not None:
                        if digest is None:
                            digest = FixedDigest()
                        digest.merge(slot.digest)
                if row.count:
                    row.rate = row.vsum / max(window_s, 1e-9)
                    row.vmin = 0.0 if vmin == float("inf") else vmin
                    row.vmax = 0.0 if vmax == float("-inf") else vmax
                if digest is not None and digest.total > 0:
                    row.p50 = digest.quantile(0.50)
                    row.p90 = digest.quantile(0.90)
                    row.p99 = digest.quantile(0.99)
                out.append(row)
        out.sort(key=lambda r: (r.name, sorted(r.tags.items())))
        return out

    # -- self-observability --------------------------------------------------
    def stats(self) -> Dict[str, float]:
        with self._lock:
            nslots = 0
            nbuckets = 0
            for ser in self._series.values():
                nslots += len(ser.slots)
                for slot in ser.slots.values():
                    if slot.digest is not None:
                        nbuckets += len(slot.digest)
            return {
                "series": float(len(self._series)),
                "slots": float(nslots),
                # approximate resident bytes: slot fixed fields +
                # sparse digest entries (the bound the self-gauge ships)
                "bytes": float(len(self._series) * 120 + nslots * 96
                               + nbuckets * 64),
                "dropped_series": float(self.dropped),
                "ingested": float(self.ingested),
            }
