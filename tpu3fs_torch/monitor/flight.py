"""Flight recorder: a bounded in-process black box in every binary.

The port's own copy of ``tpu3fs/monitor/flight.py``,
unchanged but for its imports.

Production postmortems need "what was this process doing right before
it went wrong" — and the trace/monitor pipeline, built for live
operation, ships its data AWAY on a period, so the last seconds before
a crash or an SLO breach are exactly the ones most likely lost. The
flight recorder keeps them: a bounded ring (deque, O(ring_events)
memory by construction) of

- recent SLOW-OP SPANS (fed by the tracer's slow-op flush hook —
  spans.py calls every registered hook with the op's accumulated
  events whenever an op crosses ``slow_op_ms``);
- recent SAMPLES (the recorder pipeline's collect output, via the
  ``sample_sink()`` Monitor sink);
- CONFIG-PUSH events (mgmtd heartbeat pushes and core
  ``hotUpdateConfig`` RPCs — "what changed right before it broke");
- ALERT events (SLO state-machine transitions, collector process).

Dump triggers (all write one JSONL file under the configured dir):

- SLO breach: the collector bumps ``dump_epoch`` in its write-RPC Ack
  when a rule fires; every binary's ``BufferedCollectorSink`` sees the
  bump on its next push and dumps locally — the whole fleet snapshots
  its black boxes within one push period of the breach;
- fatal signal: the app's SIGTERM/SIGINT handler dumps before stopping,
  and SIGUSR2 dumps WITHOUT stopping (kill -USR2 = "show me");
- on demand: the core service's ``flightDump`` RPC / ``admin_cli
  flight-dump``.

Dump rows are flat JSON objects tagged ``kind`` (span/sample/config/
alert/meta); ``analytics.assemble.load_flight`` merges the dumps of N
processes back into one timeline, joining span rows through the span
trace machinery (trace ids cross process boundaries).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional

from tpu3fs_torch.utils.config import Config, ConfigItem


class FlightConfig(Config):
    """The per-binary ``[flight]`` section (hot-updatable)."""

    enabled = ConfigItem(True, hot=True)
    # dump directory; "" = ring still records, dumps need an explicit
    # path (flightDump RPC) — so tests/dev don't spray files
    dir = ConfigItem("", hot=True)
    ring_events = ConfigItem(4096, hot=True, checker=lambda v: v >= 16)


class FlightRecorder:
    """Process-global bounded event ring + dumper."""

    def __init__(self, *, ring_events: int = 4096):
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=int(ring_events))
        self.enabled = True
        self.service = "proc"
        self.node = 0
        self.dump_dir = ""
        self.dumps = 0
        self._rec = None  # lazy flight.dumps counter

    def configure(self, *, service: Optional[str] = None,
                  node: Optional[int] = None,
                  dump_dir: Optional[str] = None,
                  ring_events: Optional[int] = None,
                  enabled: Optional[bool] = None) -> "FlightRecorder":
        with self._lock:
            if service is not None:
                self.service = service
            if node is not None:
                self.node = int(node)
            if dump_dir is not None:
                self.dump_dir = dump_dir
            if enabled is not None:
                self.enabled = bool(enabled)
            if ring_events is not None and \
                    int(ring_events) != self._ring.maxlen:
                self._ring = collections.deque(
                    self._ring, maxlen=int(ring_events))
        return self

    # -- feeds ---------------------------------------------------------------
    def record(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        fields["kind"] = kind
        fields.setdefault("ts", time.time())
        # deque.append is GIL-atomic; feeds come from many threads
        self._ring.append(fields)

    def record_spans(self, events) -> None:
        """Tracer slow-op hook: one row per accumulated span event."""
        if not self.enabled:
            return
        for ev in events:
            row = dict(ev.__dict__)
            row["kind"] = "span"
            self._ring.append(row)

    def sample_sink(self) -> "_FlightSampleSink":
        """A Monitor sink keeping the most recent samples in the ring
        (memoized: N apps in one process install ONE sink)."""
        sink = getattr(self, "_sample_sink", None)
        if sink is None:
            sink = _FlightSampleSink(self)
            self._sample_sink = sink
        return sink

    # -- dump ----------------------------------------------------------------
    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def dump(self, path: Optional[str] = None, *,
             reason: str = "manual") -> str:
        """Write the ring to one JSONL file; returns its path (empty
        when no dir is configured and none was given)."""
        rows = self.snapshot()
        if path is None:
            if not self.dump_dir:
                return ""
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(
                self.dump_dir,
                f"flight-{self.service}-{self.node}-{os.getpid()}"
                f"-{time.time():.3f}.jsonl")
        else:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
        meta = {"kind": "meta", "ts": time.time(), "reason": reason,
                "service": self.service, "node": self.node,
                "pid": os.getpid(), "events": len(rows)}
        with open(path, "w") as f:
            f.write(json.dumps(meta) + "\n")
            for row in rows:
                try:
                    f.write(json.dumps(row) + "\n")
                except (TypeError, ValueError):
                    f.write(json.dumps(
                        {"kind": row.get("kind", "?"),
                         "ts": row.get("ts", 0.0),
                         "repr": repr(row)}) + "\n")
        self.dumps += 1
        self._count_dump()
        return path

    def _count_dump(self) -> None:
        rec = self._rec
        if rec is None:
            from tpu3fs_torch.monitor.recorder import CounterRecorder

            rec = CounterRecorder("flight.dumps")
            self._rec = rec
        rec.add()


class _FlightSampleSink:
    """Monitor sink -> flight ring (compact rows, value+count only:
    the collector keeps the full-fidelity copy; the black box keeps
    what fits)."""

    def __init__(self, flight: FlightRecorder):
        self._flight = flight

    def write(self, samples) -> None:
        fl = self._flight
        if not fl.enabled:
            return
        for s in samples:
            fl._ring.append({
                "kind": "sample", "ts": s.ts, "name": s.name,
                "tags": s.tags, "value": s.value, "count": s.count,
                "p99": s.p99,
            })


_FLIGHT = FlightRecorder()


def flight() -> FlightRecorder:
    return _FLIGHT


def apply_flight_config(cfg: FlightConfig, *, service: str, node: int,
                        target: Optional[FlightRecorder] = None) -> None:
    """Bind a [flight] config section (and follow its hot updates)."""
    fl = target if target is not None else _FLIGHT

    def _apply(_node=None):
        fl.configure(service=service, node=node, dump_dir=cfg.dir,
                     ring_events=int(cfg.ring_events),
                     enabled=bool(cfg.enabled))

    _apply()
    cfg.add_callback(_apply)
