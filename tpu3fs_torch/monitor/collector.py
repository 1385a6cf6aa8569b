"""monitor_collector's wire types and the push sinks every binary ships
its samples through.

The port's own copy of the sink half of ``tpu3fs/monitor/collector.py``:
``SampleBatch``, ``Ack``, ``QueryReq``, ``CollectorSink``,
``LocalCollectorSink`` and ``BufferedCollectorSink``, unchanged but for
their imports. ``CollectorService`` and ``bind_collector_service`` need
``monitor/agg.py``, ``monitor/slo.py`` and ``bin/monitor_main.py`` and
are not ported yet (ROADMAP M6a-2b), and with them the ``aggQuery`` and
``sloStatus`` wire types. A push with no collector address ships
nothing, as in the JAX package.

Every server's Monitor pushes Sample batches over RPC (ref
MonitorCollectorService.h:24-31, 4096 samples per flush); the Ack of a
push carries the collector's ``dump_epoch``, and each binary's
``BufferedCollectorSink`` reacts to its growth by dumping its local
flight recorder.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional

from tpu3fs_torch.monitor.recorder import Sample
from tpu3fs_torch.rpc.net import RpcClient

COLLECTOR_SERVICE_ID = 5  # ref fbs/monitor_collector
FLUSH_BATCH = 4096


@dataclass
class SampleBatch:
    samples: List[Sample] = field(default_factory=list)


@dataclass
class Ack:
    accepted: int = 0
    # flight-recorder dump generation (trailing field: old peers ignore
    # it, new peers on old collectors default 0 = never). The SLO
    # engine bumps it on a firing transition; pushers that see it grow
    # dump their local black box.
    dump_epoch: int = 0


@dataclass
class QueryReq:
    name_prefix: str = ""
    since: float = 0.0
    until: float = 0.0
    limit: int = 1000


class CollectorSink:
    """Monitor sink pushing to a remote collector (ref
    MonitorCollectorClient)."""

    def __init__(self, addr, client: RpcClient | None = None):
        self._addr = addr
        self._client = client or RpcClient()

    def write(self, samples: List[Sample]) -> None:
        if not samples:
            return
        self._client.call(
            self._addr, COLLECTOR_SERVICE_ID, 1, SampleBatch(list(samples)), Ack
        )


class LocalCollectorSink:
    """Monitor sink feeding an in-process CollectorService directly —
    the collector binary drinks its own telemetry (slo.* transitions,
    monitor.* self-gauges) with zero RPCs."""

    def __init__(self, service: CollectorService):
        self._service = service

    def write(self, samples: List[Sample]) -> None:
        if samples:
            self._service.write(SampleBatch(list(samples)))


class BufferedCollectorSink:
    """Collector push with BOUNDED buffering across outages.

    The plain CollectorSink raises on every push while the collector is
    down, and Monitor.collect only logs sink errors — samples collected
    during an outage were simply lost. Here samples queue up to
    ``cap_samples``; every write() attempts to drain the whole backlog
    (oldest first, FLUSH_BATCH per RPC), overflow drops the OLDEST
    samples (the newest window is the one an operator debugging the
    outage needs) and counts them on ``monitor.push_dropped`` so the
    loss itself is observable once the collector returns.

    ``addr`` may be a (host, port) tuple or a zero-arg callable
    returning one / None — the hot-config shape (a config push can point
    every service at a collector, or away from a dead one, live).

    Two push-storm defenses ride along:

    - ``backoff``: consecutive failed drains grow a multiplier (2x per
      failure, capped 8x) the push loop applies to its period, so N
      binaries don't hammer a dead collector in lockstep; one success
      resets it.
    - flight-dump epochs: when an Ack's ``dump_epoch`` grows past the
      first one observed, the registered ``on_dump`` callback fires
      (the SLO-breach black-box trigger). The FIRST ack only baselines
      — a fresh process must not dump for a breach that predates it.
    """

    BACKOFF_CAP = 8.0

    def __init__(self, addr, client: RpcClient | None = None,
                 cap_samples: int = 65536):
        import collections

        from tpu3fs_torch.monitor.recorder import CounterRecorder

        self._addr = addr
        self._client = client or RpcClient()
        self._buf = collections.deque()
        self._cap = int(cap_samples)
        self._lock = threading.Lock()
        self.dropped = CounterRecorder("monitor.push_dropped")
        self.pushed = CounterRecorder("monitor.push_samples")
        self._fails = 0
        self._seen_epoch: Optional[int] = None
        self._on_dump = None

    def _resolve_addr(self):
        addr = self._addr() if callable(self._addr) else self._addr
        if not addr:
            return None
        if isinstance(addr, str):
            host, _, port = addr.rpartition(":")
            try:
                return (host or "127.0.0.1", int(port))
            except ValueError:
                return None
        return tuple(addr)

    def backlog(self) -> int:
        with self._lock:
            return len(self._buf)

    @property
    def backoff(self) -> float:
        """Period multiplier for the push loop: 1.0 while the collector
        answers, doubling per consecutive failed drain up to 8x."""
        return min(self.BACKOFF_CAP, 2.0 ** self._fails)

    def on_dump(self, fn) -> None:
        """Register the flight-dump callback, fn(reason: str)."""
        self._on_dump = fn

    def _observe_epoch(self, epoch: int) -> None:
        if self._seen_epoch is None:
            self._seen_epoch = epoch  # baseline, never dump on first ack
            return
        if epoch > self._seen_epoch:
            self._seen_epoch = epoch
            fn = self._on_dump
            if fn is not None:
                try:
                    fn(f"collector dump_epoch {epoch}")
                except Exception:
                    pass  # a dump hook must never break the push loop

    def write(self, samples: List[Sample]) -> None:
        with self._lock:
            self._buf.extend(samples)
            over = len(self._buf) - self._cap
            if over > 0:
                for _ in range(over):
                    self._buf.popleft()
                self.dropped.add(over)
            addr = self._resolve_addr()
            if addr is None:
                return  # unconfigured: buffer (bounded) until pointed
            while self._buf:
                batch = [self._buf.popleft()
                         for _ in range(min(FLUSH_BATCH, len(self._buf)))]
                try:
                    ack = self._client.call(addr, COLLECTOR_SERVICE_ID, 1,
                                            SampleBatch(batch), Ack)
                except Exception:
                    # collector outage: keep the batch for the next period
                    self._buf.extendleft(reversed(batch))
                    self._fails += 1
                    raise
                self._fails = 0
                self.pushed.add(len(batch))
                self._observe_epoch(int(getattr(ack, "dump_epoch", 0)))
