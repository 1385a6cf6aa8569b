"""monitor_collector: the central sample-ingest service + push client.

The port's own copy of ``tpu3fs/monitor/collector.py``, unchanged but for its
imports.

Re-expresses src/monitor_collector (MonitorCollectorService.h:24-31): every
server's Monitor pushes Sample batches over RPC; the collector buffers and
batch-commits (4096 per flush, like the reference) to its sink — JSONL here,
ClickHouse via deploy/sql/tpu3fs-monitor.sql in a real deployment.

Beyond the reference's dumb buffer, the collector is a TIME-SERIES +
VERDICT service: every ingested batch also streams into a
``WindowedAggregator`` (monitor/agg.py — per-series ring retention with
rate/last/percentile rollups queryable over any window via the
``aggQuery`` RPC), and an ``SloEngine`` (monitor/slo.py) continuously
judges those aggregates against hot-pushed ``[slo]`` rules, answering
the single cluster verdict over the ``sloStatus`` RPC. When a rule
FIRES, the collector bumps ``dump_epoch``; the Ack of every subsequent
push carries it (trailing serde field — old peers ignore it), and each
binary's ``BufferedCollectorSink`` reacts by dumping its local flight
recorder — the whole fleet snapshots its black boxes within one push
period of a breach.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tpu3fs_torch.monitor.agg import AggRow, WindowedAggregator
from tpu3fs_torch.monitor.recorder import Sample
from tpu3fs_torch.monitor.slo import RuleState, SloEngine, TransitionRow
from tpu3fs_torch.rpc.net import RpcClient, RpcServer, ServiceDef

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
class AggQueryReq:
    """Windowed-rollup query (see agg.WindowedAggregator.query)."""

    name: str = ""
    tags: Dict[str, str] = field(default_factory=dict)
    window_s: float = 60.0
    until: float = 0.0         # 0 = now
    prefix: bool = False       # name is a prefix, not exact


@dataclass
class AggQueryRsp:
    rows: List[AggRow] = field(default_factory=list)


@dataclass
class SloStatusReq:
    evaluate: bool = True      # run an evaluation pass before answering


@dataclass
class SloStatusRsp:
    verdict: str = "OK"
    firing: List[str] = field(default_factory=list)
    rules: List[RuleState] = field(default_factory=list)
    transitions: List[TransitionRow] = field(default_factory=list)
    evaluated_ts: float = 0.0


class CollectorService:
    def __init__(self, sink, *, aggregator: Optional[WindowedAggregator]
                 = None, slo: Optional[SloEngine] = None):
        self._sink = sink
        self.aggregator = aggregator
        self.slo = slo
        self._buffer: List[Sample] = []
        self._lock = threading.Lock()
        self._dump_epoch = 0
        self._ingested = 0          # cumulative, for the ingest-rate gauge
        if slo is not None:
            slo.add_firing_callback(lambda _st: self.request_flight_dump())

    def write(self, batch: SampleBatch) -> Ack:
        # aggregation first and OUTSIDE the buffer lock: the rollup
        # store has its own lock and must see samples even when the
        # sink is slow
        if self.aggregator is not None:
            self.aggregator.ingest(batch.samples)
        with self._lock:
            self._ingested += len(batch.samples)
            self._buffer.extend(batch.samples)
            if len(self._buffer) >= FLUSH_BATCH:
                self._flush_locked()
        return Ack(len(batch.samples), self._dump_epoch)

    def _flush_locked(self) -> None:
        buf, self._buffer = self._buffer, []
        self._sink.write(buf)

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    @property
    def ingested(self) -> int:
        with self._lock:
            return self._ingested

    # -- flight-dump trigger -------------------------------------------------
    def request_flight_dump(self) -> int:
        """Bump the dump generation: every pusher that observes the new
        epoch on its next Ack dumps its local flight recorder."""
        with self._lock:
            self._dump_epoch += 1
            return self._dump_epoch

    @property
    def dump_epoch(self) -> int:
        return self._dump_epoch

    # -- queries -------------------------------------------------------------
    def query(self, req: "QueryReq") -> SampleBatch:
        """Operator query over the sink (flushes first so recent samples
        are visible); requires a queryable sink (SqliteSink)."""
        self.flush()
        if not hasattr(self._sink, "query"):
            return SampleBatch([])
        return SampleBatch(self._sink.query(
            req.name_prefix, req.since, req.until, req.limit))

    def agg_query(self, req: AggQueryReq) -> AggQueryRsp:
        if self.aggregator is None:
            return AggQueryRsp([])
        return AggQueryRsp(self.aggregator.query(
            req.name, req.tags, req.window_s, until=req.until,
            prefix=req.prefix))

    def slo_status(self, req: SloStatusReq) -> SloStatusRsp:
        import time as _time

        if self.slo is None:
            return SloStatusRsp()
        if req.evaluate:
            self.slo.evaluate()
        verdict, firing = self.slo.health()
        return SloStatusRsp(
            verdict=verdict,
            firing=[s.rule for s in firing],
            rules=sorted(self.slo.snapshot().values(),
                         key=lambda s: s.rule),
            transitions=list(self.slo.transitions)[-64:],
            evaluated_ts=_time.time(),
        )


@dataclass
class QueryReq:
    name_prefix: str = ""
    since: float = 0.0
    until: float = 0.0
    limit: int = 1000


def bind_collector_service(server: RpcServer, service: CollectorService) -> None:
    s = ServiceDef(COLLECTOR_SERVICE_ID, "MonitorCollector")
    s.method(1, "write", SampleBatch, Ack, service.write)
    s.method(2, "query", QueryReq, SampleBatch, service.query)
    s.method(3, "aggQuery", AggQueryReq, AggQueryRsp, service.agg_query)
    s.method(4, "sloStatus", SloStatusReq, SloStatusRsp,
             service.slo_status)
    server.add_service(s)


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
