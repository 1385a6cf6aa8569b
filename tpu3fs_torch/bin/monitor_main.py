"""monitor_collector service binary (ref src/monitor_collector/
monitor_collector.cpp): receives Sample batches from all services and
batch-commits them to the analytics sink (JSONL here; the reference writes
ClickHouse/TaosDB, MonitorCollectorService.h:24-31).

Beyond ingest, this binary runs the cluster's JUDGMENT layer:

- a ``WindowedAggregator`` rolls every series up into ring-retained
  windows (rate/last/p50/p90/p99 via ``aggQuery``);
- an ``SloEngine`` evaluates hot-pushed ``[slo]`` rules on a period and
  answers the single cluster verdict (``sloStatus`` / ``admin_cli
  health``); a firing rule bumps the flight-dump epoch every pusher
  sees on its next Ack;
- a retention pass keeps the raw-sample sink bounded (rows beyond the
  horizon are dropped once rolled up), with ``monitor.retained_bytes``
  / ``monitor.ingest_rate`` / ``monitor.agg_*`` self-gauges published
  through the same MemoryMonitor path as every other binary's gauges.

The collector boots one-phase (it cannot fetch config from mgmtd), so
``[slo]`` hot-pushes arrive via the core ``hotUpdateConfig`` RPC —
``admin_cli slo set --collector host:port --spec ...``.

The port's own copy of ``tpu3fs/bin/monitor_main.py``. ``MonitorApp``
takes a keyword ``device`` (else ``--device``, default ``cuda``) like every
app of the port, but the collector does no device work: it creates no CUDA
context. Run it as ``python -m tpu3fs_torch.bin.monitor_main --port P
[--config.out_path=samples.db]``.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

from tpu3fs_torch.app.application import OnePhaseApplication
from tpu3fs_torch.mgmtd.types import NodeType
from tpu3fs_torch.monitor.agg import WindowedAggregator
from tpu3fs_torch.monitor.collector import (
    CollectorService,
    LocalCollectorSink,
    bind_collector_service,
)
from tpu3fs_torch.monitor.flight import FlightConfig
from tpu3fs_torch.monitor.recorder import JsonlSink, Monitor, SqliteSink
from tpu3fs_torch.monitor.slo import SloConfig, SloEngine, apply_slo_config
from tpu3fs_torch.rpc.net import RpcServer
from tpu3fs_torch.analytics.spans import TraceConfig
from tpu3fs_torch.utils.config import Config, ConfigItem
from tpu3fs_torch.qos.core import QosConfig
from tpu3fs_torch.utils.fault_injection import FaultPlaneConfig
from tpu3fs_torch.tenant.quota import TenantConfig


class MonitorAppConfig(Config):
    # QoS admission limits for the collector RPC dispatch (tpu3fs/qos)
    qos = QosConfig
    # cluster fault plane (utils/fault_injection.py): hot-pushed
    # fault rules for chaos drives / gray-failure testing
    faults = FaultPlaneConfig
    # multi-tenant quota table (tpu3fs/tenant): per-tenant
    # WFQ weights + token-bucket limits, hot-pushed via mgmtd
    tenants = TenantConfig
    # observability: distributed tracing + monitor sample push
    # (tpu3fs/analytics/spans.py; both hot-configured)
    trace = TraceConfig
    # SLO rule engine over the windowed aggregates (monitor/slo.py;
    # hot via core hotUpdateConfig — admin_cli slo set)
    slo = SloConfig
    # flight recorder (monitor/flight.py): the collector keeps its own
    # black box too (alert transitions, its self-gauges)
    flight = FlightConfig
    collector = ConfigItem("", hot=True)   # host:port; "" = off
    monitor_push_period_s = ConfigItem(5.0, hot=True)
    out_path = ConfigItem("monitor_samples.jsonl")
    # windowed-aggregation geometry (bounded memory by construction)
    agg_bucket_s = ConfigItem(2.0, checker=lambda v: v > 0)
    agg_slots = ConfigItem(150, checker=lambda v: v >= 2)
    agg_max_series = ConfigItem(8192, hot=True, checker=lambda v: v >= 1)
    # raw-row retention (SqliteSink.compact): rows beyond the horizon
    # are dropped once rolled up; 0 disables an axis
    retain_s = ConfigItem(900.0, hot=True)
    retain_max_bytes = ConfigItem(256 << 20, hot=True)
    compact_interval_s = ConfigItem(30.0, hot=True,
                                    checker=lambda v: v > 0)


class MonitorApp(OnePhaseApplication):
    node_type = NodeType.CLIENT  # monitor nodes are not in the data plane

    def __init__(self, argv: Optional[List[str]] = None, *, sink=None,
                 device=None):
        super().__init__(argv, device=device)
        self._sink = sink
        self.collector: Optional[CollectorService] = None
        self.aggregator: Optional[WindowedAggregator] = None
        self.slo_engine: Optional[SloEngine] = None

    def default_config(self) -> Config:
        return MonitorAppConfig()

    def build_services(self, server: RpcServer) -> None:
        out = self.config.get("out_path")
        if self._sink is not None:
            sink = self._sink
        elif self.flag("sink", "sqlite" if out.endswith(".db")
                       else "jsonl") == "sqlite":
            # queryable store (the ClickHouse stand-in): admin_cli
            # query-metrics reads it over the collector RPC
            sink = SqliteSink(out)
        else:
            sink = JsonlSink(out)
        self.aggregator = WindowedAggregator(
            bucket_s=float(self.config.get("agg_bucket_s")),
            slots=int(self.config.get("agg_slots")),
            max_series=int(self.config.get("agg_max_series")))
        self.slo_engine = SloEngine(self.aggregator)
        apply_slo_config(self.config.slo, self.slo_engine)
        # a firing rule also snapshots THIS process's black box (remote
        # binaries dump via the Ack dump-epoch on their next push)
        self.slo_engine.add_firing_callback(self._dump_local_flight)
        self.collector = CollectorService(
            sink, aggregator=self.aggregator, slo=self.slo_engine)
        bind_collector_service(server, self.collector)
        # the collector drinks its own telemetry (slo.* transitions,
        # monitor.* gauges) straight into its store — zero RPCs
        Monitor.default().add_sink(LocalCollectorSink(self.collector))

    @staticmethod
    def _dump_local_flight(_state) -> None:
        from tpu3fs_torch.monitor.flight import flight

        flight().dump(reason=f"slo breach: {_state.rule}")

    def before_start(self) -> None:
        self.spawn_periodic(
            "slo-eval",
            lambda: float(self.config.get("slo.eval_period_s")),
            self._slo_tick)
        self.spawn_periodic(
            "sink-compact",
            lambda: float(self.config.get("compact_interval_s")),
            self._compact_tick)

    def _slo_tick(self) -> None:
        if self.slo_engine is not None and self.config.get("slo.enabled"):
            self.slo_engine.evaluate()

    def _compact_tick(self) -> None:
        sink = self.collector._sink if self.collector else None
        if sink is not None and hasattr(sink, "compact"):
            sink.compact(float(self.config.get("retain_s")),
                         int(self.config.get("retain_max_bytes")))

    def _start_memory_monitor(self, interval_s: float = 30.0) -> None:
        super()._start_memory_monitor(interval_s)
        # collector self-observability: the judgment layer must be
        # bounded-memory BY CONSTRUCTION, and these gauges prove it live
        sink = self.collector._sink if self.collector else None
        if sink is not None and hasattr(sink, "db_bytes"):
            self.memory_monitor.add_source(
                "monitor.retained_bytes", sink.db_bytes)
        if self.aggregator is not None:
            agg = self.aggregator
            self.memory_monitor.add_source(
                "monitor.agg_series", lambda: agg.stats()["series"])
            self.memory_monitor.add_source(
                "monitor.agg_bytes", lambda: agg.stats()["bytes"])
        if self.collector is not None:
            svc = self.collector
            last = {"t": time.time(), "n": svc.ingested}

            def ingest_rate() -> float:
                now = time.time()
                n = svc.ingested
                dt = max(now - last["t"], 1e-9)
                rate = (n - last["n"]) / dt
                last["t"], last["n"] = now, n
                return rate

            self.memory_monitor.add_source(
                "monitor.ingest_rate", ingest_rate)

    def after_stop(self) -> None:
        if self.collector is not None:
            self.collector.flush()


def main(argv: Optional[List[str]] = None) -> int:
    MonitorApp(argv if argv is not None else sys.argv[1:]).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
