"""mgmtd service binary (ref src/mgmtd/mgmtd.cpp).

The port's own copy of ``tpu3fs/bin/mgmtd_main.py``. ``MgmtdApp`` takes
a keyword ``device`` (else ``--device``, default ``cuda``) like every app
of the port, though mgmtd itself launches no kernel; ``--kv`` must be
empty (the network KV engines are ROADMAP M6a-2b). Run it as
``python -m tpu3fs_torch.bin.mgmtd_main --node-id 1 --port P``.

One-phase boot (mgmtd cannot fetch config from itself); holds the cluster KV
store, serves heartbeat/routing/admin RPCs and runs the background updaters:
lease extension, heartbeat checking, chain updating (ref
src/mgmtd/background/{MgmtdLeaseExtender,MgmtdHeartbeatChecker,
MgmtdChainsUpdater}).
"""

from __future__ import annotations

import sys
from typing import List, Optional

from tpu3fs_torch.app.application import OnePhaseApplication
from tpu3fs_torch.mgmtd.service import Mgmtd, MgmtdConfig
from tpu3fs_torch.mgmtd.types import NodeType
from tpu3fs_torch.rpc.net import RpcServer
from tpu3fs_torch.rpc.services import bind_mgmtd_admin, bind_mgmtd_service
from tpu3fs_torch.analytics.spans import TraceConfig
from tpu3fs_torch.monitor.flight import FlightConfig
from tpu3fs_torch.utils.config import Config, ConfigItem
from tpu3fs_torch.qos.core import QosConfig
from tpu3fs_torch.utils.fault_injection import FaultPlaneConfig
from tpu3fs_torch.tenant.quota import TenantConfig


class MgmtdAppConfig(Config):
    # QoS admission limits for the mgmtd RPC dispatch (tpu3fs/qos)
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
    # flight recorder (monitor/flight.py): bounded in-process black box
    # dumped on SLO breach / fatal signal / admin_cli flight-dump
    flight = FlightConfig
    collector = ConfigItem("", hot=True)   # host:port; "" = off
    monitor_push_period_s = ConfigItem(5.0, hot=True)
    lease_length_s = ConfigItem(60.0, hot=True)
    heartbeat_timeout_s = ConfigItem(60.0, hot=True)
    tick_interval_s = ConfigItem(5.0, hot=True)
    # metadata partition count (metashard/partition.py); 0 = no partition
    # table — legacy any-op-anywhere meta servers. Cold: the table is
    # created lazily on the first META heartbeat once a width is set,
    # and the width is persisted with it.
    meta_partitions = ConfigItem(0)


class MgmtdApp(OnePhaseApplication):
    node_type = NodeType.MGMTD

    def __init__(self, argv: Optional[List[str]] = None, *, engine=None,
                 clock=None, device=None):
        super().__init__(argv, device=device)
        # --kv host:port = shared network KV (lease CAS across mgmtds)
        self.engine = engine or self._make_engine()
        self._clock_override = clock
        self.mgmtd: Optional[Mgmtd] = None

    def _make_engine(self):
        from tpu3fs_torch.kv.remote import engine_from_flag

        return engine_from_flag(self.flag("kv", ""))

    def default_config(self) -> Config:
        return MgmtdAppConfig()

    def build_services(self, server: RpcServer) -> None:
        import time as _time

        cfg = MgmtdConfig(
            lease_length_s=self.config.get("lease_length_s"),
            heartbeat_timeout_s=self.config.get("heartbeat_timeout_s"),
            meta_partitions=int(self.config.get("meta_partitions")),
        )
        self.mgmtd = Mgmtd(self.info.node_id or 1, self.engine, cfg,
                           clock=self._clock_override or _time.time)

        # HOT-configurable failure detection: a hotUpdateConfig push of
        # lease_length_s / heartbeat_timeout_s retunes the LIVE Mgmtd
        # (check cadence is already hot via the callable tick interval) —
        # an operator can shorten the gray-node declaration window
        # without restarting the cluster manager
        def _sync_mgmtd_config(_node=None) -> None:
            self.mgmtd.config.lease_length_s = float(
                self.config.get("lease_length_s"))
            self.mgmtd.config.heartbeat_timeout_s = float(
                self.config.get("heartbeat_timeout_s"))

        self.config.add_callback(_sync_mgmtd_config)
        svc = bind_mgmtd_service(server, self.mgmtd)
        bind_mgmtd_admin(svc, self.mgmtd)

    def before_start(self) -> None:
        self.mgmtd.extend_lease()
        # hot-updatable cadence: the callable interval re-reads config
        # every tick (utils.executor.PeriodicRunner)
        self.spawn_periodic(
            "mgmtd-tick",
            lambda: self.config.get("tick_interval_s"),
            self.mgmtd.tick,
        )


def main(argv: Optional[List[str]] = None) -> int:
    MgmtdApp(argv if argv is not None else sys.argv[1:]).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
