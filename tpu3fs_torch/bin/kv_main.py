"""kv service binary: the shared transactional KV store.

Plays the role FoundationDB plays in the reference deployment (meta +
mgmtd persist through one transactional KV; src/fdb/). Serves the Kv RPC
service (snapshot/get/getRange/commit/release) over the MVCC engine with an
optional write-ahead log for restart durability:

  python -m tpu3fs_torch.bin.kv_main --port 9500 [--wal /data/kv.wal] [--rpc native]

or, as a member of a replicated group (kv/replica.py):

  python -m tpu3fs_torch.bin.kv_main --node-id 1 --port 9501 \
      --peers 1=h:9501,2=h:9502,3=h:9503 --data-dir /data/kvd1 --fsync 1

The port's own copy of ``tpu3fs/bin/kv_main.py``. ``KvApp`` takes a keyword
``device`` (else ``--device``, default ``cuda``) like every app of the port,
but the kvd does no device work: it creates no CUDA context. ``--rpc
native`` serves on the C++ transport (``rpc/native_net``). The WAL, the group's log and its snapshot have the JAX package's
bytes, so a kvd of either package replays the other's files.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from tpu3fs_torch.app.application import OnePhaseApplication
from tpu3fs_torch.kv.service import KvService, bind_kv_service
from tpu3fs_torch.mgmtd.types import NodeType
from tpu3fs_torch.rpc.net import RpcServer
from tpu3fs_torch.analytics.spans import TraceConfig
from tpu3fs_torch.monitor.flight import FlightConfig
from tpu3fs_torch.utils.config import Config, ConfigItem
from tpu3fs_torch.qos.core import QosConfig
from tpu3fs_torch.utils.fault_injection import FaultPlaneConfig
from tpu3fs_torch.tenant.quota import TenantConfig


class KvAppConfig(Config):
    # QoS admission limits for the KV RPC dispatch (tpu3fs/qos)
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
    snapshot_ttl_s = ConfigItem(60.0, hot=True)


class KvApp(OnePhaseApplication):
    node_type = NodeType.CLIENT  # not part of the storage data plane

    def __init__(self, argv: Optional[List[str]] = None, *, device=None):
        super().__init__(argv, device=device)
        self.service: Optional[KvService] = None

    def default_config(self) -> Config:
        return KvAppConfig()

    def build_services(self, server: RpcServer) -> None:
        peers_flag = self.flag("peers", "")
        if peers_flag:
            # replicated kvd group member (kv/replica.py):
            #   --node-id 1 --peers 1=h:p,2=h:p,3=h:p --data-dir /data/kvd1
            from tpu3fs_torch.kv.replica import (
                ReplicatedKvService,
                bind_replicated_kv,
            )

            peers = {}
            for part in peers_flag.split(","):
                nid, addr = part.strip().split("=", 1)
                host, port = addr.rsplit(":", 1)
                peers[int(nid)] = (host, int(port))
            self.service = ReplicatedKvService(
                int(self.flag("node_id", 0) or 0),
                peers,
                data_dir=self.flag("data_dir", "") or None,
                fsync=bool(int(self.flag("fsync", 0) or 0)),
            )
            bind_replicated_kv(server, self.service)
            return
        wal = self.flag("wal", "") or None
        self.service = KvService(
            wal_path=wal,
            snapshot_ttl_s=self.config.get("snapshot_ttl_s"),
            compact_min_bytes=int(
                self.flag("compact_min_bytes", 4 << 20) or (4 << 20)),
            fsync=bool(int(self.flag("fsync", 0) or 0)),
        )
        bind_kv_service(server, self.service)
        self.config.add_callback(
            lambda cfg: self.service.set_snapshot_ttl(
                cfg.get("snapshot_ttl_s")))

    def after_stop(self) -> None:
        if self.service is None:
            return
        if hasattr(self.service, "stop"):
            self.service.stop()       # replicated group member
        else:
            self.service.close()      # plain kvd


def main(argv: Optional[List[str]] = None) -> int:
    KvApp(argv if argv is not None else sys.argv[1:]).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
