"""meta service binary (ref src/meta/meta.cpp).

The port's own copy of ``tpu3fs/bin/meta_main.py``. ``MetaApp`` takes a
keyword ``device`` (else ``--device``, default ``cuda``): its file client,
which removes a collected file's chunks and reads a file's length, runs
its codec there. Not ported yet: the sharded store (``--meta-partitions``
and a published partition table; ``metashard/store.py``) and ``--kv``
(the network KV engines), both ROADMAP M6a-2b; each raises
``NotImplementedError``. Run it as ``python -m
tpu3fs_torch.bin.meta_main --node-id N --mgmtd HOST:PORT``.

Two-phase boot; serves the MetaSerde ops over a transactional KV engine.
File-length-on-close and truncate go through a storage client over the RPC
messenger (ref src/meta/components/FileHelper.cc queryLastChunk); a GC loop
drains the deferred-removal queue against storage (ref GcManager background
scans). The chain allocator follows the chain table published in routing.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from tpu3fs_torch.app.application import TwoPhaseApplication
from tpu3fs_torch.client.file_io import FileIoClient
from tpu3fs_torch.client.storage_client import StorageClient
from tpu3fs_torch.meta.store import ChainAllocator, MetaStore
from tpu3fs_torch.mgmtd.types import NodeType
from tpu3fs_torch.rpc.net import RpcServer
from tpu3fs_torch.rpc.services import RpcMessenger, bind_meta_service
from tpu3fs_torch.analytics.spans import TraceConfig
from tpu3fs_torch.monitor.flight import FlightConfig
from tpu3fs_torch.utils.config import Config, ConfigItem
from tpu3fs_torch.qos.core import QosConfig
from tpu3fs_torch.utils.fault_injection import FaultPlaneConfig
from tpu3fs_torch.tenant.quota import TenantConfig


_SHARDED_NOT_PORTED = (
    "the sharded metadata plane (metashard/store.py ShardedMetaStore, "
    "--meta-partitions) is not ported (ROADMAP M6a-2b); the port's meta "
    "server serves one unpartitioned MetaStore")


class MetaAppConfig(Config):
    # QoS admission limits for the meta RPC dispatch (tpu3fs/qos)
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
    chunk_size = ConfigItem(1 << 20)
    stripe = ConfigItem(1)
    gc_interval_s = ConfigItem(10.0, hot=True)
    chain_table_id = ConfigItem(1)
    # two-phase crash-resolver cadence (tpu3fs/metashard): each server
    # converges dangling rename/hardlink intents on its OWNED partitions
    resolve_interval_s = ConfigItem(2.0, hot=True)


class MetaApp(TwoPhaseApplication):
    node_type = NodeType.META

    def __init__(self, argv: Optional[List[str]] = None, *, engine=None,
                 device=None):
        super().__init__(argv, device=device)
        flag = self.flag("meta_partitions", "")
        if flag and int(flag) > 0:
            raise NotImplementedError(_SHARDED_NOT_PORTED)
        # --kv host:port points at the shared network KV service (the
        # FoundationDB role; tpu3fs/bin/kv_main.py) so multiple meta servers
        # share one namespace; without it this instance owns a private MemKV
        # (single-node/dev mode)
        self.engine = engine or self._make_engine()
        self.meta: Optional[MetaStore] = None
        self._fio: Optional[FileIoClient] = None

    def _make_engine(self):
        from tpu3fs_torch.kv.remote import engine_from_flag

        return engine_from_flag(self.flag("kv", ""))

    def default_config(self) -> Config:
        return MetaAppConfig()

    def _file_client(self) -> FileIoClient:
        if self._fio is None:
            messenger = RpcMessenger(lambda: self.mgmtd_client.routing())
            sc = StorageClient(
                f"meta-{self.info.node_id}",
                lambda: self.mgmtd_client.routing(),
                messenger,
                device=self.device,
            )
            self._fio = FileIoClient(sc)
        return self._fio

    def _cluster_space(self):
        si = self._file_client().storage.space_info()
        return si.capacity, si.used

    def build_services(self, server: RpcServer) -> None:
        routing = self.mgmtd_client.refresh_routing()
        table_id = self.config.get("chain_table_id")
        table = routing.chain_tables.get(table_id)
        chains = table.chain_ids if table else [1]
        hooks = dict(
            file_length_hook=lambda ino: self._file_client().file_length(ino),
            truncate_hook=lambda ino, ln: self._file_client().truncate_chunks(ino, ln),
            space_hook=self._cluster_space,
            default_chunk_size=self.config.get("chunk_size"),
            default_stripe=self.config.get("stripe"),
        )
        # a sharded fleet (a published partition table, or
        # --meta-partitions N) needs ShardedMetaStore: not ported yet
        flag = self.flag("meta_partitions", "")
        nparts = int(flag) if flag else len(routing.meta_partitions)
        if nparts > 0:
            raise NotImplementedError(_SHARDED_NOT_PORTED)
        self.meta = MetaStore(
            self.engine, ChainAllocator(table_id, chains), **hooks)
        # --auth 1: enforce bearer-token authentication via the UserStore
        # in the shared KV (ref src/core/user; tokens resolved server-side)
        user_store = None
        if self.flag("auth", "") in ("1", "true", "yes"):
            from tpu3fs_torch.core.user import UserStore

            user_store = UserStore(self.engine)
        bind_meta_service(server, self.meta, user_store=user_store,
                          tenant_mode=self.flag("tenant_mode", "enforce"))

    def before_start(self) -> None:
        self.spawn(self._gc_loop, "meta-gc")

    def after_stop(self) -> None:
        # the file client's fan-out pool holds worker threads
        if self._fio is not None:
            self._fio.close()
            self._fio.storage.close()

    def run_gc(self) -> int:
        from tpu3fs_torch.qos.core import TrafficClass, tagged

        removed = 0
        fio = self._file_client()
        # chunk removals are GC-class traffic: the storage-side QoS
        # scheduler keeps them behind foreground IO (tpu3fs/qos)
        with tagged(TrafficClass.GC):
            for inode in self.meta.gc_scan():
                if self.meta.has_sessions(inode.id):
                    continue
                fio.remove_chunks(inode)
                self.meta.gc_finish(inode.id)
                removed += 1
        return removed

    def _gc_loop(self) -> None:
        while not self._stop.wait(self.config.get("gc_interval_s")):
            try:
                self.run_gc()
            except Exception:
                pass


def main(argv: Optional[List[str]] = None) -> int:
    MetaApp(argv if argv is not None else sys.argv[1:]).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
