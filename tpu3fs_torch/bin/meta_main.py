"""meta service binary (ref src/meta/meta.cpp).

The port's own copy of ``tpu3fs/bin/meta_main.py``. ``MetaApp`` takes a
keyword ``device`` (else ``--device``, default ``cuda``): its file client,
which removes a collected file's chunks and reads a file's length, runs
its codec there. ``--kv`` names the shared network KV (a kvd, or a kvd
group as ``id=h:p,...`` by the members' node ids), and ``--meta-partitions N`` serves the
sharded store (``metashard/store.py``). Run it as ``python -m
tpu3fs_torch.bin.meta_main --node-id N --mgmtd HOST:PORT [--kv ...]
[--meta-partitions N]``.

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
        # --kv host:port points at the shared network KV service (the
        # FoundationDB role; tpu3fs/bin/kv_main.py) so multiple meta servers
        # share one namespace; without it this instance owns a private MemKV
        # (single-node/dev mode)
        self.engine = engine or self._make_engine()
        self.meta: Optional[MetaStore] = None
        self._fio: Optional[FileIoClient] = None
        self._peer_rpc = None
        self._nparts = 0

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

    def _owned_partitions(self):
        """The set of partition ids assigned to THIS node by mgmtd, or
        None while the table is unpublished (own everything — single-node
        boot before the assigner's first tick)."""
        try:
            ri = self.mgmtd_client.routing()
        except Exception:
            return None
        if not ri.meta_partitions:
            return None
        return {pid for pid, row in ri.meta_partitions.items()
                if row.node_id == self.info.node_id}

    def _peer_client(self):
        """MetaRpcClient over the cluster's META nodes, routed by the
        partition table — carries two-phase participant RPCs
        (renamePrepare/renameFinish) to peer owners."""
        from tpu3fs_torch.rpc.net import RpcClient
        from tpu3fs_torch.rpc.services import MetaRpcClient

        ri = self.mgmtd_client.routing()
        addrs = [(n.host, n.port) for n in ri.nodes.values()
                 if n.type == NodeType.META and n.host]
        if self._peer_rpc is None:
            self._peer_rpc = RpcClient()
        return MetaRpcClient(
            addrs or [(self.info.hostname, self.info.port)],
            self._peer_rpc, client_id=f"meta-{self.info.node_id}",
            token=self.flag("token", ""), mgmtd=self.mgmtd_client,
            nparts=self._nparts)

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
        # --meta-partitions N: serve the sharded store (metashard/).
        # Unset = the published table's width when mgmtd has one (a sharded
        # fleet restart), else the legacy single-partition MetaStore —
        # sharding is opt-in, so multi-meta deployments without the flag
        # keep the any-op-anywhere shape. 0 = legacy explicitly.
        flag = self.flag("meta_partitions", "")
        self._peer_rpc = None
        nparts = int(flag) if flag else len(routing.meta_partitions)
        if nparts <= 0:
            self.meta = MetaStore(
                self.engine, ChainAllocator(table_id, chains), **hooks)
        else:
            from tpu3fs_torch.metashard import ShardedMetaStore

            self._nparts = nparts

            def peer_prepare(pid, intent, dst_path):
                owned = self._owned_partitions()
                if owned is None or pid in owned:
                    # participant partition is local: apply in-process
                    from tpu3fs_torch.meta.store import ROOT_USER

                    self.meta.twophase_prepare(intent, dst_path, ROOT_USER)
                else:
                    self._peer_client().rename_prepare(pid, intent, dst_path)

            def peer_finish(pid, txn_id):
                owned = self._owned_partitions()
                if owned is None or pid in owned:
                    self.meta.twophase_finish(txn_id)
                else:
                    self._peer_client().rename_finish(pid, txn_id)

            self.meta = ShardedMetaStore(
                self.engine, ChainAllocator(table_id, chains),
                nparts=self._nparts, owner_view=self._owned_partitions,
                peer_prepare=peer_prepare, peer_finish=peer_finish,
                **hooks)
        # --auth 1: enforce bearer-token authentication via the UserStore
        # in the shared KV (ref src/core/user; tokens resolved server-side)
        user_store = None
        if self.flag("auth", "") in ("1", "true", "yes"):
            from tpu3fs_torch.core.user import UserStore

            user_store = UserStore(self.engine)
        bind_meta_service(server, self.meta, user_store=user_store,
                          tenant_mode=self.flag("tenant_mode", "enforce"))

    def meta_partition_loads(self):
        snap = getattr(self.meta, "snapshot_loads", None)
        if snap is None:
            return {}
        return {pid: float(n) for pid, n in snap().items()}

    def before_start(self) -> None:
        self.spawn(self._gc_loop, "meta-gc")
        if hasattr(self.meta, "resolve_intents"):
            self.spawn(self._resolver_loop, "meta-twophase-resolver")

    def _resolver_loop(self) -> None:
        """Converge dangling two-phase intents on OWNED partitions — a
        reassigned partition's new owner rolls a dead coordinator's
        in-flight renames forward/back (docs/metashard.md crash matrix)."""
        while not self._stop.wait(self.config.get("resolve_interval_s")):
            try:
                self.meta.resolve_intents(pids=self._owned_partitions())
            except Exception:
                pass

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
