"""serving service binary: one fleet KVCache serving process.

A serving node is an inference host's cache-side process: it owns a
``FleetKVCache`` (host tier over the kvcache store, miss path =
single-flight -> peer fill -> claimed storage fill, tpu3fs/serving/) and
exposes the Serving RPC table (peerRead/fillClaim/fillRelease/
servingStats/servingLoad) so OTHER serving nodes can fill their misses
from this node's host tier — the fleet serves itself before touching
storage (docs/serving.md).

Two-phase boot like every service binary: launcher fetches the CLIENT
config template from mgmtd and registers the node; beforeStart registers
this node's serving endpoint in the mgmtd serving directory (a TTL
lease, renewed at ttl/3 like a heartbeat) so peers discover it through
RoutingInfo.serving exactly like chain tables. Co-located peers ride
USRBIO shm rings (the binary hosts the Usrbio control service; peerRead
is ring-dispatchable, usrbio/transport.py RING_METHODS).

    python -m tpu3fs_torch.bin.serving_main --node-id 61 --mgmtd HOST:PORT \
        --device cuda [--port 0] [--straggle-ms 0] [--tenant t0] \
        [--config.root=/kvcache] [--config.capacity_bytes=N]

The port's own copy of ``tpu3fs/bin/serving_main.py``. ``ServingApp`` takes
a keyword ``device`` (else ``--device``, default ``cuda``) and hands it to
its ``StorageClient``: the file client's stripe encode, CRCs and degraded
decodes of a write-through put or a storage fill run there. The USRBIO
shm rings (the binary's own ring server, ``usrbio``, and rings to peers,
``peer_usrbio``) default to 1, as in the JAX package; 0 turns each off.
"""

from __future__ import annotations

import sys
import time
import uuid
from typing import List, Optional

from tpu3fs_torch.analytics.spans import TraceConfig
from tpu3fs_torch.app.application import TwoPhaseApplication
from tpu3fs_torch.mgmtd.types import NodeType
from tpu3fs_torch.monitor.flight import FlightConfig
from tpu3fs_torch.qos.core import QosConfig
from tpu3fs_torch.rpc.net import RpcClient, RpcServer
from tpu3fs_torch.rpc.services import MetaRpcClient, RpcMessenger
from tpu3fs_torch.tenant.quota import TenantConfig
from tpu3fs_torch.utils.config import Config, ConfigItem
from tpu3fs_torch.utils.fault_injection import FaultPlaneConfig
from tpu3fs_torch.utils.logging import xlog
from tpu3fs_torch.utils.result import FsError


class ServingAppConfig(Config):
    root = ConfigItem("/kvcache")        # kvcache store root
    # host tier (TieredKVCache): the RAM this process serves from
    capacity_bytes = ConfigItem(256 << 20)
    dirty_max_bytes = ConfigItem(64 << 20)
    write_through = ConfigItem(1)        # serving fills must be peer-readable
    # cached-inode fast path: REQUIRED for serve-through (peek miss ->
    # get_cached with zero meta round trips); entries, not bytes
    inode_cache = ConfigItem(4096)
    touch_coalesce_s = ConfigItem(30.0, hot=True)
    # fleet fill ladder (serving/fleet.py)
    claim_ttl_ms = ConfigItem(2000, hot=True)
    claim_poll_ms = ConfigItem(20.0, hot=True)
    claim_polls = ConfigItem(3, hot=True)
    singleflight_timeout_s = ConfigItem(30.0, hot=True)
    peer_est_bytes = ConfigItem(1 << 20)
    # peer transport: prefer shm rings to co-located peers
    peer_usrbio = ConfigItem(1)
    peer_ring_entries = ConfigItem(64)
    peer_iov_bytes = ConfigItem(8 << 20)
    # serving-directory lease (mgmtd _prune_serving expires silent nodes)
    serving_ttl_s = ConfigItem(30.0, hot=True)
    # QoS / tenants / faults / tracing / flight: the standard config
    # plane every service binary carries (hot via mgmtd config push)
    qos = QosConfig
    tenants = TenantConfig
    faults = FaultPlaneConfig
    trace = TraceConfig
    flight = FlightConfig
    collector = ConfigItem("", hot=True)
    monitor_push_period_s = ConfigItem(5.0, hot=True)
    # USRBIO hosting (this binary's OWN ring server, for peers' rings)
    usrbio = ConfigItem(1)
    usrbio_reap_interval_s = ConfigItem(60.0, hot=True)
    usrbio_iov_max_age_s = ConfigItem(3600.0, hot=True)


class ServingApp(TwoPhaseApplication):
    node_type = NodeType.CLIENT

    def __init__(self, argv: Optional[List[str]] = None, *, device=None):
        super().__init__(argv, device=device)
        self._usrbio_host = None
        self._messenger = None
        self.fleet = None
        self.host = None
        self._fio = None

    def default_config(self) -> Config:
        return ServingAppConfig()

    # -- wiring --------------------------------------------------------------
    def _meta_addrs(self):
        """META node addresses from routing; the cluster may still be
        assembling, so wait for at least one (the launcher retried its
        config fetch the same way)."""
        deadline = time.time() + float(self.flag("launcher_timeout", "30"))
        while True:
            routing = self.mgmtd_client.refresh_routing()
            addrs = [(n.host, n.port) for n in routing.nodes.values()
                     if n.type == NodeType.META and n.host]
            if addrs:
                return addrs
            if time.time() >= deadline:
                raise SystemExit(
                    "serving_main: no META nodes in routing "
                    "(is the cluster up?)")
            time.sleep(0.5)

    def _meta_client(self, addrs) -> MetaRpcClient:
        """The meta client, routed by mgmtd's partition table when the
        metadata plane is sharded: a batched put's creates then go to
        each partition's owner. (The JAX package's serving_main builds an
        unrouted client, whose batched creates on a sharded plane come
        back META_WRONG_PARTITION from the servers that do not own them.)"""
        kw = {}
        nparts = len(self.mgmtd_client.routing().meta_partitions)
        if nparts:
            kw = dict(mgmtd=self.mgmtd_client, nparts=nparts)
        return MetaRpcClient(addrs, client_id=f"serving-{self.info.node_id}",
                             token=self.flag("token"), **kw)

    def build_services(self, server: RpcServer) -> None:
        from tpu3fs_torch.client.file_io import FileIoClient
        from tpu3fs_torch.client.storage_client import StorageClient
        from tpu3fs_torch.kvcache.cache import KVCacheClient
        from tpu3fs_torch.serving.fleet import FleetKVCache
        from tpu3fs_torch.serving.service import (
            ServingHost,
            ServingPeerClient,
            bind_serving_service,
        )

        node_id = self.info.node_id
        routing = self.mgmtd_client.refresh_routing
        messenger = self._messenger = RpcMessenger(
            lambda: self.mgmtd_client.routing())
        meta = self._meta_client(self._meta_addrs())
        # storage clients need UNIQUE wire ids (cli.py RpcFabricView: the
        # exactly-once channel table is keyed by client id)
        storage = StorageClient(
            f"serving-{node_id}-{uuid.uuid4().hex[:8]}", routing, messenger,
            device=self.device)
        self._fio = FileIoClient(storage)
        kv = KVCacheClient(
            meta, self._fio,
            root=self.config.get("root"),
            client_id=f"serving-{node_id}",
            inode_cache=int(self.config.get("inode_cache")),
            touch_coalesce_s=float(self.config.get("touch_coalesce_s")),
            tenant=self.flag("tenant"),
        )
        peers = ServingPeerClient(
            RpcClient(),
            usrbio=bool(self.config.get("peer_usrbio")),
            entries=int(self.config.get("peer_ring_entries")),
            iov_bytes=int(self.config.get("peer_iov_bytes")),
        )
        # the directory reads routing on EVERY pick: hand it the cached
        # snapshot (kept fresh by the app's routing-poll loop), not the
        # per-call mgmtd RPC — membership is eventually consistent anyway
        self.fleet = FleetKVCache(
            kv, node_id=node_id, routing=self.mgmtd_client.routing,
            peer_client=peers,
            claim_ttl_ms=int(self.config.get("claim_ttl_ms")),
            claim_poll_ms=float(self.config.get("claim_poll_ms")),
            claim_polls=int(self.config.get("claim_polls")),
            singleflight_timeout_s=float(
                self.config.get("singleflight_timeout_s")),
            peer_est_bytes=int(self.config.get("peer_est_bytes")),
            capacity_bytes=int(self.config.get("capacity_bytes")),
            dirty_max_bytes=int(self.config.get("dirty_max_bytes")),
            write_through=bool(self.config.get("write_through")),
        )
        # ONE claim table per process: the host answers remote fillClaim
        # against the same table the local fill ladder claims from
        self.host = ServingHost(
            self.fleet, node_id, claims=self.fleet.claims,
            straggle_ms=float(self.flag("straggle_ms", "0") or 0),
        )
        bind_serving_service(server, self.host)
        if self.config.get("usrbio"):
            from tpu3fs_torch.usrbio.server import (
                UsrbioRpcHost,
                bind_usrbio_service,
            )

            self._usrbio_host = UsrbioRpcHost(server)
            bind_usrbio_service(server, self._usrbio_host)

    # -- serving-directory lease ---------------------------------------------
    def _serving_register_once(self) -> bool:
        try:
            self.mgmtd_client.serving_register(
                self.info.node_id, self.info.hostname, self.info.port,
                ttl_s=float(self.config.get("serving_ttl_s")))
            return True
        except FsError as e:
            xlog("WARN", "serving %d register failed: %r",
                 self.info.node_id, e)
            return False

    def _serving_renew_loop(self) -> None:
        # renew at ttl/3 so two missed renewals still beat expiry
        while not self._stop.wait(
                max(1.0, float(self.config.get("serving_ttl_s")) / 3.0)):
            self._serving_register_once()

    def before_start(self) -> None:
        self.spawn(self._serving_renew_loop, "serving-renew")
        if self._usrbio_host is not None:
            self.spawn(self._usrbio_reap_loop, "usrbio-reap")

    def start_server(self) -> None:
        """Listen, then enter the serving directory: a peer that reads the
        entry must find the server accepting (the JAX package registers
        in ``before_start``, before the server listens, and a peer quick
        enough is refused)."""
        super().start_server()
        self._serving_register_once()

    def _usrbio_reap_loop(self) -> None:
        while not self._stop.wait(
                self.config.get("usrbio_reap_interval_s")):
            try:
                self._usrbio_host.reap_pass(
                    iov_max_age_s=self.config.get("usrbio_iov_max_age_s"))
            except Exception:
                pass

    def after_stop(self) -> None:
        try:
            self.mgmtd_client.serving_unregister(self.info.node_id)
        except Exception:
            pass  # TTL expiry prunes the directory entry
        if self._usrbio_host is not None:
            self._usrbio_host.stop()
        if self.fleet is not None:
            try:
                self.fleet.close()
            except Exception as e:
                xlog("WARN", "serving %d close: %r", self.info.node_id, e)
        if self._fio is not None:
            # the file client's fan-out pool holds worker threads
            self._fio.close()
            self._fio.storage.close()
        if self._messenger is not None:
            self._messenger.close_rings()


def main(argv: Optional[List[str]] = None) -> int:
    ServingApp(argv if argv is not None else sys.argv[1:]).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
