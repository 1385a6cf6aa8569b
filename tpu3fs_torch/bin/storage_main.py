"""storage service binary (ref src/storage/storage.cpp:5-8 —
TwoPhaseApplication<StorageServer>).

The port's own copy of ``tpu3fs/bin/storage_main.py``. ``StorageApp``
takes a keyword ``device`` (else ``--device``, default ``cuda``): its
``StorageService``, every target it opens and its rebuild workers run
there, so each EC rebuild's decode (K1, K3) is a kernel launch on the
card, and so is each chunk install's checksum (K2) on a mem target. The
engine is the JAX package's default, ``auto``: the C++ chunk engine on
disk (``storage/native_engine``, its CRCs computed on the host) under
``data_dir`` when its library builds, else the mem engine with a WARN;
``native`` and ``mem`` pick one outright. With ``--rpc native`` every
target scan also syncs the C++ transport's read and write fast paths
(``storage/native_fastpath``). What differs from the JAX package:

- a stop also joins the per-target update workers and closes the shm
  rings its own messengers opened to peer nodes.

``usrbio`` (default 1, as in the JAX package) hosts the USRBIO rings:
co-located clients register shm rings through the Usrbio control
service and their data-plane RPCs ride them; 0 serves sockets only.

Run it as ``python -m tpu3fs_torch.bin.storage_main --node-id N --mgmtd
HOST:PORT``.

Two-phase boot: launcher fetches the STORAGE config template from mgmtd and
registers the node; beforeStart opens every target assigned to this node in
routing (ref StorageTargets.create opening every target at
StorageServer::beforeStart) and keeps discovering new assignments on routing
refresh. Heartbeats carry per-target local states up; a resync loop pushes
recovery transfers when this node heads a chain with a syncing successor
(ref src/storage/sync/ResyncWorker).
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

from tpu3fs_torch.analytics.spans import TraceConfig
from tpu3fs_torch.monitor.flight import FlightConfig
from tpu3fs_torch.app.application import TwoPhaseApplication
from tpu3fs_torch.mgmtd.types import LocalTargetState, NodeType
from tpu3fs_torch.qos.core import QosConfig
from tpu3fs_torch.utils.fault_injection import FaultPlaneConfig
from tpu3fs_torch.tenant.quota import TenantConfig
from tpu3fs_torch.rpc.net import RpcServer
from tpu3fs_torch.rpc.services import RpcMessenger, bind_storage_service
from tpu3fs_torch.storage.craq import StorageService
from tpu3fs_torch.storage.ec_resync import EcResyncWorker
from tpu3fs_torch.storage.resync import ResyncWorker
from tpu3fs_torch.storage.target import StorageTarget
from tpu3fs_torch.storage.workers import (
    AllocateWorker,
    CheckWorker,
    DumpWorker,
    PunchHoleWorker,
)
from tpu3fs_torch.utils.config import Config, ConfigItem
from tpu3fs_torch.utils.logging import xlog


class StorageAppConfig(Config):
    # "auto" = the native C++ engine when its .so builds (the flagship
    # serving configuration), mem otherwise; explicit "native" refuses to
    # start without the library
    engine = ConfigItem("auto")         # auto | mem | native
    data_dir = ConfigItem("")           # required for engine=native/auto
    chunk_size = ConfigItem(1 << 20)
    resync_interval_s = ConfigItem(5.0, hot=True)
    target_scan_interval_s = ConfigItem(5.0, hot=True)
    # maintenance workers (ref src/storage/worker/)
    check_interval_s = ConfigItem(3.0, hot=True)
    punch_hole_interval_s = ConfigItem(10.0, hot=True)
    dump_interval_s = ConfigItem(0.0, hot=True)   # 0 = disabled
    dump_dir = ConfigItem("")                     # default <data_dir>/dumps
    reject_create_threshold = ConfigItem(0.98, hot=True)
    emergency_recycling_ratio = ConfigItem(0.95, hot=True)
    trace_dir = ConfigItem("")  # write-path structured trace; "" = off
    # QoS: per-class admission/scheduling limits (tpu3fs/qos) — every
    # item hot-updates via mgmtd config push without restart
    qos = QosConfig
    # cluster fault plane (utils/fault_injection.py): hot-pushed
    # fault rules for chaos drives / gray-failure testing
    faults = FaultPlaneConfig
    # multi-tenant quota table (tpu3fs/tenant): per-tenant
    # WFQ weights + token-bucket limits, hot-pushed via mgmtd
    tenants = TenantConfig
    # distributed request tracing (tpu3fs/analytics/spans.py) + monitor
    # sample push to monitor_collector — both hot-configured
    trace = TraceConfig
    # flight recorder (monitor/flight.py): bounded in-process black box
    # dumped on SLO breach / fatal signal / admin_cli flight-dump
    flight = FlightConfig
    collector = ConfigItem("", hot=True)          # host:port; "" = off
    monitor_push_period_s = ConfigItem(5.0, hot=True)
    # USRBIO shared-memory data plane (tpu3fs_torch/usrbio): co-located
    # clients register shm rings through the Usrbio control service and
    # the data path rides them instead of sockets. 0 disables hosting.
    usrbio = ConfigItem(1)
    usrbio_reap_interval_s = ConfigItem(60.0, hot=True)
    usrbio_iov_max_age_s = ConfigItem(3600.0, hot=True)
    # elasticity: close + trash-route local targets whose routing
    # assignment was taken away by a migration cutover (docs/placement.md)
    retire_targets = ConfigItem(1, hot=True)


class StorageApp(TwoPhaseApplication):
    node_type = NodeType.STORAGE

    def __init__(self, argv: Optional[List[str]] = None, *, device=None):
        super().__init__(argv, device=device)
        self.service: Optional[StorageService] = None
        self._trace = None
        self._usrbio_host = None
        self._messengers: List[RpcMessenger] = []

    def default_config(self) -> Config:
        return StorageAppConfig()

    def _qos_exempt_services(self) -> set:
        # storage methods are admission-checked inside StorageService via
        # the shared controller (read gates, write entry, WFQ shedding) —
        # RPC-level charging on top would double-count each op
        from tpu3fs_torch.rpc.services import STORAGE_SERVICE_ID

        return {STORAGE_SERVICE_ID}

    def build_services(self, server: RpcServer) -> None:
        messenger = self._messenger()
        self.service = StorageService(
            self.info.node_id, lambda: self.mgmtd_client.routing(), messenger,
            device=self.device,
        )
        from tpu3fs_torch.qos.manager import QosManager

        self.service.set_qos(QosManager(
            self.config.qos, tags={"node": str(self.info.node_id)},
            admission=self.admission))
        trace_dir = self.config.get("trace_dir")
        if trace_dir:
            from tpu3fs_torch.analytics.trace import StructuredTraceLog

            self._trace = StructuredTraceLog("storage-event", trace_dir)
            self.service.set_trace_log(self._trace)
        bind_storage_service(server, self.service)
        # USRBIO shm data plane: co-located clients register rings via
        # the control service; their RPCs then dispatch through the SAME
        # admission entry as socket frames (usrbio/server.py)
        if self.config.get("usrbio"):
            from tpu3fs_torch.usrbio.server import (
                UsrbioRpcHost,
                bind_usrbio_service,
            )

            self._usrbio_host = UsrbioRpcHost(server)
            bind_usrbio_service(server, self._usrbio_host)

    def _messenger(self) -> RpcMessenger:
        """A messenger to the other storage nodes; its rings are closed
        at stop."""
        messenger = RpcMessenger(lambda: self.mgmtd_client.routing())
        self._messengers.append(messenger)
        return messenger

    def after_stop(self) -> None:
        if self._usrbio_host is not None:
            self._usrbio_host.stop()
        if self.service is not None:
            self.service.stop_workers()
        for messenger in self._messengers:
            messenger.close_rings()
        if self._trace is not None:
            # the writer buffers flush_rows rows; a restart must not lose
            # the tail of the trace
            self._trace.flush()

    # -- target discovery ---------------------------------------------------
    def _target_path(self, target_id: int, disk_index: int) -> Optional[str]:
        base = self.config.get("data_dir")
        if not base:
            return None
        path = os.path.join(base, f"disk{disk_index}", f"target{target_id}")
        os.makedirs(path, exist_ok=True)
        return path

    def retire_targets(self, routing) -> int:
        """Close + trash-route local targets routing no longer assigns
        here (a migration cutover detached them: chain_id 0, or the
        membership moved to another node). The DATA is not destroyed —
        a disk-backed target directory is renamed into
        ``<data_dir>/trash/`` with a timestamp so an operator can still
        recover from a mistaken plan; mem engines just release."""
        import time as _time

        retired = 0
        for target in self.service.targets():
            info = routing.targets.get(target.target_id)
            if info is None:
                continue  # unknown to routing: never reap on ignorance
            if info.chain_id and info.node_id == self.info.node_id:
                continue
            dropped = self.service.drop_target(target.target_id)
            if dropped is None:
                continue
            try:
                dropped.engine.close()
            except Exception:
                pass
            path = self._target_path(target.target_id, info.disk_index) \
                if self.config.get("data_dir") else None
            if path and os.path.isdir(path):
                trash = os.path.join(self.config.get("data_dir"), "trash")
                os.makedirs(trash, exist_ok=True)
                dst = os.path.join(
                    trash, f"target{target.target_id}-{int(_time.time())}")
                try:
                    os.rename(path, dst)
                except OSError:
                    pass
            retired += 1
            xlog("INFO", "node %d retired target %d (trash-routed)",
                 self.info.node_id, target.target_id)
        if retired:
            from tpu3fs_torch.migration.service import record_retired_target

            record_retired_target(retired)
        return retired

    def scan_targets(self) -> int:
        """Open targets routing assigns to this node (ref StorageTargets
        create/load at startup + admin create-target afterwards); retire
        the ones routing took away (migration cutover)."""
        routing = self.mgmtd_client.refresh_routing()
        if self.config.get("retire_targets"):
            self.retire_targets(routing)
        added = 0
        for info in routing.targets.values():
            if info.node_id != self.info.node_id:
                continue
            if self.service.target(info.target_id) is not None:
                continue
            if not info.chain_id:
                continue  # not part of a chain yet
            target = StorageTarget(
                info.target_id,
                info.chain_id,
                engine=self.config.get("engine"),
                path=self._target_path(info.target_id, info.disk_index),
                chunk_size=self.config.get("chunk_size"),
                device=self.device,
            )
            # a target opened on a fresh/possibly stale disk is not
            # automatically up to date: if its chain already bumped past v1,
            # report ONLINE and let the resync protocol promote it
            chain = routing.chains.get(info.chain_id)
            if chain is not None and chain.chain_version > 1:
                target.local_state = LocalTargetState.ONLINE
            self.service.add_target(target)
            added += 1
            xlog("INFO", "node %d opened target %d (chain %d, %s, %s)",
                 self.info.node_id, info.target_id, info.chain_id,
                 type(target.engine).__name__, self.device)
        # refresh the native read fast path every scan (no-op on the
        # python transport): registry entries track target/routing state
        # with at most one scan interval of lag
        try:
            from tpu3fs_torch.storage.native_fastpath import (
                sync_read_fastpath)

            sync_read_fastpath(self.server, self.service)
        except Exception:
            pass
        return added

    def local_target_states(self) -> Dict[int, LocalTargetState]:
        return {t.target_id: t.local_state for t in self.service.targets()}

    def before_start(self) -> None:
        self.scan_targets()
        self.spawn(self._target_scan_loop, "target-scan")
        self.spawn(self._resync_loop, "resync")
        self.spawn(self._check_loop, "check-disk")
        self.spawn(self._punch_hole_loop, "punch-hole")
        # always spawned so dump_interval_s can be hot-enabled from 0
        self.spawn(self._dump_loop, "dump-chunkmeta")
        if self._usrbio_host is not None:
            self.spawn(self._usrbio_reap_loop, "usrbio-reap")

    def _usrbio_reap_loop(self) -> None:
        while not self._stop.wait(
                self.config.get("usrbio_reap_interval_s")):
            try:
                self._usrbio_host.reap_pass(
                    iov_max_age_s=self.config.get("usrbio_iov_max_age_s"))
            except Exception:
                pass

    def _target_scan_loop(self) -> None:
        while not self._stop.wait(self.config.get("target_scan_interval_s")):
            try:
                if self.scan_targets():
                    self.heartbeat_once()
            except Exception:
                pass

    def _resync_loop(self) -> None:
        worker = None
        ec_worker = None
        while not self._stop.wait(self.config.get("resync_interval_s")):
            try:
                if worker is None:
                    messenger = self._messenger()
                    worker = ResyncWorker(self.service, messenger)
                    # EC chains rebuild + heal (healthy-chain roll-forward
                    # of interrupted two-phase commits) on the same cadence
                    ec_worker = EcResyncWorker(self.service, messenger,
                                               device=self.device)
                worker.run_once()
                ec_worker.run_once()
            except Exception:
                pass

    def _check_loop(self) -> None:
        worker = CheckWorker(
            self.service,
            reject_create_threshold=self.config.get("reject_create_threshold"),
            emergency_recycling_ratio=self.config.get(
                "emergency_recycling_ratio"),
            # a freshly offlined disk must reach mgmtd now, not at the next
            # periodic heartbeat (ref CheckWorker triggerHeartbeat)
            on_offline=lambda t: self.heartbeat_once(),
        )
        allocator = AllocateWorker(self.service)
        while not self._stop.wait(self.config.get("check_interval_s")):
            try:
                worker.reject_create_threshold = self.config.get(
                    "reject_create_threshold")
                worker.emergency_recycling_ratio = self.config.get(
                    "emergency_recycling_ratio")
                worker.run_once()
                allocator.run_once()
            except Exception:
                pass

    def _punch_hole_loop(self) -> None:
        worker = PunchHoleWorker(self.service)
        while not self._stop.wait(self.config.get("punch_hole_interval_s")):
            try:
                worker.run_once()
            except Exception:
                pass

    def _dump_loop(self) -> None:
        dump_dir = self.config.get("dump_dir") or os.path.join(
            self.config.get("data_dir") or ".", "dumps")
        worker = DumpWorker(self.service, dump_dir, self.info.node_id)
        while True:
            interval = self.config.get("dump_interval_s")
            # 0 = disabled: poll for a hot re-enable without busy-looping
            if self._stop.wait(interval if interval > 0 else 1.0):
                return
            if interval <= 0:
                continue
            try:
                worker.run_once()
            except Exception:
                pass


def main(argv: Optional[List[str]] = None) -> int:
    StorageApp(argv if argv is not None else sys.argv[1:]).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
