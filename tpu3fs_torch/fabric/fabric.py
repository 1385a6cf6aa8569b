"""Single-process multi-node cluster for tests and benches.

Clone of the reference's test::UnitTestFabric (tests/lib/UnitTestFabric.h:169):
boots a real Mgmtd, N real StorageService nodes, the MetaStore and real
clients in one process, parameterized like SystemSetupConfig
(UnitTestFabric.h:86-135 — chunk size, num_chains/num_replicas/
num_storage_nodes). Node "RPC" is direct dispatch through a messenger that
honors kill/restart, so fail-stop and recovery paths run exactly as they
would over sockets (the RPC layer drops in the same messenger signature).

A controllable clock drives heartbeat timeouts deterministically.

The port's own copy of ``tpu3fs/fabric/fabric.py``. ``Fabric(cfg, device)``
resolves its device once (the card unless the caller asks for the CPU) and
hands it to every storage service, target, client and EC rebuild worker it
builds, so the stripe codec and every chunk checksum run there. The ICI
chain transport and the mesh rebuild run on a ``LocalMesh``
(``parallel.make_storage_mesh(..., devices=...)``): one process driving a
grid of devices, as this fabric is one process hosting every node. A
process-group ``DeviceMesh`` raises: its collectives need one process a
rank.
"""

from __future__ import annotations

import itertools
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Optional

from tpu3fs_torch.client.file_io import FileIoClient
from tpu3fs_torch.client.storage_client import StorageClient
from tpu3fs_torch.device import resolve_device
from tpu3fs_torch.kv import MemKVEngine
from tpu3fs_torch.parallel.mesh import require_local_mesh
from tpu3fs_torch.meta.store import ChainAllocator, MetaStore
from tpu3fs_torch.mgmtd.service import Mgmtd, MgmtdConfig
from tpu3fs_torch.mgmtd.types import LocalTargetState, NodeType, PublicTargetState
from tpu3fs_torch.storage.craq import StorageService
from tpu3fs_torch.storage.resync import ResyncWorker
from tpu3fs_torch.storage.target import StorageTarget
from tpu3fs_torch.utils.result import Code, FsError, Status


def _freeze_routing(live):
    """Shallow-freeze a RoutingInfo: copy the container dicts (and the
    version) so later chain/target/node INSTALLS are invisible, while
    still sharing the current member objects. mgmtd replaces chain and
    target records wholesale on every mutation (mgmtd/service.py uses
    dataclasses.replace before installing), so sharing is safe."""
    from dataclasses import replace as _replace

    return _replace(
        live,
        nodes=dict(live.nodes),
        chain_tables=dict(live.chain_tables),
        chains=dict(live.chains),
        targets=dict(live.targets),
        serving=dict(live.serving),
        meta_partitions=dict(live.meta_partitions),
    )


class FabricClock:
    def __init__(self, t: float = 10_000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@dataclass
class SystemSetupConfig:
    num_storage_nodes: int = 3
    num_chains: int = 2
    num_replicas: int = 2
    chunk_size: int = 1 << 16
    engine: str = "mem"
    # base directory for disk-backed engines (None = system tempdir);
    # benches point this at /dev/shm so the numbers measure the framework,
    # not the host disk's writeback throttle
    engine_dir: Optional[str] = None
    heartbeat_timeout_s: float = 60.0
    # EC(k, m) chain tables instead of CR replication: each chain gets
    # k+m targets (on distinct nodes when possible) holding one stripe
    # shard each; num_replicas is ignored for EC chains
    ec_k: int = 0
    ec_m: int = 0
    # "ici" + a mesh: CR chains replicate staged batches via the
    # chain_write_step collective (storage/ici_chain.py) instead of the
    # per-hop messenger — the intra-pod serving mode. Requires every
    # chain's targets on one node (pass num_storage_nodes=1) and the
    # mesh's ``chain`` axis equal to num_replicas. The mesh is a
    # LocalMesh; a process-group DeviceMesh raises (ROADMAP M8).
    chain_transport: str = "messenger"
    mesh: object = None
    # a qos.QosConfig: every storage node gets a QosManager over it
    # (admission + weighted-fair update scheduling + shed recorders);
    # None = legacy unscheduled behavior
    qos: object = None
    # arm the mgmtd lease fence on every storage service (docs/scale.md):
    # T/2 of mgmtd silence closes the node's client-write ack path and
    # demotes its targets to ONLINE. Off by default — most unit tests
    # drive heartbeats explicitly and predate the fencing contract.
    fencing: bool = False


class _Node:
    def __init__(self, node_id: int, service: StorageService):
        self.node_id = node_id
        self.service = service
        self.alive = True
        self.hb_version = 0
        # routing snapshot frozen at partition start: a node cut off from
        # mgmtd must keep acting on the LAST routing it saw (the live
        # RoutingInfo is a shared in-process object — without freezing,
        # a partitioned head would instantly "learn" about its own
        # replacement, which no real partitioned process could)
        self.frozen_routing = None


class Fabric:
    MGMTD_NODE_ID = 1
    # direct-dispatch marker: chain forwards through `send` stay inside
    # this process, so CRAQ hands successors its owned staged buffers +
    # checksums (trusted forward) instead of re-shipping/re-verifying
    in_process = True
    FIRST_STORAGE_NODE_ID = 10
    FIRST_TARGET_ID = 1000
    FIRST_CHAIN_ID = 900_000

    def __init__(self, cfg: Optional[SystemSetupConfig] = None, device=None):
        self.cfg = cfg or SystemSetupConfig()
        require_local_mesh(self.cfg.mesh, "the ICI chain transport", "M8")
        if self.cfg.chain_transport == "ici" and self.cfg.mesh is None:
            raise ValueError("the ici chain transport needs a mesh")
        self.device = resolve_device(device)
        self.clock = FabricClock()
        self.kv = MemKVEngine()
        self.mgmtd = Mgmtd(
            self.MGMTD_NODE_ID,
            self.kv,
            MgmtdConfig(heartbeat_timeout_s=self.cfg.heartbeat_timeout_s),
            clock=self.clock,
        )
        self.mgmtd.extend_lease()
        self.nodes: Dict[int, _Node] = {}
        self.chain_ids: List[int] = []
        self._engine_dirs: List[str] = []
        # symmetric blocked (src, dst) node-id pairs — the chaos
        # ``partition`` event's wire cut (mgmtd is node MGMTD_NODE_ID)
        self._blocked: set = set()
        self._boot_topology()
        self.meta = MetaStore(
            self.kv,
            ChainAllocator(1, self.chain_ids),
            file_length_hook=self._file_length,
            truncate_hook=self._truncate_chunks,
            space_hook=self._cluster_space,
            default_chunk_size=self.cfg.chunk_size,
        )
        self._client_seq = itertools.count(1)

    # -- topology -----------------------------------------------------------
    def _boot_topology(self) -> None:
        cfg = self.cfg
        for i in range(cfg.num_storage_nodes):
            node_id = self.FIRST_STORAGE_NODE_ID + i
            service = StorageService(
                node_id, self.node_routing(node_id), self.send_from(node_id),
                device=self.device,
            )
            if cfg.fencing:
                service.enable_fencing(
                    self.clock, cfg.heartbeat_timeout_s / 2.0)
            if cfg.qos is not None:
                from tpu3fs_torch.qos.manager import QosManager

                service.set_qos(QosManager(
                    cfg.qos, tags={"node": str(node_id)}))
            self.nodes[node_id] = _Node(node_id, service)
            self.mgmtd.register_node(node_id, NodeType.STORAGE)
        # chains: targets assigned round-robin over nodes (a chain's replicas
        # land on distinct nodes)
        tid = self.FIRST_TARGET_ID
        node_ids = sorted(self.nodes)
        node_cursor = 0
        is_ec = cfg.ec_k > 0
        width = (cfg.ec_k + cfg.ec_m) if is_ec else cfg.num_replicas
        # EC targets hold one shard of each stripe: engine chunk size is the
        # shard size, not the stripe size
        if is_ec:
            from tpu3fs_torch.ops.stripe import shard_size_of

            target_chunk_size = shard_size_of(cfg.chunk_size, cfg.ec_k)
        else:
            target_chunk_size = cfg.chunk_size
        for c in range(cfg.num_chains):
            chain_id = self.FIRST_CHAIN_ID + c + 1
            target_ids = []
            for _ in range(width):
                node_id = node_ids[node_cursor % len(node_ids)]
                node_cursor += 1
                self.mgmtd.create_target(tid, node_id=node_id)
                tpath = None
                if cfg.engine != "mem" and cfg.engine_dir:
                    tpath = tempfile.mkdtemp(
                        prefix=f"t{tid}-", dir=cfg.engine_dir)
                    self._engine_dirs.append(tpath)
                target = StorageTarget(
                    tid, chain_id, engine=cfg.engine,
                    path=tpath,
                    chunk_size=target_chunk_size,
                    device=self.device,
                )
                self.nodes[node_id].service.add_target(target)
                target_ids.append(tid)
                tid += 1
            self.mgmtd.upload_chain(
                chain_id, target_ids, ec_k=cfg.ec_k, ec_m=cfg.ec_m)
            self.chain_ids.append(chain_id)
        self.mgmtd.upload_chain_table(1, self.chain_ids)
        self.heartbeat_all()
        if cfg.chain_transport == "ici":
            from tpu3fs_torch.storage.ici_chain import IciChainReplicator

            for node in self.nodes.values():
                node.service.set_ici_replicator(
                    IciChainReplicator(cfg.mesh))

    # -- plumbing -----------------------------------------------------------
    def close(self) -> None:
        """Release disk-backed engine state (benches create fabrics on
        tmpfs via engine_dir — without cleanup /dev/shm fills up)."""
        import shutil

        for node in self.nodes.values():
            for target in node.service.targets():
                try:
                    target.engine.close()
                except Exception:
                    pass
        for d in self._engine_dirs:
            shutil.rmtree(d, ignore_errors=True)
        self._engine_dirs.clear()

    def routing(self):
        return self.mgmtd.get_routing_info()

    def node_routing(self, node_id: int):
        """Routing provider bound to one storage node: identical to the
        live view until a partition cuts the node off from mgmtd, then
        frozen at the snapshot taken when the partition began."""
        def provider():
            node = self.nodes.get(node_id)
            if node is not None and node.frozen_routing is not None \
                    and not self.can_reach(node_id, self.MGMTD_NODE_ID):
                return node.frozen_routing
            return self.mgmtd.get_routing_info()

        return provider

    # -- partitions (chaos ``partition`` events; docs/scale.md) --------------
    def set_partition(self, side_a: List[int], side_b: List[int]) -> None:
        """Cut every link between the two node sets (symmetric; node ids,
        MGMTD_NODE_ID stands for mgmtd). Nodes losing mgmtd reachability
        freeze their routing view at the current snapshot."""
        overlap = set(side_a) & set(side_b)
        if overlap:
            raise ValueError(f"partition sides overlap: {sorted(overlap)}")
        for a in side_a:
            for b in side_b:
                self._blocked.add((a, b))
                self._blocked.add((b, a))
        live = self.mgmtd.get_routing_info()
        for node in self.nodes.values():
            if node.frozen_routing is None \
                    and not self.can_reach(node.node_id, self.MGMTD_NODE_ID):
                node.frozen_routing = _freeze_routing(live)

    def heal_partitions(self) -> None:
        self._blocked.clear()
        for node in self.nodes.values():
            node.frozen_routing = None

    def can_reach(self, src: int, dst: int) -> bool:
        return (src, dst) not in self._blocked

    def send_from(self, src_id: int):
        """Messenger bound to a source node, so chain forwards respect
        partitions (the plain ``send`` has no source and models client
        traffic, which partitions never cut)."""
        def _send(node_id: int, method: str, payload):
            if self._blocked and not self.can_reach(src_id, node_id):
                raise FsError(Status(
                    Code.RPC_CONNECT_FAILED,
                    f"partitioned: {src_id} -/-> {node_id}"))
            return self.send(node_id, method, payload)

        return _send

    def send(self, node_id: int, method: str, payload):
        """Direct-dispatch messenger with fail-stop semantics."""
        node = self.nodes.get(node_id)
        if node is None or not node.alive:
            raise FsError(Status(Code.RPC_CONNECT_FAILED, f"node {node_id} down"))
        # cluster fault plane: the in-fabric analogue of the transports'
        # send/dispatch boundaries, so chaos schedules with rpc.* rules
        # (chaos/schedule.py) exercise transport faults in-process too;
        # drop rules surface as the torn-connection error the retry
        # ladders know
        from tpu3fs_torch.utils.fault_injection import plane as _fault_plane

        pl = _fault_plane()
        if pl.active:
            try:
                pl.fire(f"rpc.send.Fabric.{method}", node=node_id)
                pl.fire(f"rpc.dispatch.Fabric.{method}", node=node_id)
            except ConnectionError as e:
                raise FsError(Status(Code.RPC_PEER_CLOSED,
                                     f"node {node_id}: {e}"))
        svc = node.service
        if method == "write":
            return svc.write(payload)
        if method == "write_shard":
            return svc.write_shard(payload)
        if method == "update":
            return svc.update(payload)
        if method == "read_rebuild":
            return svc.read_rebuild(payload)
        if method == "batch_read_rebuild":
            return svc.batch_read_rebuild(payload)
        if method == "read":
            return svc.read(payload)
        if method == "batch_read":
            return svc.batch_read(payload)
        if method == "batch_write":
            return svc.batch_write(payload)
        if method == "batch_update":
            return svc.batch_update(payload)
        if method == "stat_chunks":
            return svc.stat_chunks(*payload)
        if method == "batch_write_shard":
            return svc.batch_write_shard(payload)
        if method == "chain_encode":
            return svc.chain_encode(payload)
        if method == "dump_chunkmeta":
            return svc.dump_chunkmeta(payload)
        if method == "dump_pending_chunkmeta":
            return svc.dump_pending_chunkmeta(payload)
        if method == "sync_done":
            return svc.sync_done(payload)
        if method == "remove_chunk":
            return svc.remove_chunk(*payload)
        if method == "remove_file_chunks":
            return svc.remove_file_chunks(*payload)
        if method == "query_last_chunk":
            return svc.query_last_chunk(*payload)
        if method == "truncate_file_chunks":
            return svc.truncate_file_chunks(*payload)
        if method == "space_info":
            return svc.space_info()
        raise FsError(Status(Code.RPC_METHOD_NOT_FOUND, method))

    # -- clients ------------------------------------------------------------
    def storage_client(self, **kw) -> StorageClient:
        return StorageClient(
            f"client-{next(self._client_seq)}", self.routing, self.send,
            device=self.device, **kw
        )

    def file_client(self, **kw) -> FileIoClient:
        return FileIoClient(self.storage_client(**kw))

    def _file_length(self, inode) -> int:
        return self.file_client().file_length(inode)

    def _truncate_chunks(self, inode, length: int) -> None:
        self.file_client().truncate_chunks(inode, length)

    def _cluster_space(self):
        si = self.storage_client().space_info()
        return si.capacity, si.used

    # -- elasticity (cluster reshaping; docs/placement.md) -------------------
    def add_storage_node(self, node_id: Optional[int] = None) -> int:
        """Join an empty storage node to the live cluster (the in-process
        analogue of booting another storage_main): registered, heartbeat-
        connected, zero targets — exactly what the rebalance planner
        treats as a JOIN delta."""
        if node_id is None:
            node_id = max(self.nodes) + 1
        service = StorageService(
            node_id, self.node_routing(node_id), self.send_from(node_id),
            device=self.device)
        if self.cfg.fencing:
            service.enable_fencing(
                self.clock, self.cfg.heartbeat_timeout_s / 2.0)
        if self.cfg.qos is not None:
            from tpu3fs_torch.qos.manager import QosManager

            service.set_qos(QosManager(
                self.cfg.qos, tags={"node": str(node_id)}))
        self.nodes[node_id] = _Node(node_id, service)
        self.mgmtd.register_node(node_id, NodeType.STORAGE)
        self.heartbeat_all()
        return node_id

    def open_assigned_targets(self) -> int:
        """The in-process mirror of storage_main.scan_targets: open any
        routing-assigned target a live node does not serve yet (migration
        PREPARE assigns them). Fresh targets on a chain past v1 report
        ONLINE and ride the WAITING→SYNCING recovery ladder."""
        routing = self.routing()
        is_ec = self.cfg.ec_k > 0
        if is_ec:
            from tpu3fs_torch.ops.stripe import shard_size_of

            chunk_size = shard_size_of(self.cfg.chunk_size, self.cfg.ec_k)
        else:
            chunk_size = self.cfg.chunk_size
        opened = 0
        for info in routing.targets.values():
            node = self.nodes.get(info.node_id)
            if node is None or not node.alive or not info.chain_id:
                continue
            if node.service.target(info.target_id) is not None:
                continue
            tpath = None
            if self.cfg.engine != "mem" and self.cfg.engine_dir:
                tpath = tempfile.mkdtemp(
                    prefix=f"t{info.target_id}-", dir=self.cfg.engine_dir)
                self._engine_dirs.append(tpath)
            target = StorageTarget(
                info.target_id, info.chain_id, engine=self.cfg.engine,
                path=tpath, chunk_size=chunk_size, device=self.device)
            chain = routing.chains.get(info.chain_id)
            if chain is not None and chain.chain_version > 1:
                target.local_state = LocalTargetState.ONLINE
            node.service.add_target(target)
            opened += 1
        return opened

    def retire_unassigned_targets(self) -> int:
        """The in-process mirror of storage_main's retirement pass: drop
        local targets routing no longer assigns here (migration cutover
        detached them — chain_id 0)."""
        retired = 0
        routing = self.routing()
        for node in self.nodes.values():
            if not node.alive:
                continue
            for target in node.service.targets():
                info = routing.targets.get(target.target_id)
                if info is None or info.chain_id == 0 \
                        or info.node_id != node.node_id:
                    dropped = node.service.drop_target(target.target_id)
                    if dropped is not None:
                        try:
                            dropped.engine.close()
                        except Exception:
                            pass
                        retired += 1
        return retired

    def elastic_tick(self, *, resync: bool = True) -> None:
        """One full elasticity round: open new assignments, heartbeat,
        run the chain updater, run resync/rebuild workers, retire
        detached targets — what the live cluster's loops do continuously.
        ``resync=False`` leaves the copying entirely to a migration
        worker (tests proving the worker moves the bytes)."""
        from tpu3fs_torch.storage.ec_resync import EcResyncWorker

        self.open_assigned_targets()
        self.tick()
        if resync:
            for node in self.nodes.values():
                if node.alive:
                    ResyncWorker(node.service, self.send).run_once()
                    EcResyncWorker(node.service, self.send,
                                   device=self.device).run_once()
        self.tick()
        self.retire_unassigned_targets()

    # -- cluster life -------------------------------------------------------
    def heartbeat_all(self) -> None:
        now = self.clock()
        for node in self.nodes.values():
            if not node.alive:
                continue
            if self._blocked \
                    and not self.can_reach(node.node_id, self.MGMTD_NODE_ID):
                # partitioned from mgmtd: the heartbeat never lands, and
                # the node judges its own lease fence on local time
                node.service.fence_tick()
                continue
            node.hb_version += 1
            states = {
                t.target_id: t.local_state for t in node.service.targets()
            }
            self.mgmtd.heartbeat(node.node_id, node.hb_version, states)
            node.service.note_mgmtd_contact(now)
            node.service.fence_tick()

    def tick(self, *, heartbeat: bool = True) -> None:
        if heartbeat:
            self.heartbeat_all()
        self.mgmtd.tick()

    def kill_node(self, node_id: int) -> None:
        node = self.nodes[node_id]
        node.alive = False
        node.service.stopped = True
        node.service.stop_workers()

    def fail_node(self, node_id: int) -> None:
        """Kill + advance time past the heartbeat timeout + chain update."""
        self.kill_node(node_id)
        self.clock.advance(self.cfg.heartbeat_timeout_s + 1)
        self.heartbeat_all()
        self.mgmtd.tick()

    def restart_node(self, node_id: int) -> None:
        """Bring a node back following the recovery protocol: its targets
        report ONLINE (not up-to-date) and go through WAITING->SYNCING
        (design_notes "Data recovery" step 1)."""
        node = self.nodes[node_id]
        node.alive = True
        node.service.stopped = False
        for target in node.service.targets():
            public = self.routing().targets.get(target.target_id)
            if public is not None and public.public_state in (
                PublicTargetState.OFFLINE,
                PublicTargetState.WAITING,
                PublicTargetState.LASTSRV,
            ):
                target.local_state = LocalTargetState.ONLINE
            # else keep UPTODATE (e.g. clean restart before mgmtd noticed)
        self.heartbeat_all()
        self.mgmtd.tick()

    def resync_all(self, rounds: int = 4, *, mesh=None) -> int:
        """Run resync workers on all live nodes until chains converge.
        CR chains use full-chunk-replace copying; EC chains rebuild the
        recovering shard on the fabric's device, or, with a ``LocalMesh``,
        through ``parallel.rebuild_lost_shard`` over it."""
        from tpu3fs_torch.storage.ec_resync import EcResyncWorker

        require_local_mesh(mesh, "the EC mesh rebuild", "M7")

        moved = 0
        for _ in range(rounds):
            for node in self.nodes.values():
                if node.alive:
                    moved += ResyncWorker(node.service, self.send).run_once()
                    moved += EcResyncWorker(
                        node.service, self.send, mesh=mesh,
                        device=self.device).run_once()
            self.tick()
            if all(
                t.public_state == PublicTargetState.SERVING
                for chain in self.routing().chains.values()
                for t in chain.targets
            ):
                break
        return moved

    # -- GC (driving MetaStore's queue against storage; ref GcManager) -------
    def run_gc(self) -> int:
        from tpu3fs_torch.qos.core import TrafficClass, tagged

        removed = 0
        fio = self.file_client()
        # chunk removals are GC-class traffic: scheduled behind foreground
        # IO by the storage-side WFQ (tpu3fs/qos)
        with tagged(TrafficClass.GC):
            for inode in self.meta.gc_scan():
                if self.meta.has_sessions(inode.id):
                    continue  # still write-open somewhere
                fio.remove_chunks(inode)
                self.meta.gc_finish(inode.id)
                removed += 1
        return removed
