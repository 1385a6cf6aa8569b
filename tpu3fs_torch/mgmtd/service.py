"""Cluster manager: lease-based primary election, heartbeats, chain updates,
versioned routing distribution, config distribution.

The port's own copy of ``tpu3fs/mgmtd/service.py``,
unchanged but for its imports.

Re-expresses src/mgmtd: MgmtdState guarded state persisted through the KV
store (MgmtdStore.cc — "SING"/"CHIT"/"CHIF"/"TGIF"/"NODE" prefixes), lease
election by compare-and-set inside a transaction (MgmtdStore::extendLease,
store/MgmtdStore.h:19-46), versioned heartbeats with staleness rejection
(ops/HeartbeatOperation.cc:36-134), the background chain updater applying the
state machine (background/MgmtdChainsUpdater), and per-node-type config blobs
pushed via heartbeat responses (CoreServiceDef.h getConfig/hotUpdateConfig).

Only the primary mutates cluster state; every mutation re-validates the lease
inside the same KV transaction that writes, so a deposed primary's writes
fail atomically.
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional

from tpu3fs_torch.kv.kv import IKVEngine, ITransaction, KeyPrefix, with_transaction
from tpu3fs_torch.mgmtd.chain_sm import step_chain
from tpu3fs_torch.mgmtd.types import (
    ChainInfo,
    ChainTable,
    ChainTarget,
    LeaseInfo,
    LocalTargetState,
    MetaPartition,
    NodeInfo,
    NodeStatus,
    NodeType,
    PublicTargetState,
    RoutingInfo,
    ServingEndpoint,
    TargetInfo,
)
from tpu3fs_torch.rpc.serde import deserialize, serialize
from tpu3fs_torch.utils.result import Code, FsError, Status

_LEASE_KEY = KeyPrefix.LEASE.value + b"primary"
_ROUTING_VER_KEY = b"RTVR"
_MIGRATION_SEQ_KEY = b"MGJC"


def _migration_key(job_id: int) -> bytes:
    return KeyPrefix.MIGRATION.value + struct.pack(">Q", job_id)


def _node_key(node_id: int) -> bytes:
    return KeyPrefix.NODE.value + struct.pack(">Q", node_id)


def _chain_key(chain_id: int) -> bytes:
    return KeyPrefix.CHAIN_INFO.value + struct.pack(">Q", chain_id)


def _table_key(table_id: int) -> bytes:
    return KeyPrefix.CHAIN_TABLE.value + struct.pack(">Q", table_id)


def _target_key(target_id: int) -> bytes:
    return KeyPrefix.TARGET_INFO.value + struct.pack(">Q", target_id)


def _config_key(node_type: NodeType) -> bytes:
    return KeyPrefix.CONFIG.value + struct.pack(">B", int(node_type))


def _serving_key(node_id: int) -> bytes:
    return KeyPrefix.SERVING.value + struct.pack(">Q", node_id)


def _meta_part_key(partition_id: int) -> bytes:
    # META_SERVER + "P": the persisted metadata partition table
    # (tpu3fs/metashard) — one row per partition, like chain rows
    return KeyPrefix.META_SERVER.value + b"P" + struct.pack(">H", partition_id)


@dataclass
class MgmtdConfig:
    lease_length_s: float = 60.0
    # T: silence after which a node is declared failed; services must
    # self-exit at T/2 without mgmtd contact (design_notes "Failure detection")
    heartbeat_timeout_s: float = 60.0
    new_chain_version_grace_s: float = 0.0
    # metadata partition count (tpu3fs/metashard): the table is created
    # lazily when the first META node connects; 0 = library default. The
    # count is FIXED once the table exists (partition math is baked into
    # issued inode ids), so changing this on a live cluster is ignored.
    meta_partitions: int = 0


@dataclass
class ConfigBlob:
    content: str = ""
    version: int = 0


@dataclass
class HeartbeatReply:
    routing_version: int
    config_version: int
    config_content: str = ""
    lease: Optional[LeaseInfo] = None


class Mgmtd:
    """One cluster-manager instance. Several may run; the lease picks one."""

    def __init__(
        self,
        node_id: int,
        engine: IKVEngine,
        config: Optional[MgmtdConfig] = None,
        clock: Callable[[], float] = time.time,
    ):
        self.node_id = node_id
        self._engine = engine
        self.config = config or MgmtdConfig()
        self._clock = clock
        # in-memory routing snapshot, rebuilt from KV (primary only serves it)
        self._routing = RoutingInfo()
        self._configs: Dict[NodeType, ConfigBlob] = {}
        # heartbeat-touched targets awaiting the TargetInfoPersister runner
        self._dirty_targets: set = set()
        # primacy edge detection for tick(): a standby reloads from KV on
        # promotion before running any background mutator
        self._was_primary = False
        # version-gated getRoutingInfo fast-path counter (lazy: most unit
        # tests never poll with a current version)
        self._not_modified_rec = None
        self._load()

    # -- persistence -------------------------------------------------------
    def _load(self) -> None:
        def op(txn: ITransaction):
            routing = RoutingInfo()
            ver = txn.get(_ROUTING_VER_KEY)
            routing.version = int(ver) if ver else 0
            for pair in txn.get_range(
                KeyPrefix.NODE.value, KeyPrefix.NODE.value + b"\xff" * 9,
                snapshot=True,
            ):
                info = deserialize(pair.value, NodeInfo)
                routing.nodes[info.node_id] = info
            for pair in txn.get_range(
                KeyPrefix.CHAIN_INFO.value, KeyPrefix.CHAIN_INFO.value + b"\xff" * 9,
                snapshot=True,
            ):
                info = deserialize(pair.value, ChainInfo)
                routing.chains[info.chain_id] = info
            for pair in txn.get_range(
                KeyPrefix.CHAIN_TABLE.value, KeyPrefix.CHAIN_TABLE.value + b"\xff" * 9,
                snapshot=True,
            ):
                tbl = deserialize(pair.value, ChainTable)
                routing.chain_tables[tbl.table_id] = tbl
            for pair in txn.get_range(
                KeyPrefix.TARGET_INFO.value, KeyPrefix.TARGET_INFO.value + b"\xff" * 9,
                snapshot=True,
            ):
                info = deserialize(pair.value, TargetInfo)
                routing.targets[info.target_id] = info
            for pair in txn.get_range(
                KeyPrefix.SERVING.value, KeyPrefix.SERVING.value + b"\xff" * 9,
                snapshot=True,
            ):
                ep = deserialize(pair.value, ServingEndpoint)
                routing.serving[ep.node_id] = ep
            for pair in txn.get_range(
                KeyPrefix.META_SERVER.value + b"P",
                KeyPrefix.META_SERVER.value + b"P" + b"\xff" * 3,
                snapshot=True,
            ):
                row = deserialize(pair.value, MetaPartition)
                routing.meta_partitions[row.partition_id] = row
            configs = {}
            for pair in txn.get_range(
                KeyPrefix.CONFIG.value, KeyPrefix.CONFIG.value + b"\xff" * 2,
                snapshot=True,
            ):
                nt = NodeType(pair.key[len(KeyPrefix.CONFIG.value)])
                configs[nt] = deserialize(pair.value, ConfigBlob)
            return routing, configs

        self._routing, self._configs = with_transaction(
            self._engine, op, read_only=True
        )

    def _bump_routing_in_txn(self, txn: ITransaction) -> int:
        """Bump the persisted routing version; the caller installs the
        returned value into the in-memory snapshot only AFTER the transaction
        commits (so deposed-primary/conflict aborts leave memory untouched)."""
        ver = txn.get(_ROUTING_VER_KEY)
        new = (int(ver) if ver else 0) + 1
        txn.set(_ROUTING_VER_KEY, str(new).encode())
        return new

    # -- lease election (ref MgmtdStore::extendLease) ------------------------
    def extend_lease(self, now: Optional[float] = None) -> LeaseInfo:
        """CAS on the lease record: acquire if free/expired, extend if held."""
        now = self._clock() if now is None else now

        def op(txn: ITransaction) -> LeaseInfo:
            raw = txn.get(_LEASE_KEY)
            lease = deserialize(raw, LeaseInfo) if raw else LeaseInfo()
            if lease.primary_node_id == self.node_id:
                lease.lease_end = now + self.config.lease_length_s
            elif lease.primary_node_id == 0 or now > lease.lease_end:
                lease = LeaseInfo(
                    primary_node_id=self.node_id,
                    lease_start=now,
                    lease_end=now + self.config.lease_length_s,
                    release_version=lease.release_version + 1,
                )
            txn.set(_LEASE_KEY, serialize(lease))
            return lease

        lease = with_transaction(self._engine, op)
        # primacy is CONFIRMED here (tests and apps may call extend_lease
        # outside tick); tick() reads the previous value before calling us
        # to detect the standby->primary edge
        self._was_primary = lease.primary_node_id == self.node_id
        return lease

    def _ensure_holder_in_txn(self, txn: ITransaction) -> None:
        """Reject when ANOTHER node holds the lease (expiry ignored):
        the guard for heartbeat/registration traffic. Accepting these on a
        node whose own lease merely expired is harmless — no other primary
        exists to diverge from, and the strict mutators still re-validate
        expiry — while rejecting them would break quiet clusters between
        lease extensions. The case that matters (a client pinned to a
        STANDBY while a live primary declares its nodes dead) is exactly
        `primary_node_id != self.node_id`, which this refuses."""
        raw = txn.get(_LEASE_KEY)
        lease = deserialize(raw, LeaseInfo) if raw else LeaseInfo()
        if lease.primary_node_id not in (0, self.node_id):
            raise FsError(Status(
                Code.MGMTD_NOT_PRIMARY,
                f"primary={lease.primary_node_id}"))

    def current_lease(self) -> LeaseInfo:
        def op(txn: ITransaction) -> LeaseInfo:
            raw = txn.get(_LEASE_KEY)
            return deserialize(raw, LeaseInfo) if raw else LeaseInfo()

        return with_transaction(self._engine, op, read_only=True)

    def is_primary(self, now: Optional[float] = None) -> bool:
        now = self._clock() if now is None else now
        lease = self.current_lease()
        return lease.primary_node_id == self.node_id and now <= lease.lease_end

    def _ensure_primary_in_txn(self, txn: ITransaction, now: float) -> None:
        """Re-validate the lease inside the mutating transaction, so writes of
        a deposed primary conflict-abort instead of landing."""
        raw = txn.get(_LEASE_KEY)
        lease = deserialize(raw, LeaseInfo) if raw else LeaseInfo()
        if lease.primary_node_id != self.node_id or now > lease.lease_end:
            raise FsError(
                Status(Code.MGMTD_NOT_PRIMARY, f"primary={lease.primary_node_id}")
            )

    # -- admin: bootstrap topology ------------------------------------------
    def create_target(
        self, target_id: int, node_id: int = 0, disk_index: int = 0
    ) -> None:
        info = TargetInfo(target_id, node_id=node_id, disk_index=disk_index)

        def op(txn: ITransaction) -> int:
            self._ensure_primary_in_txn(txn, self._clock())
            txn.set(_target_key(target_id), serialize(info))
            return self._bump_routing_in_txn(txn)

        ver = with_transaction(self._engine, op)
        self._routing.targets[target_id] = info
        self._routing.version = ver

    def upload_chain(self, chain_id: int, target_ids: List[int],
                     *, ec_k: int = 0, ec_m: int = 0,
                     wait_ready: bool = False) -> None:
        """Create a chain over existing targets. Default: optimistic
        SERVING/UPTODATE (single-process fabrics where targets exist by
        construction). wait_ready=True creates the chain NEWBORN — every
        target WAITING until its node heartbeats UPTODATE, when the
        NewBornChainsChecker promotes the whole chain to SERVING (ref
        src/mgmtd/background/MgmtdNewBornChainsChecker). With ec_k/ec_m
        the chain is an erasure-coded group (chain-table type "EC", ref
        data_placement.py:30): target i holds shard i."""
        if ec_k and len(target_ids) != ec_k + ec_m:
            raise FsError(Status(
                Code.INVALID_ARG,
                f"EC({ec_k},{ec_m}) needs {ec_k + ec_m} targets, "
                f"got {len(target_ids)}"))
        pub = (PublicTargetState.WAITING if wait_ready
               else PublicTargetState.SERVING)
        loc = (LocalTargetState.OFFLINE if wait_ready
               else LocalTargetState.UPTODATE)
        targets = [ChainTarget(t, pub, loc) for t in target_ids]
        chain = ChainInfo(chain_id, 1, targets, list(target_ids),
                          ec_k=ec_k, ec_m=ec_m)
        staged_infos = []
        for tid in target_ids:
            info = self._routing.targets.get(tid)
            info = replace(info) if info is not None else TargetInfo(tid)
            info.chain_id = chain_id
            info.public_state = pub
            info.local_state = loc
            staged_infos.append(info)

        def op(txn: ITransaction) -> int:
            self._ensure_primary_in_txn(txn, self._clock())
            txn.set(_chain_key(chain_id), serialize(chain))
            for info in staged_infos:
                txn.set(_target_key(info.target_id), serialize(info))
            return self._bump_routing_in_txn(txn)

        ver = with_transaction(self._engine, op)
        self._routing.chains[chain_id] = chain
        for info in staged_infos:
            self._routing.targets[info.target_id] = info
        self._routing.version = ver

    def upload_chain_table(self, table_id: int, chain_ids: List[int]) -> None:
        old = self._routing.chain_tables.get(table_id)
        tbl = ChainTable(table_id, (old.version + 1) if old else 1, list(chain_ids))

        def op(txn: ITransaction) -> int:
            self._ensure_primary_in_txn(txn, self._clock())
            txn.set(_table_key(table_id), serialize(tbl))
            return self._bump_routing_in_txn(txn)

        ver = with_transaction(self._engine, op)
        self._routing.chain_tables[table_id] = tbl
        self._routing.version = ver

    # -- live chain mutation (elasticity; ref src/mgmtd updateChain admin) ---
    def add_chain_target(self, chain_id: int, target_id: int, node_id: int,
                         *, disk_index: int = 0, replace_of: int = 0) -> None:
        """Join ``target_id`` (created on ``node_id``) to a LIVE chain.

        CR chains: the new member is APPENDED as WAITING/OFFLINE — the
        hosting node discovers it via routing, opens it ONLINE, and the
        chain state machine runs the ordinary WAITING→SYNCING→SERVING
        recovery ladder while every existing member keeps serving (the
        old member a migration job later drops stays readable the whole
        time).

        EC chains: members hold DIFFERENT shards, so a join must take
        over a specific shard position — ``replace_of`` names the member
        whose ``preferred_order`` slot the new target inherits; the old
        member leaves the chain atomically in the same version bump and
        the new shard is decode-rebuilt from the k+m-1 survivors
        (storage/ec_resync.py). Refused (MIGRATION_QUORUM) when any
        OTHER member is not SERVING — the swap may only spend the one
        redundancy unit the chain actually has spare.

        Idempotent: re-executing after a worker crash (the target is
        already a member) is a no-op."""
        chain = self._routing.chains.get(chain_id)
        if chain is None:
            raise FsError(Status(Code.MGMTD_CHAIN_NOT_FOUND, str(chain_id)))
        if any(t.target_id == target_id for t in chain.targets):
            return  # resumed worker re-executing a committed PREPARE
        from tpu3fs_torch.mgmtd.types import ChainTarget

        new_member = ChainTarget(target_id, PublicTargetState.WAITING,
                                 LocalTargetState.OFFLINE)
        targets = [replace(t) for t in chain.targets]
        order = list(chain.preferred_order)
        dropped_info: Optional[TargetInfo] = None
        if chain.is_ec:
            if replace_of not in order:
                raise FsError(Status(
                    Code.INVALID_ARG,
                    f"EC join needs replace_of naming a member of chain "
                    f"{chain_id} (got {replace_of})"))
            others = [t for t in targets if t.target_id != replace_of]
            if any(t.public_state != PublicTargetState.SERVING
                   for t in others):
                raise FsError(Status(
                    Code.MIGRATION_QUORUM,
                    f"EC chain {chain_id} already degraded: swapping "
                    f"{replace_of} would spend a second redundancy unit"))
            order[order.index(replace_of)] = target_id
            targets = others + [new_member]
            old = self._routing.targets.get(replace_of)
            if old is not None:
                dropped_info = replace(old)
                # KEEP chain_id: the swapped-out member leaves the chain
                # but must survive the hosting node's retirement scan
                # (which reaps chain_id 0) until the migration worker
                # releases it at cutover — that window is the EC drain
                # DIRECT-COPY path (the worker reads the outgoing shard
                # target-addressed, 1/k the bytes of a decode rebuild)
                dropped_info.public_state = PublicTargetState.OFFLINE
        else:
            targets.append(new_member)
            order.append(target_id)
        new_chain = replace(chain, targets=targets, preferred_order=order,
                            chain_version=chain.chain_version + 1)
        info = TargetInfo(target_id, node_id=node_id, disk_index=disk_index,
                          chain_id=chain_id,
                          public_state=PublicTargetState.WAITING,
                          local_state=LocalTargetState.OFFLINE)

        def op(txn: ITransaction) -> int:
            self._ensure_primary_in_txn(txn, self._clock())
            txn.set(_chain_key(chain_id), serialize(new_chain))
            txn.set(_target_key(target_id), serialize(info))
            if dropped_info is not None:
                txn.set(_target_key(dropped_info.target_id),
                        serialize(dropped_info))
            return self._bump_routing_in_txn(txn)

        ver = with_transaction(self._engine, op)
        self._routing.chains[chain_id] = new_chain
        self._routing.targets[target_id] = info
        if dropped_info is not None:
            self._routing.targets[dropped_info.target_id] = dropped_info
        self._routing.version = ver

    def drop_chain_target(self, chain_id: int, target_id: int,
                          *, min_serving: int = 1) -> None:
        """Remove a member from a live chain (migration cutover / dead-
        member retirement). Refused (MIGRATION_QUORUM) when the chain
        would keep fewer than ``min_serving`` SERVING members — the
        caller passes the chain's nominal width so a cutover can never
        under-replicate, and ``1`` for emergency pruning. The detached
        target's info stays in routing with chain_id=0/OFFLINE so the
        hosting node's target scan retires (trash-routes) its data.

        Idempotent: dropping a non-member is a no-op."""
        chain = self._routing.chains.get(chain_id)
        if chain is None:
            raise FsError(Status(Code.MGMTD_CHAIN_NOT_FOUND, str(chain_id)))
        if all(t.target_id != target_id for t in chain.targets):
            # not a member: a resumed worker re-executing a committed
            # cutover (no-op), or the RELEASE of an EC swap's outgoing
            # member — detached from the chain at PREPARE but kept alive
            # in routing (chain_id intact) for the drain direct-copy
            # window; cutover detaches it to chain_id 0 / OFFLINE so the
            # hosting node's scan retires (trash-routes) it. No quorum
            # gate: the release changes no chain membership.
            info = self._routing.targets.get(target_id)
            if info is None or info.chain_id != chain_id:
                return
            released = replace(info)
            released.chain_id = 0
            released.public_state = PublicTargetState.OFFLINE

            def release_op(txn: ITransaction) -> int:
                self._ensure_primary_in_txn(txn, self._clock())
                txn.set(_target_key(target_id), serialize(released))
                return self._bump_routing_in_txn(txn)

            ver = with_transaction(self._engine, release_op)
            self._routing.targets[target_id] = released
            self._routing.version = ver
            return
        remaining = [replace(t) for t in chain.targets
                     if t.target_id != target_id]
        serving_after = sum(
            1 for t in remaining
            if t.public_state == PublicTargetState.SERVING)
        if serving_after < min_serving:
            raise FsError(Status(
                Code.MIGRATION_QUORUM,
                f"dropping {target_id} leaves chain {chain_id} with "
                f"{serving_after} serving < quorum {min_serving}"))
        order = [t for t in chain.preferred_order if t != target_id]
        new_chain = replace(chain, targets=remaining, preferred_order=order,
                            chain_version=chain.chain_version + 1)
        info = self._routing.targets.get(target_id)
        info = replace(info) if info is not None else TargetInfo(target_id)
        info.chain_id = 0
        info.public_state = PublicTargetState.OFFLINE

        def op(txn: ITransaction) -> int:
            self._ensure_primary_in_txn(txn, self._clock())
            txn.set(_chain_key(chain_id), serialize(new_chain))
            txn.set(_target_key(target_id), serialize(info))
            return self._bump_routing_in_txn(txn)

        ver = with_transaction(self._engine, op)
        self._routing.chains[chain_id] = new_chain
        self._routing.targets[target_id] = info
        self._routing.version = ver

    def set_node_tags(self, node_id: int, tags: Dict[str, str]) -> None:
        """Merge operator tags onto a node record (empty value deletes a
        key). ``draining=1`` is how an operator marks a node for the
        rebalance planner to empty; tags persist and ride routing so
        every planner invocation — any client, any time — sees them."""
        node = self._routing.nodes.get(node_id)
        if node is None:
            raise FsError(Status(Code.MGMTD_NODE_NOT_FOUND, str(node_id)))
        merged = dict(node.tags)
        for k, v in tags.items():
            if v == "":
                merged.pop(k, None)
            else:
                merged[k] = v
        staged = replace(node, tags=merged)

        def op(txn: ITransaction) -> int:
            self._ensure_primary_in_txn(txn, self._clock())
            txn.set(_node_key(node_id), serialize(staged))
            return self._bump_routing_in_txn(txn)

        ver = with_transaction(self._engine, op)
        self._routing.nodes[node_id] = staged
        self._routing.version = ver

    # -- migration job store (crash-safe; ref src/migration job service) -----
    # Jobs live ONLY in the KV — no in-memory cache — so a failed-over
    # primary serves them unchanged and every mutation is one atomic,
    # lease-validated transaction.

    def _next_target_id(self) -> int:
        return max(self._routing.targets, default=999) + 1

    def migration_submit(self, specs: List["MoveSpec"]) -> List[int]:
        """Persist one job per spec; allocates job ids (and fresh target
        ids for specs that left new_target=0). Refuses (MIGRATION_CONFLICT)
        when an ACTIVE job already reshapes one of the chains — a chain
        migrates one membership at a time, which is what keeps the
        quorum invariant local to a single job."""
        from tpu3fs_torch.migration.types import MigrationJob

        now = self._clock()
        active_chains = {j.chain_id for j in self.migration_list()
                         if j.active}
        staged: List[MigrationJob] = []
        seen_chains = set()
        next_tid = self._next_target_id()
        for spec in specs:
            chain = self._routing.chains.get(spec.chain_id)
            if chain is None:
                raise FsError(Status(Code.MGMTD_CHAIN_NOT_FOUND,
                                     str(spec.chain_id)))
            if spec.chain_id in active_chains or spec.chain_id in seen_chains:
                raise FsError(Status(
                    Code.MIGRATION_CONFLICT,
                    f"chain {spec.chain_id} already has an active job"))
            seen_chains.add(spec.chain_id)
            new_target = spec.new_target
            if not new_target:
                new_target = next_tid
                next_tid += 1
            staged.append(MigrationJob(
                job_id=0, chain_id=spec.chain_id,
                out_target=spec.out_target, new_target=new_target,
                dst_node=spec.dst_node, is_ec=chain.is_ec,
                submitted_at=now, updated_at=now))

        def op(txn: ITransaction) -> List[int]:
            self._ensure_primary_in_txn(txn, now)
            raw = txn.get(_MIGRATION_SEQ_KEY)
            seq = int(raw) if raw else 0
            ids = []
            for job in staged:
                seq += 1
                job.job_id = seq
                txn.set(_migration_key(seq), serialize(job))
                ids.append(seq)
            txn.set(_MIGRATION_SEQ_KEY, str(seq).encode())
            return ids

        return with_transaction(self._engine, op)

    def migration_list(self) -> List["MigrationJob"]:
        from tpu3fs_torch.migration.types import MigrationJob

        def op(txn: ITransaction) -> List[MigrationJob]:
            return [deserialize(pair.value, MigrationJob)
                    for pair in txn.get_range(
                        KeyPrefix.MIGRATION.value,
                        KeyPrefix.MIGRATION.value + b"\xff" * 9,
                        snapshot=True)]

        return with_transaction(self._engine, op, read_only=True)

    def migration_claim(self, worker: str, *, max_jobs: int = 4,
                        lease_s: float = 30.0) -> List["MigrationJob"]:
        """Hand up to ``max_jobs`` runnable jobs to ``worker`` (CAS in one
        txn). A job is claimable when active and unowned — or when its
        claim LAPSED (the owning worker died mid-plan; resume is just the
        next claim). Renewal is claiming a job you already own."""
        now = self._clock()

        def op(txn: ITransaction) -> List:
            from tpu3fs_torch.migration.types import MigrationJob

            self._ensure_primary_in_txn(txn, now)
            out = []
            for pair in txn.get_range(
                    KeyPrefix.MIGRATION.value,
                    KeyPrefix.MIGRATION.value + b"\xff" * 9):
                job = deserialize(pair.value, MigrationJob)
                if not job.active:
                    continue
                if job.worker not in ("", worker) and now < job.claim_expire:
                    continue
                job.worker = worker
                job.claim_expire = now + lease_s
                job.updated_at = now
                txn.set(pair.key, serialize(job))
                out.append(job)
                if len(out) >= max_jobs:
                    break
            return out

        return with_transaction(self._engine, op)

    def migration_report(self, job_id: int, worker: str, *,
                         phase: Optional[int] = None,
                         copied_chunks: int = 0, copied_bytes: int = 0,
                         error: str = "",
                         lease_s: float = 30.0) -> "MigrationJob":
        """Persist a phase transition / progress heartbeat. Only the claim
        owner may report (MIGRATION_CONFLICT otherwise — a SIGKILLed
        worker that wakes up after its lease lapsed and was re-claimed
        cannot clobber the successor's progress). Phases only move
        FORWARD: an idempotent re-report of an already-passed phase is a
        no-op, which is what makes blind re-execution after a crash safe."""
        now = self._clock()

        def op(txn: ITransaction):
            from tpu3fs_torch.migration.types import JobPhase, MigrationJob

            self._ensure_primary_in_txn(txn, now)
            raw = txn.get(_migration_key(job_id))
            if raw is None:
                raise FsError(Status(Code.MIGRATION_JOB_NOT_FOUND,
                                     str(job_id)))
            job = deserialize(raw, MigrationJob)
            if job.worker != worker and now < job.claim_expire:
                raise FsError(Status(
                    Code.MIGRATION_CONFLICT,
                    f"job {job_id} claimed by {job.worker!r}"))
            job.worker = worker
            job.claim_expire = now + lease_s
            if phase is not None and int(phase) > int(job.phase):
                job.phase = JobPhase(int(phase))
            job.copied_chunks += int(copied_chunks)
            job.copied_bytes += int(copied_bytes)
            if error:
                job.error = error
            job.updated_at = now
            txn.set(_migration_key(job_id), serialize(job))
            return job

        return with_transaction(self._engine, op)

    # -- registration & heartbeat -------------------------------------------
    def register_node(
        self, node_id: int, node_type: NodeType, host: str = "", port: int = 0
    ) -> None:
        def op(txn: ITransaction):
            self._ensure_holder_in_txn(txn)
            info = NodeInfo(
                node_id, node_type, NodeStatus.HEARTBEAT_CONNECTING, host, port
            )
            existing = txn.get(_node_key(node_id))
            if existing is not None:
                old = deserialize(existing, NodeInfo)
                info.heartbeat_version = old.heartbeat_version
            txn.set(_node_key(node_id), serialize(info))
            return info, self._bump_routing_in_txn(txn)

        info, ver = with_transaction(self._engine, op)
        self._routing.nodes[node_id] = info
        self._routing.version = ver

    # -- KVCache serving endpoints (tpu3fs/serving peer directory) ----------
    def serving_register(self, node_id: int, host: str, port: int,
                         ttl_s: float = 30.0,
                         now: Optional[float] = None) -> None:
        """Publish (or TTL-renew) a process's peerRead endpoint in routing.
        Persisted like node infos so a primary restart keeps the directory;
        the routing version bumps only when membership or placement
        actually changes — pure renewals stay version-silent so clients'
        known-version polls keep answering 'unchanged'."""
        now = self._clock() if now is None else now
        ep = ServingEndpoint(node_id=node_id, host=host, port=port,
                             registered_at=now, ttl_s=max(1.0, float(ttl_s)))
        old = self._routing.serving.get(node_id)
        renewal = (old is not None and old.host == host
                   and old.port == port)

        def op(txn: ITransaction):
            self._ensure_holder_in_txn(txn)
            txn.set(_serving_key(node_id), serialize(ep))
            if renewal:
                return self._routing.version
            return self._bump_routing_in_txn(txn)

        ver = with_transaction(self._engine, op)
        self._routing.serving[node_id] = ep
        self._routing.version = ver
        self._prune_serving(now)

    def serving_unregister(self, node_id: int) -> None:
        def op(txn: ITransaction):
            self._ensure_holder_in_txn(txn)
            txn.clear(_serving_key(node_id))
            if node_id in self._routing.serving:
                return self._bump_routing_in_txn(txn)
            return self._routing.version

        ver = with_transaction(self._engine, op)
        self._routing.serving.pop(node_id, None)
        self._routing.version = ver

    def _prune_serving(self, now: Optional[float] = None) -> List[int]:
        """Drop endpoints whose TTL lapsed (a crashed serving process
        stops renewing); runs on every register and every tick."""
        now = self._clock() if now is None else now
        expired = [ep.node_id for ep in self._routing.serving.values()
                   if now - ep.registered_at > ep.ttl_s]
        if not expired:
            return expired

        def op(txn: ITransaction):
            for node_id in expired:
                txn.clear(_serving_key(node_id))
            return self._bump_routing_in_txn(txn)

        ver = with_transaction(self._engine, op)
        for node_id in expired:
            self._routing.serving.pop(node_id, None)
        self._routing.version = ver
        return expired

    def heartbeat(
        self,
        node_id: int,
        hb_version: int,
        local_states: Optional[Dict[int, LocalTargetState]] = None,
        now: Optional[float] = None,
        meta_loads: Optional[Dict[int, float]] = None,
    ) -> HeartbeatReply:
        """Versioned heartbeat; stale versions rejected
        (ref HeartbeatOperation.cc:36-134)."""
        now = self._clock() if now is None else now

        def op(txn: ITransaction) -> NodeInfo:
            # the holder guard runs FIRST: a standby's stale snapshot must
            # answer MGMTD_NOT_PRIMARY (which the multi-address client
            # fails over on), never MGMTD_NODE_NOT_FOUND judged from a
            # lagging view — otherwise a client pinned to the standby
            # looks alive HERE while the primary (which never sees the
            # heartbeats) declares the node dead and rotates its targets
            self._ensure_holder_in_txn(txn)
            node = self._routing.nodes.get(node_id)
            if node is None:
                raise FsError(
                    Status(Code.MGMTD_NODE_NOT_FOUND, str(node_id)))
            if hb_version < node.heartbeat_version:
                raise FsError(
                    Status(
                        Code.MGMTD_STALE_HEARTBEAT,
                        f"{hb_version} < {node.heartbeat_version}",
                    )
                )
            node.heartbeat_version = hb_version
            node.last_heartbeat = now
            node.status = NodeStatus.HEARTBEAT_CONNECTED
            txn.set(_node_key(node_id), serialize(node))
            return node

        # the node the TRANSACTION validated, not a re-lookup: a racing
        # standby-tick _load() may swap self._routing in between
        node = with_transaction(self._engine, op)
        if local_states:
            for target_id, ls in local_states.items():
                info = self._routing.targets.get(target_id)
                if info is not None:
                    if (info.local_state != ls
                            or info.node_id != node_id):
                        self._dirty_targets.add(target_id)
                    info.local_state = ls
                    info.node_id = node_id
                chain = self._routing.chain_of_target(target_id)
                if chain is not None:
                    for t in chain.targets:
                        if t.target_id == target_id:
                            t.local_state = ls
        if meta_loads:
            # ephemeral per-partition op-rate gauge (metashard): published
            # on routing for the CLI/assigner, never persisted — a primary
            # restart starts the gauges at zero like heartbeats
            for pid, load in meta_loads.items():
                row = self._routing.meta_partitions.get(pid)
                if row is not None and row.node_id == node_id:
                    row.load = float(load)
        blob = self._configs.get(node.type, ConfigBlob())
        return HeartbeatReply(
            routing_version=self._routing.version,
            config_version=blob.version,
            config_content=blob.content,
            lease=self.current_lease(),
        )

    def check_heartbeats(self, now: Optional[float] = None) -> List[int]:
        """Declare silent nodes dead; their targets' local states go OFFLINE.
        Returns the node ids newly declared failed."""
        now = self._clock() if now is None else now
        dead = []
        for node in self._routing.nodes.values():
            if node.status == NodeStatus.HEARTBEAT_CONNECTED and (
                now - node.last_heartbeat > self.config.heartbeat_timeout_s
            ):
                node.status = NodeStatus.HEARTBEAT_FAILED
                dead.append(node.node_id)
        if not dead:
            return dead

        def op(txn: ITransaction) -> None:
            for node_id in dead:
                txn.set(_node_key(node_id), serialize(self._routing.nodes[node_id]))

        with_transaction(self._engine, op)
        dead_set = set(dead)
        for chain in self._routing.chains.values():
            for t in chain.targets:
                info = self._routing.targets.get(t.target_id)
                if info is not None and info.node_id in dead_set:
                    t.local_state = LocalTargetState.OFFLINE
                    info.local_state = LocalTargetState.OFFLINE
                    # every writer of local_state must mark the target
                    # dirty, or persist_target_infos never writes the
                    # OFFLINE state and a primary restart resurrects the
                    # dead node's last heartbeat as UPTODATE
                    self._dirty_targets.add(t.target_id)
        return dead

    # -- metadata partition assigner (tpu3fs/metashard) ----------------------
    def update_meta_partitions(self, now: Optional[float] = None) -> int:
        """Keep every metadata partition owned by an alive META node, like
        update_chains keeps chains serving (docs/metashard.md): the table
        is created lazily when the first META node connects; a dead
        owner's partitions move to the least-loaded survivors (epoch
        bump per move); a joining node pulls partitions until ownership
        counts are balanced within one. Retained assignments never churn.
        Persists changed rows + bumps the routing version in one
        lease-validated transaction. Returns the number of moved rows."""
        now = self._clock() if now is None else now
        alive = sorted(
            n.node_id for n in self._routing.nodes.values()
            if n.type == NodeType.META
            and n.status == NodeStatus.HEARTBEAT_CONNECTED)
        if not alive and not self._routing.meta_partitions:
            return 0
        if not self._routing.meta_partitions:
            # sharding is opt-in: no table unless the operator configured
            # a width (legacy meta servers keep the any-op-anywhere shape)
            nparts = self.config.meta_partitions
            if not nparts:
                return 0
            table = {pid: MetaPartition(partition_id=pid)
                     for pid in range(nparts)}
        else:
            # stage copies; memory is installed only after the txn commits
            table = {pid: replace(row)
                     for pid, row in self._routing.meta_partitions.items()}
        if not alive:
            # nobody left to own anything: keep the last assignment (the
            # client ladder fails over; survivors pick the table back up)
            return 0
        owned = {nid: 0 for nid in alive}
        for row in table.values():
            if row.node_id in owned:
                owned[row.node_id] += 1
        changed = []
        for pid in sorted(table):
            row = table[pid]
            if row.node_id in owned:
                continue  # owner alive: never churn a retained assignment
            nid = min(alive, key=lambda n: (owned[n], n))
            owned[nid] += 1
            row.node_id = nid
            row.epoch += 1
            row.load = 0.0
            changed.append(row)
        while True:  # join rebalance: drain the most-loaded one move at a time
            hi = max(alive, key=lambda n: (owned[n], -n))
            lo = min(alive, key=lambda n: (owned[n], n))
            if owned[hi] - owned[lo] <= 1:
                break
            pid = min(p for p, r in table.items() if r.node_id == hi)
            row = table[pid]
            row.node_id = lo
            row.epoch += 1
            row.load = 0.0
            owned[hi] -= 1
            owned[lo] += 1
            changed.append(row)
        if not changed:
            return 0

        def op(txn: ITransaction) -> int:
            self._ensure_primary_in_txn(txn, now)
            for row in changed:
                txn.set(_meta_part_key(row.partition_id), serialize(row))
            return self._bump_routing_in_txn(txn)

        ver = with_transaction(self._engine, op)
        self._routing.meta_partitions = table
        self._routing.version = ver
        return len(changed)

    # -- chain updater (ref MgmtdChainsUpdater) ------------------------------
    def update_chains(self, now: Optional[float] = None) -> int:
        """Run the state machine over every chain; persist & bump routing
        version if anything changed. Returns number of updated chains."""
        now = self._clock() if now is None else now
        # stage everything; nothing is installed in memory until the
        # lease-validated transaction commits
        new_chains = {}
        changed_chains = []
        staged_infos = {}
        for chain in self._routing.chains.values():
            new_chain, changed = step_chain(chain)
            new_chains[chain.chain_id] = new_chain
            if changed:
                changed_chains.append(new_chain)
            for t in new_chain.targets:
                info = self._routing.targets.get(t.target_id)
                if info is not None and info.public_state != t.public_state:
                    staged = replace(info)
                    staged.public_state = t.public_state
                    staged_infos[t.target_id] = staged
        if not changed_chains:
            # local-state refreshes only: no version bump, no persistence
            self._routing.chains.update(new_chains)
            return 0

        def op(txn: ITransaction) -> int:
            self._ensure_primary_in_txn(txn, now)
            for chain in changed_chains:
                txn.set(_chain_key(chain.chain_id), serialize(chain))
            for info in staged_infos.values():
                txn.set(_target_key(info.target_id), serialize(info))
            return self._bump_routing_in_txn(txn)

        ver = with_transaction(self._engine, op)
        self._routing.chains.update(new_chains)
        self._routing.targets.update(staged_infos)
        self._routing.version = ver
        return len(changed_chains)

    # -- routing distribution -----------------------------------------------
    def get_routing_info(self, known_version: int = -1) -> Optional[RoutingInfo]:
        """None when the caller is already up to date (version match) —
        the version-gated fast path: the RPC binding turns None into a
        tiny ``changed=False`` reply instead of re-serializing the full
        snapshot for every poller each TTL (docs/scale.md)."""
        if known_version == self._routing.version:
            rec = self._not_modified_rec
            if rec is None:
                from tpu3fs_torch.monitor.recorder import CounterRecorder

                rec = CounterRecorder("mgmtd.routing_not_modified")
                self._not_modified_rec = rec
            rec.add(1)
            return None
        return self._routing

    # -- config distribution (ref SetConfig/GetConfig ops) -------------------
    def set_config(self, node_type: NodeType, content: str) -> int:
        old = self._configs.get(node_type, ConfigBlob())
        blob = ConfigBlob(content, old.version + 1)

        def op(txn: ITransaction) -> int:
            self._ensure_primary_in_txn(txn, self._clock())
            txn.set(_config_key(node_type), serialize(blob))
            return blob.version

        ver = with_transaction(self._engine, op)
        self._configs[node_type] = blob
        return ver

    def get_config(self, node_type: NodeType) -> ConfigBlob:
        return self._configs.get(node_type, ConfigBlob())

    # -- main periodic driver ------------------------------------------------
    def tick(self, now: Optional[float] = None) -> None:
        """One background round — the primary's runner set (ref
        src/mgmtd/background/): lease extension, heartbeat checking, chain
        updates, newborn-chain promotion, target-info persistence, metrics."""
        now = self._clock() if now is None else now
        was_primary = self._was_primary
        lease = self.extend_lease(now)  # updates _was_primary
        if lease.primary_node_id != self.node_id:
            # STANDBY: reload cluster state from the shared KV every tick.
            # Serving routing from (or, worse, later acting on) the
            # boot-time snapshot would hand out an empty/stale cluster —
            # and a freshly-promoted primary running check_heartbeats/
            # update_chains on stale state could clobber the real one.
            try:
                self._load()
            except FsError:
                pass  # KV hiccup: keep the last snapshot, retry next tick
            return
        if not was_primary:
            # primacy TRANSITION: act only on freshly-loaded state; a
            # failed load must NOT leave _was_primary set or the next
            # tick would mutate cluster state from the stale snapshot
            try:
                self._load()
            except FsError:
                self._was_primary = False
                return
            # HEARTBEAT GRACE: the loaded last_heartbeat stamps are from
            # the old primary's reign — up to a full residual lease old.
            # Judging them now would declare every surviving node dead in
            # one sweep. Promotion starts a fresh heartbeat epoch; nodes
            # get a full timeout to re-report before being judged.
            for node in self._routing.nodes.values():
                node.last_heartbeat = max(node.last_heartbeat, now)
        self.check_heartbeats(now)
        try:
            self._prune_serving(now)
        except FsError:
            pass  # deposed mid-tick: the new primary prunes
        try:
            self.update_meta_partitions(now)
        except FsError:
            pass  # deposed mid-tick: the new primary reassigns
        self.update_chains(now)
        self.check_newborn_chains()
        self.persist_target_infos()
        self.update_metrics()

    # -- background runners (ref src/mgmtd/background/) ----------------------
    def check_newborn_chains(self) -> int:
        """MgmtdNewBornChainsChecker analogue: a chain created with
        wait_ready=True holds every target WAITING until each target's
        node is heartbeat-connected and reports UPTODATE; only then does
        the whole chain flip to SERVING (one atomic version bump). The
        plain state machine cannot do this — WAITING stays WAITING without
        a serving source, which is exactly right for REPAIRS but would
        park a brand-new chain forever."""
        promoted = []
        staged_infos = {}
        for chain in self._routing.chains.values():
            targets = chain.targets
            if not targets or any(
                    t.public_state != PublicTargetState.WAITING
                    for t in targets):
                continue
            ready = True
            for t in targets:
                info = self._routing.targets.get(t.target_id)
                node = (self._routing.nodes.get(info.node_id)
                        if info is not None else None)
                if (info is None or node is None
                        or node.status != NodeStatus.HEARTBEAT_CONNECTED
                        or t.local_state != LocalTargetState.UPTODATE):
                    ready = False
                    break
            if not ready:
                continue
            new_targets = [replace(t, public_state=PublicTargetState.SERVING)
                           for t in targets]
            promoted.append(replace(
                chain, targets=new_targets,
                chain_version=chain.chain_version + 1))
            for t in new_targets:
                info = self._routing.targets.get(t.target_id)
                if info is not None:
                    staged = replace(info)
                    staged.public_state = PublicTargetState.SERVING
                    staged_infos[t.target_id] = staged
        if not promoted:
            return 0

        def op(txn: ITransaction) -> int:
            self._ensure_primary_in_txn(txn, self._clock())
            for chain in promoted:
                txn.set(_chain_key(chain.chain_id), serialize(chain))
            for info in staged_infos.values():
                txn.set(_target_key(info.target_id), serialize(info))
            return self._bump_routing_in_txn(txn)

        ver = with_transaction(self._engine, op)
        for chain in promoted:
            self._routing.chains[chain.chain_id] = chain
        self._routing.targets.update(staged_infos)
        self._routing.version = ver
        return len(promoted)

    def persist_target_infos(self) -> int:
        """MgmtdTargetInfoPersister analogue: heartbeat-reported LOCAL
        target states live in memory for speed; this runner batches the
        dirty ones into one transaction so a restarted primary reloads
        last-known states instead of assuming the world away (the loader
        half is _load(), which already reads them back)."""
        dirty = set(self._dirty_targets)
        if not dirty:
            return 0
        infos = [self._routing.targets[t] for t in dirty
                 if t in self._routing.targets]
        if not infos:
            self._dirty_targets -= dirty
            return 0

        def op(txn: ITransaction) -> int:
            self._ensure_primary_in_txn(txn, self._clock())
            for info in infos:
                txn.set(_target_key(info.target_id), serialize(info))
            return len(infos)

        try:
            n = with_transaction(self._engine, op)
        except FsError:
            # deposed / exhausted retries: keep the states dirty so a
            # future primacy (or the next tick) persists them
            return 0
        self._dirty_targets -= dirty
        return n

    def update_metrics(self) -> None:
        """MgmtdMetricsUpdater analogue: cluster-level gauges into the
        monitor pipeline (collector-queryable like every other recorder)."""
        rec = getattr(self, "_metrics_rec", None)
        if rec is None:
            from tpu3fs_torch.monitor.recorder import ValueRecorder

            rec = {
                "nodes_connected": ValueRecorder("mgmtd.nodes_connected"),
                "chains_serving": ValueRecorder("mgmtd.chains_serving"),
                "chains_degraded": ValueRecorder("mgmtd.chains_degraded"),
                "routing_version": ValueRecorder("mgmtd.routing_version"),
            }
            self._metrics_rec = rec
        connected = sum(
            1 for n in self._routing.nodes.values()
            if n.status == NodeStatus.HEARTBEAT_CONNECTED)
        serving = degraded = 0
        for chain in self._routing.chains.values():
            if all(t.public_state == PublicTargetState.SERVING
                   for t in chain.targets):
                serving += 1
            else:
                degraded += 1
        rec["nodes_connected"].set(connected)
        rec["chains_serving"].set(serving)
        rec["chains_degraded"].set(degraded)
        rec["routing_version"].set(self._routing.version)
