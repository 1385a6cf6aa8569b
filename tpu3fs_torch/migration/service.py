"""Migration: chain-to-chain copies AND the mgmtd-coordinated worker
that executes placement moves crash-safely.

Two layers, both riding the ordinary batched data plane through
``StorageClient`` (pipelining, hedging, deadlines, breaker guards and the
BACKGROUND-class tenant exemption come for free — the pre-PR-3 version
spoke raw ``Messenger`` single-ops):

- ``MigrationService`` — the reference's job service surface
  (src/migration/service/Service.h start/stop/list): copy every committed
  chunk of one chain onto another, batched, under the ``migration`` QoS
  class. Local registry, synchronous ``step()`` batches.

- ``MigrationWorker`` — the cluster-elasticity executor. Jobs are
  ``MigrationJob`` records persisted in the mgmtd KV
  (mgmtd.migration_submit/claim/report); each job replaces ONE chain
  membership and advances through the phase ladder
  PENDING → PREPARED → COPYING → SYNCED → CUTOVER → DONE where every
  transition is one atomic mgmtd transaction and every phase handler is
  idempotent re-execution — SIGKILL the worker (or the destination node)
  at ANY point, restart, and the next claim resumes from the last
  committed phase (docs/placement.md "crash matrix"). CR chains are
  filled by the worker itself: batched committed reads off the chain +
  batched full-replace installs addressed at the syncing member; EC
  chains swap the shard slot at PREPARE and the storage nodes'
  EcResyncWorker decode-rebuilds the new shard (the recovery traffic the
  placement solver's λ-balance spreads), with the worker monitoring and
  cutting over.

The port's own copy of ``tpu3fs/migration/service.py``, unchanged but for
its imports. The worker itself does no device work: its ``StorageClient``
(built on the app's device by ``bin/migration_main``) moves CR chunks and
EC shards as bytes, and a shard the direct copy could not land is
decode-rebuilt by the storage nodes' ``EcResyncWorker`` on their device
(K1, K3 for one loss).
"""

from __future__ import annotations

import enum
import itertools
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from tpu3fs_torch.migration.types import JobPhase, MigrationJob
from tpu3fs_torch.mgmtd.types import PublicTargetState
from tpu3fs_torch.storage.craq import ReadReq, ShardWriteReq, WriteReq
from tpu3fs_torch.storage.types import ChunkId
from tpu3fs_torch.utils.result import Code, FsError, err

MIGRATION_SERVICE_ID = 400

#: Every RPC the crash-resumed worker blindly RE-EXECUTES when it
#: re-enters a phase from the top. check_rpc_registry check 8 proves each
#: is bound and either idempotent or documented replay-safe
#: (rpc/idempotency.py REPLAY_SAFE_MUTATIONS) — extending the worker with
#: a new mutation forces you to document why its replay converges.
RESUME_REEXECUTED_METHODS = frozenset({
    ("Mgmtd", "getRoutingInfo"),
    ("Mgmtd", "addChainTarget"),
    ("Mgmtd", "dropChainTarget"),
    ("Mgmtd", "migrationClaim"),
    ("Mgmtd", "migrationReport"),
    # the auto re-plan loop (maybe_replan): list is read-only, submit is
    # conflict-refused per chain and re-derived from live routing
    ("Mgmtd", "migrationList"),
    ("Mgmtd", "migrationSubmit"),
    ("StorageSerde", "dumpChunkMeta"),
    ("StorageSerde", "batchRead"),
    ("StorageSerde", "batchUpdate"),
    ("StorageSerde", "syncDone"),
    # the EC drain direct-copy round (_ec_copy_round)
    ("StorageSerde", "batchReadRebuild"),
    ("StorageSerde", "batchWriteShard"),
})

# -- recorders (single declaration site; docs/observability.md) --------------
from tpu3fs_torch.monitor.recorder import CounterRecorder, ValueRecorder

_rec_copied_chunks = CounterRecorder("migration.copied_chunks")
_rec_copied_bytes = CounterRecorder("migration.copied_bytes")
_rec_jobs_done = CounterRecorder("migration.jobs_done")
_rec_retired_targets = CounterRecorder("migration.retired_targets")
_rec_active = ValueRecorder("migration.active_jobs")


def record_retired_target(n: int = 1) -> None:
    """Storage-node hook: a target whose routing assignment vanished was
    closed + trash-routed (bin/storage_main.py scan_targets)."""
    _rec_retired_targets.add(n)


# ---------------------------------------------------------------------------
# chain-to-chain copy service (ref src/migration/service/Service.h)
# ---------------------------------------------------------------------------

class JobState(enum.IntEnum):
    PENDING = 0
    RUNNING = 1
    STOPPED = 2
    DONE = 3
    FAILED = 4


@dataclass
class Job:
    job_id: int
    src_chain: int
    dst_chain: int
    state: JobState = JobState.PENDING
    copied: int = 0
    total: int = 0
    error: str = ""
    # chunk ids (raw bytes) still to copy; populated on first step
    _queue: List[bytes] = field(default_factory=list, repr=False)
    _scanned: bool = field(default=False, repr=False)


class MigrationService:
    """Job registry + batched chunk-copy executor over a StorageClient."""

    def __init__(self, client):
        self._client = client
        self._jobs: Dict[int, Job] = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    # -- job control (ref migration/service/Service.h start/stop/list) ------
    def start_job(self, src_chain: int, dst_chain: int) -> int:
        if src_chain == dst_chain:
            raise ValueError("src and dst chains must differ")
        with self._lock:
            job_id = next(self._ids)
            self._jobs[job_id] = Job(job_id, src_chain, dst_chain,
                                     state=JobState.RUNNING)
            return job_id

    def stop_job(self, job_id: int) -> bool:
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.state not in (JobState.PENDING,
                                                JobState.RUNNING):
                return False
            job.state = JobState.STOPPED
            return True

    def list_jobs(self) -> List[Job]:
        with self._lock:
            return list(self._jobs.values())

    def job(self, job_id: int) -> Optional[Job]:
        with self._lock:
            return self._jobs.get(job_id)

    # -- executor -----------------------------------------------------------
    def _head_target(self, chain_id: int):
        routing = self._client._routing()
        chain = routing.chains.get(chain_id)
        if chain is None:
            raise err(Code.CHAIN_NOT_FOUND, f"chain {chain_id}")
        head = chain.head()
        if head is None:
            raise err(Code.TARGET_OFFLINE, f"chain {chain_id} has no serving head")
        node = routing.node_of_target(head.target_id)
        if node is None:
            raise err(Code.TARGET_NOT_FOUND,
                      f"target {head.target_id} not in routing info")
        return head.target_id, node.node_id

    def _scan(self, job: Job) -> None:
        target_id, node_id = self._head_target(job.src_chain)
        metas = self._client.dump_chunkmeta(node_id, target_id)
        job._queue = [m.chunk_id.to_bytes() for m in metas if m.committed_ver > 0]
        job.total = len(job._queue)
        job._scanned = True

    def step(self, job_id: int, batch: int = 64) -> int:
        """Copy up to `batch` chunks as ONE batched read + ONE batched
        full-replace write; returns chunks copied this step. Traffic is
        tagged MIGRATION (tpu3fs_torch/qos) so destination update workers
        schedule it behind foreground IO; an OVERLOADED shed pauses the
        job for the server's retry-after hint and leaves it RUNNING —
        migration self-throttles under pressure instead of failing or
        hammering."""
        from tpu3fs_torch.qos.core import TrafficClass, tagged

        job = self.job(job_id)
        if job is None or job.state != JobState.RUNNING:
            return 0
        with tagged(TrafficClass.MIGRATION):
            return self._step_tagged(job, batch)

    def _step_tagged(self, job: Job, batch: int) -> int:
        try:
            if not job._scanned:
                self._scan(job)
            self._head_target(job.dst_chain)  # dst must be routable
            with self._lock:
                if job.state != JobState.RUNNING:
                    return 0  # concurrent stop_job wins
                raws = job._queue[-batch:]
            if not raws:
                with self._lock:
                    if job.state == JobState.RUNNING:
                        job.state = JobState.DONE
                return 0
            ids = [ChunkId.from_bytes(raw) for raw in raws]
            reads = self._client.batch_read(
                [ReadReq(job.src_chain, cid, 0, -1) for cid in ids])
            writes, widx = [], []
            shed_hint = 0
            for i, rd in enumerate(reads):
                if rd.code in (Code.OVERLOADED, Code.TENANT_THROTTLED):
                    shed_hint = max(shed_hint, rd.retry_after_ms or 10)
                    continue
                if not rd.ok:
                    raise err(rd.code, f"read {ids[i]} failed")
                # full_replace: install the copy as the chunk's entire
                # committed content — a plain CRAQ write would merge with
                # any pre-existing destination chunk (COW overlay) and
                # corrupt it. chunk_size=0 = destination target's size.
                writes.append((job.dst_chain, ids[i], 0, rd.data))
                widx.append(i)
            replies = self._client.batch_write(
                writes, chunk_size=0, full_replace=True) if writes else []
            copied = 0
            done_raws = []
            for k, wr in enumerate(replies):
                i = widx[k]
                if wr.code in (Code.OVERLOADED, Code.TENANT_THROTTLED):
                    shed_hint = max(shed_hint, wr.retry_after_ms or 10)
                    continue
                if not wr.ok:
                    raise err(wr.code, f"write {ids[i]} failed")
                copied += 1
                done_raws.append(raws[i])
                _rec_copied_chunks.add(1)
                _rec_copied_bytes.add(len(writes[k][3]))
            with self._lock:
                done = set(done_raws)
                job._queue = [r for r in job._queue if r not in done]
                job.copied += copied
                if not job._queue and job.state == JobState.RUNNING:
                    job.state = JobState.DONE
            if shed_hint:
                time.sleep(max(shed_hint, 10) / 1000.0)
            return copied
        except FsError as e:
            job.state = JobState.FAILED
            job.error = str(e)
            return 0

    def run_job(self, job_id: int, batch: int = 64, max_steps: int = 10_000) -> Job:
        """Drive one job to completion (or failure/stop)."""
        for _ in range(max_steps):
            self.step(job_id, batch)
            job = self.job(job_id)
            if job is None or job.state != JobState.RUNNING:
                break
        return self.job(job_id)


# ---------------------------------------------------------------------------
# mgmtd-coordinated elasticity worker
# ---------------------------------------------------------------------------

class MigrationWorker:
    """Claims ``MigrationJob``s from mgmtd and executes them phase by
    phase. Stateless between rounds: ALL durable state is the mgmtd job
    record plus the cluster itself, so any worker instance (including a
    restart after SIGKILL) continues any job. ``mgmtd`` is an in-process
    ``Mgmtd`` or an ``MgmtdAdminRpcClient`` — same surface."""

    def __init__(self, mgmtd, client, *, worker_id: str = "",
                 batch_chunks: int = 64, lease_s: float = 30.0,
                 max_jobs: int = 4, auto_replan: bool = False,
                 clock: Callable[[], float] = time.monotonic):
        self._mgmtd = mgmtd
        self._client = client
        self.worker_id = worker_id or f"mig-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        self._batch = batch_chunks
        self._lease_s = lease_s
        self._max_jobs = max_jobs
        self._auto_replan = auto_replan
        self._clock = clock

    # -- rounds --------------------------------------------------------------
    def run_once(self) -> int:
        """Claim runnable jobs and advance each by one bounded step.
        Returns the number of jobs that made progress. Transport errors
        (mgmtd failover, dead destination) leave jobs claimed-but-parked;
        the next round — or the next worker after our lease lapses —
        retries."""
        from tpu3fs_torch.qos.core import TrafficClass, tagged

        try:
            jobs = self._mgmtd.migration_claim(
                self.worker_id, max_jobs=self._max_jobs,
                lease_s=self._lease_s)
        except FsError:
            return 0
        # one job per chain at a time is the mgmtd submit invariant;
        # claims arrive id-ordered so waves execute in plan order
        _rec_active.set(len(jobs))
        advanced = 0
        with tagged(TrafficClass.MIGRATION):
            for job in jobs:
                try:
                    if self.step(job):
                        advanced += 1
                except FsError as e:
                    if e.code in (Code.MIGRATION_CONFLICT,
                                  Code.MIGRATION_JOB_NOT_FOUND):
                        continue  # another worker took over
                    if e.code in (Code.MGMTD_CHAIN_NOT_FOUND,
                                  Code.INVALID_ARG):
                        self._report(job, phase=JobPhase.FAILED,
                                     error=str(e))
                        continue
                    # transient (transport, shed, quorum wait): park,
                    # record the reason, retry next round
                    self._report(job, error=str(e))
        if self._auto_replan:
            self.maybe_replan()
        return advanced

    def maybe_replan(self) -> int:
        """Auto re-plan for multi-failure chains: the planner evacuates
        at most ONE member per chain per wave (its quorum invariant is
        local to a single job), so a chain with TWO members on leaving
        nodes previously took one operator wave per member. When every
        submitted job has settled but draining/dead nodes still host
        chain members, submit the next replacement wave ourselves —
        the operator's drain converges unattended. Conservative by
        construction: only fires after at least one operator-submitted
        job exists (the worker never initiates evacuation), never
        auto-FILLS joined nodes (``fill_joined=False`` — joined nodes
        stay eligible as evacuation DESTINATIONS, which matters when an
        evacuated-then-restarted empty node is the only legal home for
        a leaving member, but capacity rebalancing stays an operator
        decision), and a quorum-unsafe or conflicting plan just waits
        for the next round. Returns jobs submitted."""
        from tpu3fs_torch.placement.rebalance import (
            TopologyDelta,
            check_plan,
            plan_rebalance,
        )

        try:
            jobs = self._mgmtd.migration_list()
        except FsError:
            return 0
        if not jobs or any(j.active for j in jobs):
            return 0
        routing = self._routing()
        delta = TopologyDelta.from_routing(routing)
        if not (delta.draining or delta.dead):
            return 0
        plan = plan_rebalance(routing, delta, fill_joined=False)
        if plan.empty or check_plan(routing, plan, delta):
            return 0
        try:
            ids = self._mgmtd.migration_submit(
                [mv.spec() for mv in plan.moves])
        except FsError:
            return 0  # raced a peer worker: its wave wins
        return len(ids)

    def run_until_idle(self, *, rounds: int = 200,
                       tick: Optional[Callable[[], None]] = None,
                       sleep_s: float = 0.0) -> int:
        """Run rounds until no active jobs remain. ``tick``
        runs the mgmtd background pass between rounds (fabric clusters
        have no tick loop of their own)."""
        done = 0
        for _ in range(rounds):
            self.run_once()
            if tick is not None:
                tick()
            jobs = self._mgmtd.migration_list()
            if not any(j.active for j in jobs):
                return sum(1 for j in jobs
                           if JobPhase(j.phase) == JobPhase.DONE)
            if sleep_s:
                time.sleep(sleep_s)
        raise TimeoutError("migration jobs did not converge")

    # -- one phase step -------------------------------------------------------
    def step(self, job: MigrationJob) -> bool:
        """Advance ``job`` by at most one phase transition (plus one copy
        round). True = progress was made."""
        phase = JobPhase(job.phase)
        if phase == JobPhase.PENDING:
            return self._step_prepare(job)
        if phase == JobPhase.PREPARED:
            return self._step_wait_syncing(job)
        if phase == JobPhase.COPYING:
            return self._step_copy(job)
        if phase == JobPhase.SYNCED:
            return self._step_cutover(job)
        if phase == JobPhase.CUTOVER:
            self._report(job, phase=JobPhase.DONE)
            _rec_jobs_done.add(1)
            return True
        return False

    # -- phase handlers (each idempotent under re-execution) ------------------
    def _routing(self):
        invalidate = getattr(self._client, "_routing_invalidate", None)
        if invalidate is not None:
            invalidate()
        return self._client._routing()

    def _chain(self, routing, job: MigrationJob):
        chain = routing.chains.get(job.chain_id)
        if chain is None:
            raise err(Code.MGMTD_CHAIN_NOT_FOUND, str(job.chain_id))
        return chain

    def _member(self, chain, target_id: int):
        return next((t for t in chain.targets if t.target_id == target_id),
                    None)

    def _step_prepare(self, job: MigrationJob) -> bool:
        # re-execution safe: already-a-member is a mgmtd-side no-op
        self._mgmtd.add_chain_target(
            job.chain_id, job.new_target, job.dst_node,
            replace_of=(job.out_target if job.is_ec else 0))
        self._report(job, phase=JobPhase.PREPARED)
        return True

    def _step_wait_syncing(self, job: MigrationJob) -> bool:
        routing = self._routing()
        chain = self._chain(routing, job)
        member = self._member(chain, job.new_target)
        if member is None:
            # routing lag after a failover: re-prepare (idempotent)
            return self._step_prepare(job)
        if member.public_state == PublicTargetState.SERVING:
            self._report(job, phase=JobPhase.SYNCED)
            return True
        if member.public_state == PublicTargetState.SYNCING:
            self._report(job, phase=JobPhase.COPYING)
            return True
        return False  # WAITING/OFFLINE: node hasn't opened it yet

    def _step_copy(self, job: MigrationJob) -> bool:
        routing = self._routing()
        chain = self._chain(routing, job)
        member = self._member(chain, job.new_target)
        if member is None:
            return self._step_prepare(job)
        if member.public_state == PublicTargetState.SERVING:
            self._report(job, phase=JobPhase.SYNCED)
            return True
        if member.public_state != PublicTargetState.SYNCING:
            return False  # destination bounced: wait for re-promotion
        if job.is_ec:
            # DIRECT shard copy from the outgoing member while it is
            # still alive (1/k the bytes of a decode rebuild); the
            # chain's EcResyncWorker stays the dead-outgoing-target
            # fallback AND the verifier/promoter either way
            return self._ec_copy_round(job, routing, chain)
        return self._copy_round(job, routing, chain)

    def _copy_round(self, job: MigrationJob, routing, chain) -> bool:
        """One bounded CR copy round: diff the destination against the
        serving head, ship one batch of full-replace installs, declare
        sync-done when the diff is empty. Every piece re-runs safely:
        reads are idempotent, installs dedupe by version, sync-done is a
        no-op repeat."""
        head = chain.head()
        if head is None:
            return False  # no serving source: nothing safe to copy from
        head_node = routing.node_of_target(head.target_id)
        writers = chain.writer_chain()
        my_idx = next((i for i, t in enumerate(writers)
                       if t.target_id == job.new_target), None)
        if head_node is None or my_idx is None or my_idx == 0:
            return False
        pred = writers[my_idx - 1].target_id
        src = [m for m in self._client.dump_chunkmeta(
            head_node.node_id, head.target_id) if m.committed_ver > 0]
        have = {m.chunk_id: m for m in self._client.dump_chunkmeta(
            job.dst_node, job.new_target)}
        todo = []
        for m in src:
            mine = have.get(m.chunk_id)
            if (mine is not None and mine.committed_ver >= m.committed_ver
                    and (mine.committed_ver > m.committed_ver
                         or mine.checksum.value == m.checksum.value)):
                continue
            todo.append(m)
        if not todo:
            self._client.sync_done(job.dst_node, job.new_target)
            self._report(job, phase=JobPhase.SYNCED)
            return True
        batch = todo[:self._batch]
        reads = self._client.batch_read(
            [ReadReq(job.chain_id, m.chunk_id, 0, -1) for m in batch])
        reqs, sizes = [], []
        hint = 0
        for m, rd in zip(batch, reads):
            if not rd.ok:
                hint = max(hint, rd.retry_after_ms)
                continue  # re-diffed next round
            reqs.append(WriteReq(
                chain_id=job.chain_id,
                chain_ver=chain.chain_version,
                chunk_id=m.chunk_id,
                offset=0,
                data=rd.data,
                chunk_size=0,   # destination target's configured size
                client_id=f"migration-{job.job_id}",
                update_ver=rd.commit_ver,
                full_replace=True,
                from_target=pred,
            ))
            sizes.append(len(rd.data))
        replies = self._client.batch_sync_write(job.dst_node, reqs)
        copied = nbytes = 0
        for sz, wr in zip(sizes, replies):
            if wr.code in (Code.OVERLOADED, Code.TENANT_THROTTLED):
                hint = max(hint, wr.retry_after_ms or 10)
                continue
            if wr.ok:
                copied += 1
                nbytes += sz
        if copied:
            _rec_copied_chunks.add(copied)
            _rec_copied_bytes.add(nbytes)
            self._report(job, copied_chunks=copied, copied_bytes=nbytes)
        if hint:
            # the destination shed us: self-throttle for its hint — the
            # migration class is exactly the traffic QoS exists to pace
            time.sleep(max(hint, 10) / 1000.0)
        return copied > 0

    def _ec_copy_round(self, job: MigrationJob, routing, chain) -> bool:
        """One bounded EC DIRECT-COPY round: the outgoing member a swap
        detached from the chain (routing keeps its TargetInfo at
        chain_id 0 until the hosting node retires it) holds EXACTLY the
        shard the new member needs — read it target-addressed
        (batch_read_rebuild with chain_id 0) and install it on the
        destination at the source's committed stripe version, moving 1/k
        the bytes a decode rebuild reads. Every piece re-runs safely:
        reads are idempotent, installs version-dedupe, and ANY failure
        (outgoing node dead, target already retired, raced writes) just
        returns False — the chain's EcResyncWorker decode-rebuilds
        whatever this round didn't land and remains the sole promoter,
        so correctness never depends on the fast path."""
        from tpu3fs_torch.ops.stripe import aligned_shard_size

        if not job.out_target:
            return False
        out_info = routing.targets.get(job.out_target)
        out_node = (routing.nodes.get(out_info.node_id)
                    if out_info is not None else None)
        if out_info is None or out_node is None:
            return False  # outgoing member gone: decode rebuild recovers
        try:
            src = [m for m in self._client.dump_chunkmeta(
                out_info.node_id, job.out_target) if m.committed_ver > 0]
            have = {m.chunk_id.to_bytes(): m
                    for m in self._client.dump_chunkmeta(
                        job.dst_node, job.new_target)}
        except FsError:
            return False  # unreachable/retired: decode rebuild recovers
        todo = []
        for m in src:
            if m.length == 0:
                continue  # empty tail shards: the rebuilder's business
            mine = have.get(m.chunk_id.to_bytes())
            if mine is not None and mine.committed_ver >= m.committed_ver:
                continue
            todo.append(m)
        if not todo:
            return False  # nothing left to fast-copy; rebuilder promotes
        batch = todo[:self._batch]
        reads = self._client.batch_read_rebuild(out_info.node_id, [
            ReadReq(0, m.chunk_id, 0, -1, job.out_target) for m in batch])
        reqs, sizes = [], []
        for m, rd in zip(batch, reads):
            if not rd.ok or rd.commit_ver != m.committed_ver:
                continue  # raced/refused: re-diffed next round
            reqs.append(ShardWriteReq(
                chain_id=job.chain_id,
                chain_ver=chain.chain_version,
                target_id=job.new_target,
                chunk_id=m.chunk_id,
                data=rd.data,
                crc=rd.checksum.value,
                update_ver=rd.commit_ver,
                chunk_size=aligned_shard_size(len(rd.data)),
                logical_len=rd.logical_len,
                phase=0,   # proven content installs committed in one step
            ))
            sizes.append(len(rd.data))
        replies = self._client.batch_write_shard(job.dst_node, reqs)
        copied = nbytes = 0
        hint = 0
        for sz, wr in zip(sizes, replies):
            if wr.code in (Code.OVERLOADED, Code.TENANT_THROTTLED):
                hint = max(hint, wr.retry_after_ms or 10)
                continue
            if wr.ok:
                copied += 1
                nbytes += sz
        if copied:
            _rec_copied_chunks.add(copied)
            _rec_copied_bytes.add(nbytes)
            self._report(job, copied_chunks=copied, copied_bytes=nbytes)
        if hint:
            time.sleep(max(hint, 10) / 1000.0)
        return copied > 0

    def _step_cutover(self, job: MigrationJob) -> bool:
        routing = self._routing()
        chain = self._chain(routing, job)
        member = self._member(chain, job.new_target)
        if member is None or member.public_state != PublicTargetState.SERVING:
            if member is not None \
                    and member.public_state == PublicTargetState.SYNCING \
                    and not job.is_ec:
                # destination bounced after sync-done: top the copy back up
                self._copy_round(job, routing, chain)
            return False
        if job.out_target and self._member(chain, job.out_target) is not None:
            # the old member stayed readable until HERE — the new replica
            # serves; quorum floor = the chain's nominal width (every
            # remaining member must be serving for the drop to land)
            self._mgmtd.drop_chain_target(
                job.chain_id, job.out_target,
                min_serving=len(chain.targets) - 1)
        elif job.out_target and job.is_ec:
            # EC swap: the outgoing member left the chain at PREPARE but
            # routing kept it alive for the direct-copy window — RELEASE
            # it now (detach to chain_id 0) so the hosting node's scan
            # retires its data; idempotent under re-execution
            self._mgmtd.drop_chain_target(job.chain_id, job.out_target)
        self._report(job, phase=JobPhase.CUTOVER)
        return True

    def _report(self, job: MigrationJob, *, phase: Optional[JobPhase] = None,
                copied_chunks: int = 0, copied_bytes: int = 0,
                error: str = "") -> None:
        try:
            self._mgmtd.migration_report(
                job.job_id, self.worker_id, phase=phase,
                copied_chunks=copied_chunks, copied_bytes=copied_bytes,
                error=error, lease_s=self._lease_s)
        except FsError as e:
            if e.code in (Code.MIGRATION_CONFLICT,
                          Code.MIGRATION_JOB_NOT_FOUND):
                raise
            # mgmtd hiccup: the phase re-executes next round (safe)
