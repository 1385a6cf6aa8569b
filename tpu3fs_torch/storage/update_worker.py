"""Per-target bounded update queues + worker threads (group commit),

The port's own copy of ``tpu3fs/storage/update_worker.py``,
unchanged but for its imports.

scheduled weighted-fair by traffic class.

Re-expresses the reference's per-disk update pipeline
(src/storage/update/UpdateWorker.h:11-46: one bounded queue per disk,
32 fg + 8 bg threads): every storage target gets a bounded queue and a
dedicated worker thread; request threads enqueue whole write batches and
wait for their replies.

Two effects the inline path cannot give:

1. PIPELINING across batches — while one coalesced batch blocks in the
   forwarding RPC to the successor (GIL released), request threads keep
   staging new batches into the queue, so stage/forward/commit of
   successive batches overlap instead of serializing per request thread
   (round-3 verdict ask #3: write path trailed read ~13x).
2. GROUP COMMIT — the worker drains everything compatible (same chain,
   disjoint chunk sets, same traffic class) into ONE chain-batched
   operation: one native engine crossing to stage, one RPC per chain hop,
   one commit crossing, regardless of how many client requests arrived
   meanwhile.

QoS (tpu3fs/qos): the queue is a WeightedFairQueue — per-class FIFOs
drained by stride scheduling, so foreground writes outweigh
resync/EC-rebuild/migration/GC by their configured weights instead of
FIFO-racing them (the reference's 32-fg/8-bg split as an explicit
scheduler). A full queue (or a background class over its share) sheds
with the retryable ``Code.OVERLOADED`` carrying a retry-after hint.

Ordering: one worker per target, per-class FIFO order, and jobs that
touch an already-coalesced chunk are deferred to the next round — so for
client writes (all FG_WRITE) per-chunk update order is exactly the
arrival order, the property the reference gets from per-disk
serialization. Cross-class writes to one chunk (recovery installs) are
ordered by the engine's version algebra and are idempotent.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from tpu3fs_torch.analytics import spans as _spans
from tpu3fs_torch.qos.core import TrafficClass, format_retry_after
from tpu3fs_torch.qos.scheduler import WeightedFairQueue, WfqPolicy
from tpu3fs_torch.rpc import deadline as _deadline
from tpu3fs_torch.tenant import identity as _tenant_id
from tpu3fs_torch.utils.result import Code


# process-wide count of executed rounds — the observable seam that
# separates the two write paths in tests: writes served by the native
# C++ fast path never enqueue here, fallback/Python-served writes always
# do. Monotonic; read-compare around an operation (tests), never reset.
_ROUNDS_RUN = 0
_rounds_lock = threading.Lock()


def rounds_run() -> int:
    return _ROUNDS_RUN


class _Job:
    __slots__ = ("reqs", "replies", "done", "make_reply", "tclass",
                 "cost", "enq_ts", "sub_ts", "trace", "deadline",
                 "tenant")

    def __init__(self, reqs, make_reply, tclass):
        self.reqs = reqs
        self.make_reply = make_reply
        self.tclass = tclass
        self.cost = max(1, len(reqs))
        self.enq_ts = 0.0
        # submit time + the submitter's trace context: the queue-wait
        # stage span (time between submit and the round starting) is
        # attributed to the trace that experienced it
        self.sub_ts = time.monotonic()
        self.trace = _spans.current_trace()
        # the submitter's absolute deadline (rode the RPC envelope /
        # ambient context): checked again at ROUND START so work whose
        # caller gave up while it queued is shed, never executed
        self.deadline = _deadline.current_deadline()
        # the submitter's tenant picks the WFQ lane inside the class
        # (tpu3fs/tenant): two fg tenants share the class by weight
        self.tenant = _tenant_id.resolved_tenant()
        self.replies: Optional[list] = None
        self.done = threading.Event()


def _tenant_registry():
    from tpu3fs_torch.tenant.quota import registry

    return registry()


def _failure_replies(job: _Job, code: Code, msg: str,
                     retry_after_ms: int = 0) -> list:
    try:
        return [job.make_reply(code, msg, retry_after_ms)
                for _ in job.reqs]
    except TypeError:
        # legacy two-arg make_reply (tests, older callers): the hint
        # still rides the message
        return [job.make_reply(code, msg) for _ in job.reqs]


def _shed_replies(job: _Job, retry_after_ms: int) -> list:
    msg = format_retry_after(retry_after_ms, "update queue full")
    return _failure_replies(job, Code.OVERLOADED, msg, retry_after_ms)


class UpdateWorker:
    """Bounded weighted-fair queue of same-target write batches + one
    worker thread."""

    def __init__(
        self,
        runner: Callable[[list], list],
        *,
        queue_cap: int = 512,
        max_coalesce: int = 128,
        name: str = "",
        policy: Optional[WfqPolicy] = None,
    ):
        # runner: the service's _handle_batch_update bound to this target;
        # takes a same-chain, unique-chunk list of WriteReqs
        self._runner = runner
        self._max_coalesce = max_coalesce
        self._q = WeightedFairQueue(policy, cap=queue_cap)
        self._cond = threading.Condition()
        self._stopped = False
        # True while a round is executing (worker-side OR inline): the
        # idle-inline fast path below must never run concurrently with a
        # worker round, or per-target serialization breaks
        self._active = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"update-worker-{name}")
        self._thread.start()

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)

    def class_depths(self) -> dict:
        with self._cond:
            return dict(self._q.class_depths())

    @property
    def queue_cap(self) -> int:
        with self._cond:
            return self._q.cap

    def set_queue_cap(self, cap: int) -> None:
        """Resize the live queue (config push hot-update). Shrinking only
        caps NEW admits — try_push sheds while depth >= cap, and already-
        queued jobs drain normally, so no waiter is ever dropped."""
        with self._cond:
            self._q.cap = max(1, int(cap))

    def submit(self, reqs: list, make_reply,
               tclass: TrafficClass = TrafficClass.FG_WRITE) -> list:
        """Enqueue one same-chain batch; block until its replies are ready.
        make_reply(code, msg[, retry_after_ms]) builds the per-op failure
        reply (keeps this module free of the wire dataclasses).

        Idle-inline fast path: when nothing is queued and no round is in
        flight, the batch runs on the SUBMITTING thread — a cross-thread
        handoff costs a context switch per batch (~18% of batched-write
        wall measured on a loaded single-core host) and buys nothing at
        idle. FIFO order is preserved because inline only runs when the
        queue is empty; pipelining under load is preserved because
        concurrent submitters find _active set and enqueue as before."""
        if not reqs:
            return []
        job = _Job(reqs, make_reply, tclass)
        inline = False
        with self._cond:
            if self._stopped:
                return [make_reply(Code.RPC_PEER_CLOSED, "node stopped")
                        for _ in reqs]
            if not len(self._q) and not self._active:
                self._active = True
                inline = True
            else:
                # bounded weighted-fair queue: refuse with the retryable
                # OVERLOADED + retry-after hint (the client ladder backs
                # off for the hinted interval and retries), the QoS shape
                # of the reference's bounded per-disk queue behavior
                shed = self._q.try_push(job, tclass, job.tenant)
                if shed is not None:
                    return _shed_replies(job, shed)
                job.enq_ts = time.monotonic()
                self._cond.notify()
        if inline:
            try:
                self._run_round([job])
            finally:
                with self._cond:
                    self._active = False
                    self._cond.notify_all()
        else:
            job.done.wait()
        if job.replies is None:  # stopped mid-flight
            return [make_reply(Code.RPC_PEER_CLOSED, "node stopped")
                    for _ in reqs]
        return job.replies

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify()
        self._thread.join(timeout=5.0)
        # release any waiters that were still queued
        with self._cond:
            for job in self._q.drain():
                job.done.set()

    # -- worker ------------------------------------------------------------
    def _take_round(self) -> List[_Job]:
        """Pop the scheduler's next job plus every following job OF THE
        SAME CLASS that can share one chain-batched operation;
        incompatible jobs stay queued (per-class FIFO)."""
        with self._cond:
            # also park while an inline round is executing: two rounds on
            # one target may never overlap
            while self._active or (not len(self._q) and not self._stopped):
                if self._stopped and not len(self._q):
                    return []
                self._cond.wait()
            if self._stopped and not len(self._q):
                return []
            self._active = True
            popped = self._q.pop()
            assert popped is not None
            first, tclass = popped
            round_jobs = [first]
            chain_id = first.reqs[0].chain_id
            chunks = {r.chunk_id.to_bytes() for r in first.reqs}
            total = len(first.reqs)

            def _compatible(job: _Job) -> bool:
                keys = {r.chunk_id.to_bytes() for r in job.reqs}
                return (job.reqs[0].chain_id == chain_id
                        and not (keys & chunks))

            while total < self._max_coalesce:
                nxt = self._q.pop_matching(tclass, _compatible)
                if nxt is None:
                    break  # next round (preserves per-chunk FIFO order)
                round_jobs.append(nxt)
                chunks |= {r.chunk_id.to_bytes() for r in nxt.reqs}
                total += len(nxt.reqs)
            now = time.monotonic()
            policy = self._q.policy
            for job in round_jobs:
                if job.enq_ts:
                    wait = now - job.enq_ts
                    policy.record_wait(job.tclass, wait)
                    # per-tenant queue-wait attribution: the "who waited"
                    # axis of the fairness claim (tenant.queue_wait_us)
                    _tenant_registry().record_queue_wait(job.tenant, wait)
            return round_jobs

    def _run_round(self, round_jobs: List[_Job]) -> None:
        """Execute one coalesced round and distribute replies. Runs on the
        worker thread OR inline on a submitting thread (never both at
        once: _active guards)."""
        # DEQUEUE-TIME deadline shed: a job whose submitter's deadline
        # passed while it waited in the queue is answered (retryable)
        # DEADLINE_EXCEEDED here — expired work never reaches the engine
        # stage (the second shed point of rpc/deadline.py; the first is
        # RPC admission)
        now_w = time.time()
        live: List[_Job] = []
        for j in round_jobs:
            if j.deadline is not None and now_w > j.deadline:
                _deadline.record_shed("dequeue")
                j.replies = _failure_replies(
                    j, Code.DEADLINE_EXCEEDED,
                    "deadline passed in update queue")
                j.done.set()
            else:
                live.append(j)
        round_jobs = live
        if not round_jobs:
            return
        global _ROUNDS_RUN
        with _rounds_lock:
            _ROUNDS_RUN += 1
        reqs = [r for j in round_jobs for r in j.reqs]
        # trace plumbing: per-job queue-wait stage spans, then the round
        # executes under a round scope so the runner's stage/forward/
        # commit spans fan out to EVERY trace the round coalesced (and
        # chain-forward RPCs propagate the first)
        traces = []
        now_m = time.monotonic()
        for j in round_jobs:
            if j.trace is not None:
                traces.append(j.trace)
                wait = max(0.0, now_m - j.sub_ts)
                _spans.add_span(j.trace, "storage.update", "queue_wait",
                                time.time() - wait, wait)
        err = None
        try:
            # the round executes under the FIRST job's tenant (the rule
            # round_scope already applies to traces): chain-forward RPCs
            # issued from the worker thread re-propagate an owner instead
            # of degrading to "default" — receivers exempt chain-internal
            # hops from quota anyway, so this only affects attribution
            with _spans.round_scope(traces), \
                    _tenant_id.tenant_scope(round_jobs[0].tenant):
                outs = self._runner(reqs)
        except Exception as e:  # runner bug: report, don't wedge
            import logging

            logging.getLogger("tpu3fs.storage").exception(
                "update worker runner failed (%d reqs)", len(reqs))
            outs = None
            err = e
        pos = 0
        for j in round_jobs:
            n = len(j.reqs)
            if outs is not None and len(outs) >= pos + n:
                j.replies = outs[pos:pos + n]
            elif err is not None:
                j.replies = [
                    j.make_reply(Code.ENGINE_ERROR,
                                 f"update worker: {err!r}"[:200])
                    for _ in j.reqs]
            pos += n
            j.done.set()

    def _loop(self) -> None:
        while True:
            round_jobs = self._take_round()
            if not round_jobs:
                return
            try:
                self._run_round(round_jobs)
            finally:
                with self._cond:
                    self._active = False
                    self._cond.notify_all()
