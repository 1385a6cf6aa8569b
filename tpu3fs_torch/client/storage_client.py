"""Storage client: chain-aware writes, apportioned reads, retry ladders.

Re-expresses src/client/storage/StorageClientImpl.cc: writes go to the chain
HEAD with an exactly-once (client, channel, seqnum) identity reused across
retries (UpdateChannelAllocator.h:11-34); retries refresh routing on
chain-version bumps (batchWriteWithRetry :1771); reads pick any SERVING
target by a selection strategy (TargetSelection.h:29-46) and fail over to the
remaining replicas; batches group per node (groupOpsByNodeId :1030).

The port's own copy of ``tpu3fs/client/storage_client.py``. A
``StorageClient`` takes a ``device``: its stripe codec runs there
(``get_codec(k, m, S, device)``), so a batch's RS encode and CRCs, a
sub-stripe write's parity delta and a degraded read's decode are K1 and K2
launches on the card. Bytes still go in and come out as host buffers.
"""

from __future__ import annotations

import enum
import itertools
import random
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Tuple

from tpu3fs_torch.analytics import spans as _spans
from tpu3fs_torch.device import resolve_device
from tpu3fs_torch.mgmtd.types import ChainInfo, NodeType, PublicTargetState, RoutingInfo
from tpu3fs_torch.storage.craq import (
    Messenger,
    ReadReply,
    ReadReq,
    ShardWriteReq,
    UpdateReply,
    WriteReq,
)
from tpu3fs_torch.storage.types import ChunkId, SpaceInfo
from tpu3fs_torch.utils.result import Code, FsError, Status


# -- EC stripe version encoding ---------------------------------------------
# Stripe versions carry a WRITER NONCE in the low 32 bits and the logical
# version in the high bits: two concurrent writers racing the same logical
# version can otherwise stage DIFFERENT content under one version number
# on different shards, and a later commit / roll-forward would assemble a
# stripe of mixed payloads (found by tests/test_model_ec.py). With nonces,
# equal version => same writer => consistent shards; ordering still works
# (higher logical wins; ties break by nonce and the loser re-encodes).
EC_VER_SHIFT = 32


def ec_logical_ver(encoded: int) -> int:
    """Logical stripe version of an encoded (or legacy small) version."""
    return encoded >> EC_VER_SHIFT if encoded >= (1 << EC_VER_SHIFT) \
        else encoded


def _chain_encode_enabled() -> bool:
    """A/B lever for the pipelined chain encode (docs/ec.md): EC stripe
    batches ship RAW data shards down the encode-ordered chain and the
    hops accumulate the parity — the client's encode CPU drops to ~zero.
    Off by default (the client-side XOR-scheduled encode is the proven
    baseline); read per call so tests/benches/drives flip it live."""
    import os

    return os.environ.get("TPU3FS_EC_CHAIN_ENCODE", "0") == "1"


def _hint_ms(reply) -> int:
    """Server retry-after hint of a shed reply: the typed field when the
    reply carries one, else parsed from the envelope message."""
    ms = getattr(reply, "retry_after_ms", 0)
    if ms:
        return int(ms)
    from tpu3fs_torch.qos.core import retry_after_ms_of

    return retry_after_ms_of(getattr(reply, "message", "") or "")


class TargetSelectionMode(enum.Enum):
    """ref TargetSelection.h:29-46."""

    LOAD_BALANCE = "load_balance"   # random among serving (spreads load)
    ROUND_ROBIN = "round_robin"
    RANDOM = "random"
    HEAD = "head"
    TAIL = "tail"                   # strongest freshness (already committed)


class UpdateChannelAllocator:
    """Exclusive channel ids; a channel+seqnum names one logical update."""

    def __init__(self, capacity: int = 1024):
        self._free = list(range(1, capacity + 1))
        self._seq: Dict[int, int] = defaultdict(int)
        self._lock = threading.Lock()

    def acquire(self) -> Tuple[int, int]:
        with self._lock:
            if not self._free:
                raise FsError(Status(Code.CLIENT_NO_CHANNEL, "channel pool empty"))
            ch = self._free.pop()
            self._seq[ch] += 1
            return ch, self._seq[ch]

    def release(self, channel_id: int) -> None:
        with self._lock:
            self._free.append(channel_id)


@dataclass
class RetryOptions:
    """Retry / gray-failure defense knobs (docs/robustness.md)."""

    max_retries: int = 8
    backoff_base_s: float = 0.002
    backoff_max_s: float = 0.25
    # default per-op deadline budget armed at every public entry when the
    # caller has no ambient deadline; 0 = none. The ABSOLUTE deadline
    # rides every RPC envelope (rpc/deadline.py): servers shed expired
    # work, _sleep never sleeps past it, ladders stop at it.
    op_deadline_s: float = 0.0
    # hedged reads (client/hedging.py): arm a backup read to the next
    # replica after delay = max(floor, factor x per-peer latency EWMA);
    # hedges spend a token budget earning budget_ratio per primary, so
    # extra load stays <= ~budget_ratio
    hedge_reads: bool = True
    hedge_delay_floor_ms: float = 5.0
    hedge_delay_factor: float = 3.0
    hedge_budget_ratio: float = 0.05
    hedge_budget_burst: float = 16.0
    # per-peer health (rpc/health.py): demote suspect (breaker-open or
    # latency-outlier) nodes to the END of read replica order
    health_reorder: bool = True


class StorageClient:
    def __init__(
        self,
        client_id: str,
        routing_provider: Callable[[], RoutingInfo],
        messenger: Messenger,
        *,
        retry: Optional[RetryOptions] = None,
        selection: TargetSelectionMode = TargetSelectionMode.LOAD_BALANCE,
        seed: int = 0,
        device=None,
    ):
        self.client_id = client_id
        # the stripe codec's device: encode, parity deltas and degraded
        # decodes run there (K1 and K2 on the card)
        self.device = resolve_device(device)
        self._routing = routing_provider
        # TTL-cached providers (MgmtdRpcClient with routing_ttl_s) expose
        # an invalidation hook; retry ladders call it before re-resolving
        # so failover convergence never waits out the cache TTL
        owner = getattr(routing_provider, "__self__", None)
        self._routing_invalidate = (
            getattr(routing_provider, "invalidate", None)
            or getattr(owner, "invalidate_routing", None)
            or (lambda: None))
        self._messenger = messenger
        self._retry = retry or RetryOptions()
        self._selection = selection
        self._channels = UpdateChannelAllocator()
        self._rr = itertools.count()
        self._rng = random.Random(seed)
        self._pool = None  # lazy batch fan-out pool (multi-node batches)
        self._pool_mu = threading.Lock()
        self._pool_finalizer = None
        # EC data-plane health/throughput recorders (docs/ec.md)
        from tpu3fs_torch.monitor.recorder import (
            CounterRecorder,
            DistributionRecorder,
            ValueRecorder,
        )

        self._ec_degraded = CounterRecorder("ec.degraded_read")
        self._ec_degraded_ms = DistributionRecorder("ec.degraded_read_ms")
        # bytes of the OK shard replies the EC reads received, both rounds
        self._ec_read_shard_bytes = CounterRecorder("ec.read_shard_bytes")
        # degraded stripes whose survivors the card read from the pinned
        # staging (_pinned_rows); this thread's staging buffer
        self._ec_decode_pinned = CounterRecorder("ec.decode_pinned")
        self._pinned = threading.local()
        self._ec_parity_rmw = CounterRecorder("ec.parity_rmw")
        self._ec_rmw_fallback = CounterRecorder("ec.parity_rmw_fallback")
        self._ec_encode_gibps = ValueRecorder("ec.encode_gibps")
        # pipelined chain encode (TPU3FS_EC_CHAIN_ENCODE=1): stripes
        # staged through the chain relay vs stripes that fell back to the
        # client-side encode ladder
        self._ec_chain_stripes = CounterRecorder("ec.chain_encode_stripes")
        self._ec_chain_fallback = CounterRecorder("ec.chain_encode_fallback")
        # cumulative client-side encode CPU (seconds inside encode_parity
        # on the write path) — the offload the chain encode exists to
        # deliver; read by benchmarks/ec_bench.py, not a wire metric
        self.encode_cpu_s = 0.0
        # gray-failure defenses (docs/robustness.md): per-peer health —
        # the socket messenger shares its registry (its breaker also
        # fail-fasts writes); in-process messengers get a client-local one
        # fed by the timed reads below — plus the hedged-read controller
        # riding the same latency EWMAs
        from tpu3fs_torch.client.hedging import HedgeController
        from tpu3fs_torch.rpc.health import HealthRegistry

        self._health = getattr(messenger, "health", None)
        if self._health is None:
            self._health = HealthRegistry()
        r = self._retry
        self._hedge = HedgeController(
            budget_ratio=r.hedge_budget_ratio,
            burst=r.hedge_budget_burst,
            delay_floor_ms=r.hedge_delay_floor_ms,
            delay_factor=r.hedge_delay_factor,
            health=self._health)

    def close(self) -> None:
        """Release the fan-out pool's worker threads (a bounded join) and
        what the messenger holds for this client. Explicit close is best;
        a weakref finalizer backstops callers that churn clients without
        closing (per-client threads would accumulate in long-lived
        processes)."""
        with self._pool_mu:
            pool, self._pool = self._pool, None
            fin, self._pool_finalizer = self._pool_finalizer, None
        if fin is not None:
            fin.detach()
        if pool is not None:
            pool.shutdown(wait=True)
        # USRBIO shm rings ride the messenger (rpc/services.py): an
        # orderly client close deregisters them with the serving process
        # and unlinks the client-owned segments now, not at interpreter
        # exit (the atexit/reaper backstops cover unclean paths)
        close_rings = getattr(self._messenger, "close_rings", None)
        if close_rings is not None:
            try:
                close_rings()
            except Exception:
                pass

    # -- internals ----------------------------------------------------------
    def _fan_out(self, fn: Callable, items: List) -> None:
        """Issue per-node batch calls concurrently (ref StorageClientImpl
        launching one coroutine per node group, StorageClientImpl.cc:1303).
        Engages ONLY for messengers that declare `parallel_fanout` (the
        socket transports, where per-node RTT is real): an in-process
        direct dispatch completes in microseconds and the pool handoff
        would cost 5x the work itself (measured 21 -> 4 GiB/s on the
        fabric batch-read path)."""
        import os

        if (len(items) <= 1
                or not getattr(self._messenger, "parallel_fanout", False)
                or os.environ.get("TPU3FS_CLIENT_FANOUT", "1") == "0"):
            for item in items:
                fn(item)
            return
        with self._pool_mu:
            if self._pool is None:
                import weakref

                from tpu3fs_torch.utils.executor import WorkerPool

                self._pool = WorkerPool(f"client-{self.client_id}",
                                        num_workers=4, queue_cap=64)
                # reclaim worker threads when the client is GC'd without
                # close(); args hold the POOL (not self), so the finalizer
                # never keeps the client alive
                self._pool_finalizer = weakref.finalize(
                    self, WorkerPool.shutdown, self._pool, False)
            pool = self._pool
        pool.map(fn, items)
    def _chain(self, chain_id: int) -> ChainInfo:
        chain = self._routing().chains.get(chain_id)
        if chain is None:
            raise FsError(Status(Code.CHAIN_NOT_FOUND, str(chain_id)))
        return chain

    def next_stripe_ver(self, prev_encoded: int) -> int:
        """Public face of the encoded-version generator for callers doing
        read-modify-write (file_io): supersede what was read WITH a fresh
        writer nonce — hand-computing prev+1 would put concurrent RMWs on
        the identical encoded version and mix their shards."""
        return self._ec_next_ver(prev_encoded)

    def _ec_next_ver(self, prev_encoded: int) -> int:
        """Next encoded stripe version above prev: logical+1 in the
        high bits, a fresh writer nonce in the low 32 (see EC_VER_SHIFT).
        """
        import os

        # REAL entropy, not the client's seeded RNG: clients constructed
        # with the default seed would otherwise draw IDENTICAL nonces in
        # lockstep, recreating the same-version mixed-stripe corruption
        # the nonce exists to prevent
        return ((ec_logical_ver(prev_encoded) + 1) << EC_VER_SHIFT) | \
            int.from_bytes(os.urandom(4), "big")

    def _sleep(self, attempt: int, hint_ms: int = 0) -> None:
        """Backoff with FULL jitter: uniform(0, cap) where cap doubles per
        attempt — decorrelates a retry herd better than the old
        half-jitter (which never slept below cap/2, so herds re-collided
        at cap-ish). A server retry-after hint (an OVERLOADED shed,
        qos/core.py) REPLACES the exponential guess: the server knows its
        own refill horizon, so the client waits ~that (still jittered).
        NEVER sleeps past the ambient deadline — the remaining budget
        caps every delay (regression-tested in test_robustness)."""
        from tpu3fs_torch.rpc import deadline as _dl

        # a retry is about to re-resolve routing: a TTL-cached provider
        # must poll fresh (the chain may have moved under us)
        self._routing_invalidate()
        if hint_ms > 0:
            cap = min(self._retry.backoff_max_s * 4, hint_ms / 1000.0)
            delay = cap * (0.5 + self._rng.random() / 2)
        else:
            cap = min(
                self._retry.backoff_max_s,
                self._retry.backoff_base_s * (2 ** attempt))
            delay = cap * self._rng.random()
        left = _dl.remaining()
        if left is not None:
            delay = min(delay, max(0.0, left))
        if delay > 0:
            time.sleep(delay)

    def _op_scope(self):
        """Deadline scope for one public client op: the ambient deadline
        when the caller armed one, else RetryOptions.op_deadline_s (0 =
        none). The absolute deadline then rides every RPC this op issues."""
        import contextlib

        from tpu3fs_torch.rpc import deadline as _dl

        if self._retry.op_deadline_s > 0 and _dl.current_deadline() is None:
            return _dl.deadline_after(self._retry.op_deadline_s)
        return contextlib.nullcontext()

    @staticmethod
    def _deadline_expired() -> bool:
        from tpu3fs_torch.rpc import deadline as _dl

        return _dl.expired()

    # -- writes ---------------------------------------------------------------
    def write_chunk(
        self,
        chain_id: int,
        chunk_id: ChunkId,
        offset: int,
        data: bytes,
        *,
        chunk_size: int = 1 << 20,
        full_replace: bool = False,
    ) -> UpdateReply:
        """Write with the full retry ladder; exactly-once via channel identity."""
        with self._op_scope():
            return self._write_chunk_op(chain_id, chunk_id, offset, data,
                                        chunk_size=chunk_size,
                                        full_replace=full_replace)

    def _write_chunk_op(
        self,
        chain_id: int,
        chunk_id: ChunkId,
        offset: int,
        data: bytes,
        *,
        chunk_size: int = 1 << 20,
        full_replace: bool = False,
    ) -> UpdateReply:
        try:
            if self._chain(chain_id).is_ec:
                # a CRAQ write would install full-chunk bytes on shard-sized
                # targets and silently corrupt the stripe format
                raise FsError(Status(
                    Code.INVALID_ARG,
                    "CRAQ write on EC chain: use write_stripe"))
        except FsError as e:
            if e.code != Code.CHAIN_NOT_FOUND:
                raise
            return UpdateReply(e.code, message=e.status.message)
        channel, seq = self._channels.acquire()
        try:
            last: Optional[UpdateReply] = None
            for attempt in range(self._retry.max_retries + 1):
                try:
                    chain = self._chain(chain_id)
                except FsError as e:
                    return UpdateReply(e.code, message=e.status.message)
                head = chain.head()
                if head is None:
                    last = UpdateReply(Code.TARGET_OFFLINE, message="no head")
                    self._sleep(attempt)
                    continue
                node = self._routing().node_of_target(head.target_id)
                if node is None:
                    last = UpdateReply(Code.TARGET_NOT_FOUND, message="no head node")
                    self._sleep(attempt)
                    continue
                req = WriteReq(
                    chain_id=chain_id,
                    chain_ver=chain.chain_version,
                    chunk_id=chunk_id,
                    offset=offset,
                    data=data,
                    chunk_size=chunk_size,
                    client_id=self.client_id,
                    channel_id=channel,
                    seqnum=seq,
                    full_replace=full_replace,
                )
                try:
                    reply = self._messenger(node.node_id, "write", req)
                except FsError as e:
                    # envelope-level sheds (native gates, dispatch
                    # admission) carry their retry-after only in the
                    # message: keep it in the typed field, like reads do
                    from tpu3fs_torch.qos.core import retry_after_ms_of

                    reply = UpdateReply(
                        e.code, message=e.status.message,
                        retry_after_ms=retry_after_ms_of(e.status.message))
                if reply.ok:
                    return reply
                last = reply
                if self._deadline_expired():
                    return UpdateReply(Code.DEADLINE_EXCEEDED,
                                       message="op deadline exhausted")
                if Status(reply.code).retryable() or reply.code in (
                    Code.NOT_HEAD,
                    Code.RPC_PEER_CLOSED,
                ):
                    self._sleep(attempt, _hint_ms(reply))
                    continue
                return reply
            return last or UpdateReply(Code.CLIENT_RETRIES_EXHAUSTED)
        finally:
            self._channels.release(channel)

    # -- reads ----------------------------------------------------------------
    def _pick_targets(self, chain: ChainInfo) -> List[int]:
        serving = [
            t.target_id
            for t in chain.targets
            if t.public_state == PublicTargetState.SERVING
        ]
        if not serving:
            return []
        mode = self._selection
        if mode == TargetSelectionMode.HEAD:
            order = serving
        elif mode == TargetSelectionMode.TAIL:
            order = serving[::-1]
        elif mode == TargetSelectionMode.ROUND_ROBIN:
            k = next(self._rr) % len(serving)
            order = serving[k:] + serving[:k]
        else:  # LOAD_BALANCE / RANDOM
            order = list(serving)
            self._rng.shuffle(order)
        # gray-node demotion: SUSPECT peers (breaker not closed, or a
        # latency-EWMA outlier) sort to the END — a sick replica is
        # routed around within milliseconds of the first slow/failed
        # observation instead of after a 60s heartbeat timeout. Stable:
        # the selection mode's order is preserved within each class.
        if self._retry.health_reorder and len(order) > 1:
            routing = self._routing()

            def _suspect(tid: int) -> bool:
                node = routing.node_of_target(tid)
                return (node is not None
                        and self._health.suspect(node.node_id))

            order.sort(key=_suspect)
        return order

    def _timed_read(self, node_id: int, req: ReadReq) -> ReadReply:
        """One messenger read with latency fed to the health EWMA (the
        hedge-delay / gray-demotion signal). Transport errors come back
        as replies (the ladder's existing shape)."""
        t0 = time.monotonic()
        try:
            reply = self._messenger(node_id, "read", req)
        except FsError as e:
            if e.code in (Code.RPC_CONNECT_FAILED, Code.RPC_PEER_CLOSED,
                          Code.RPC_TIMEOUT, Code.PEER_UNHEALTHY):
                self._health.observe(node_id, 0.0, ok=False)
            # envelope-level sheds (native gates, dispatch admission)
            # carry their retry-after only in the message: keep it in the
            # typed field so ladders wait it out instead of hammering
            from tpu3fs_torch.qos.core import retry_after_ms_of

            return ReadReply(e.code, retry_after_ms=retry_after_ms_of(
                e.status.message))
        self._health.observe(node_id, time.monotonic() - t0, ok=True)
        return reply

    def read_chunk(
        self,
        chain_id: int,
        chunk_id: ChunkId,
        offset: int = 0,
        length: int = -1,
    ) -> ReadReply:
        with self._op_scope():
            return self._read_chunk_op(chain_id, chunk_id, offset, length)

    def _read_chunk_op(
        self,
        chain_id: int,
        chunk_id: ChunkId,
        offset: int = 0,
        length: int = -1,
    ) -> ReadReply:
        from tpu3fs_torch.client.hedging import run_hedged

        last = ReadReply(Code.TARGET_NOT_FOUND)
        for attempt in range(self._retry.max_retries + 1):
            if self._deadline_expired():
                return ReadReply(Code.DEADLINE_EXCEEDED)
            try:
                chain = self._chain(chain_id)
            except FsError as e:
                return ReadReply(e.code)
            targets = self._pick_targets(chain)
            routing = self._routing()
            resolved = [(t, routing.node_of_target(t)) for t in targets]
            resolved = [(t, n) for t, n in resolved if n is not None]

            def _attempt(pair):
                t, n = pair
                return self._timed_read(
                    n.node_id,
                    ReadReq(chain_id, chunk_id, offset, length, t))

            def _good(r) -> bool:
                return r.ok or r.code == Code.CHUNK_NOT_FOUND

            # failover walk with hedging at EVERY step: CRAQ committed
            # reads may be served by any replica, so each attempt arms a
            # backup to the NEXT replica after the adaptive delay and the
            # first good reply wins (client/hedging.py — budgeted,
            # idempotent-only). A straggler encountered mid-failover is
            # rescued exactly like one hit first.
            hedging = self._retry.hedge_reads and not chain.is_ec
            i = 0
            while i < len(resolved):
                primary = resolved[i]
                backup = (resolved[i + 1]
                          if hedging and i + 1 < len(resolved) else None)
                if backup is None:
                    self._hedge.note_primary()
                    reply = _attempt(primary)
                    i += 1
                else:
                    reply, hedged, _backup_won = run_hedged(
                        lambda p=primary: _attempt(p),
                        lambda b=backup: _attempt(b),
                        self._hedge.delay_s(primary[1].node_id),
                        self._hedge, good=_good)
                    i += 2 if hedged else 1
                if _good(reply):
                    return reply
                last = reply
            if self._deadline_expired():
                return ReadReply(Code.DEADLINE_EXCEEDED)
            if last.code in (Code.CHUNK_NOT_COMMIT,) or Status(last.code).retryable():
                self._sleep(attempt, _hint_ms(last))
                continue
            return last
        return last

    def batch_read(
        self, reqs: List[ReadReq]
    ) -> List[ReadReply]:
        """Traced entry: see _batch_read_op. The root span head-samples a
        trace when none is active (tpu3fs/analytics/spans.py); sampled or
        slow ops capture their whole cross-process stage breakdown."""
        with _spans.root_span("client.batch_read"), self._op_scope():
            return self._batch_read_op(reqs, joined=True)

    def batch_read_parts(
        self, reqs: List[ReadReq]
    ) -> List[ReadReply]:
        """batch_read for FileIoClient's assembly: an EC reply's ``data``
        is its range as a list of buffers in file order (see
        _range_data), which the caller's one join copies; every other
        reply is batch_read's."""
        with _spans.root_span("client.batch_read"), self._op_scope():
            return self._batch_read_op(reqs, joined=False)

    def _batch_read_op(
        self, reqs: List[ReadReq], joined: bool
    ) -> List[ReadReply]:
        """Group per node (ref groupOpsByNodeId) then issue node batches.

        EC requests ride the SAME node-grouped striped fan-out as the CR
        ops: their covering shard reads interleave into the per-node
        batches (one wire round trip for the whole mixed batch), and a
        stripe whose direct shards fail — dead target, missing shard,
        version skew — goes DEGRADED inline: the surviving shards of
        every degraded stripe are fetched in one more batched round and
        decoded client-side (any k of k+m), with ec.degraded_read /
        ec.degraded_read_ms recording the detour."""
        routing = self._routing()
        replies: List[Optional[ReadReply]] = [None] * len(reqs)
        wire: List[Tuple[int, ReadReq]] = []   # (node_id, wire op)
        tags: List[Tuple] = []                 # ("cr", i) | ("ec", i, j)
        ec_specs: Dict[int, dict] = {}
        for i, req in enumerate(reqs):
            chain = routing.chains.get(req.chain_id)
            if chain is None:
                replies[i] = ReadReply(Code.CHAIN_NOT_FOUND)
                continue
            if chain.is_ec:
                # EC reads are shard-addressed, not replica-selected; the
                # shard size derives from the file's chunk_size, so a
                # request without one cannot be served correctly — reject
                # loudly instead of slicing at a guessed size
                if not req.chunk_size:
                    replies[i] = ReadReply(Code.INVALID_ARG)
                    continue
                spec = self._plan_stripe_read(chain, routing, req)
                if spec["length"] == 0:
                    replies[i] = ReadReply(Code.OK, data=b"")
                    continue
                ec_specs[i] = spec
                for j, (node_id, rr) in spec["wire"].items():
                    tags.append(("ec", i, j))
                    wire.append((node_id, rr))
                continue
            targets = self._pick_targets(chain)
            if not targets:
                replies[i] = ReadReply(Code.TARGET_OFFLINE)
                continue
            target_id = req.target_id or targets[0]
            node = routing.node_of_target(target_id)
            if node is None:
                replies[i] = ReadReply(Code.TARGET_NOT_FOUND)
                continue
            tags.append(("cr", i))
            wire.append((node.node_id, ReadReq(
                req.chain_id, req.chunk_id, req.offset, req.length, target_id
            )))
        with _spans.span("client.batch_read", "fetch"):
            wire_replies = self._issue_wire_reads(wire)
        shard_replies: Dict[int, Dict[int, ReadReply]] = {
            i: {} for i in ec_specs}
        for tag, r in zip(tags, wire_replies):
            if tag[0] == "cr":
                replies[tag[1]] = r
            else:
                shard_replies[tag[1]][tag[2]] = r
        self._count_shard_bytes(
            r for tag, r in zip(tags, wire_replies) if tag[0] == "ec")
        if ec_specs:
            self._finish_stripe_reads(
                reqs, replies, ec_specs, shard_replies, routing, joined)
        # fall back to the single-op retry ladder for failures (EC replies
        # already went through the degraded decode / read_stripe ladder)
        for i, r in enumerate(replies):
            if r is None or (not r.ok and r.code != Code.CHUNK_NOT_FOUND):
                chain = routing.chains.get(reqs[i].chain_id)
                if chain is not None and chain.is_ec:
                    continue
                replies[i] = self.read_chunk(
                    reqs[i].chain_id, reqs[i].chunk_id, reqs[i].offset, reqs[i].length
                )
        return replies  # type: ignore[return-value]

    def _issue_wire_reads(
        self, wire: List[Tuple[int, ReadReq]]
    ) -> List[ReadReply]:
        """Issue already-planned (node_id, op) reads grouped per node —
        striped multi-connection fan-out with pipelined issue when the
        messenger supports it: every node group's stripes go on the wire
        BEFORE any reply is collected, each on its own pooled connection,
        so wall clock is the slowest stripe, not the sum (socket
        messengers only; the in-process fabric keeps direct dispatch via
        the pool fan-out). -> replies aligned with `wire`."""
        replies: List[Optional[ReadReply]] = [None] * len(wire)
        by_node: Dict[int, List[int]] = defaultdict(list)
        for w, (node_id, _) in enumerate(wire):
            by_node[node_id].append(w)
        items = list(by_node.items())
        pipelined = getattr(self._messenger, "batch_read_pipelined", None)
        if pipelined is not None and items:
            groups = [(node_id, [wire[w][1] for w in idxs])
                      for node_id, idxs in items]
            for (node_id, idxs), got in zip(items, pipelined(groups)):
                for w, reply in zip(idxs, got):
                    replies[w] = reply
        else:
            from tpu3fs_torch.client.hedging import run_hedged

            routing = self._routing()

            def _call_group(node_id, ops) -> List[ReadReply]:
                t0 = time.monotonic()
                try:
                    got = list(self._messenger(node_id, "batch_read", ops))
                except FsError as e:
                    if e.code in (Code.RPC_CONNECT_FAILED,
                                  Code.RPC_PEER_CLOSED, Code.RPC_TIMEOUT,
                                  Code.PEER_UNHEALTHY):
                        self._health.observe(node_id, 0.0, ok=False)
                    return [ReadReply(e.code)] * len(ops)
                self._health.observe(node_id, time.monotonic() - t0,
                                     ok=True)
                got += [ReadReply(Code.RPC_PEER_CLOSED)] * (
                    len(ops) - len(got))
                return got[:len(ops)]

            def _group_good(rs) -> bool:
                return any(r.ok or r.code == Code.CHUNK_NOT_FOUND
                           for r in rs)

            def _issue_read(item) -> None:
                # ONE BatchRead request per node (ref sendBatchRequest
                # StorageClientImpl.cc:1303): the round trip is amortized
                # over the whole group. When every op in the group has a
                # serving replica on ANOTHER node, the group is hedge-
                # eligible: a backup batch to the alternates arms after
                # the adaptive delay and the first useful reply set wins.
                node_id, idxs = item
                ops = [wire[w][1] for w in idxs]
                backup = (self._plan_group_backup(routing, ops, node_id)
                          if self._retry.hedge_reads else None)
                if backup is None:
                    self._hedge.note_primary()
                    got = _call_group(node_id, ops)
                else:
                    got, _hedged, _won = run_hedged(
                        lambda: _call_group(node_id, ops), backup,
                        self._hedge.delay_s(node_id), self._hedge,
                        good=_group_good)
                for w, reply in zip(idxs, got):
                    replies[w] = reply

            self._fan_out(_issue_read, items)
        for w, r in enumerate(replies):
            if r is None:  # short reply list from a confused server
                replies[w] = ReadReply(Code.RPC_PEER_CLOSED)
        return replies  # type: ignore[return-value]

    def _plan_group_backup(self, routing, ops: List[ReadReq],
                           primary_node: int):
        """Backup thunk for one hedged batch-read group, or None when any
        op lacks a serving replica on a DIFFERENT node (hedging to the
        same sick node buys nothing). CR ops only — EC shard reads are
        shard-addressed, each shard has exactly one home."""
        alts: List[Tuple[int, ReadReq]] = []
        for op in ops:
            chain = routing.chains.get(op.chain_id)
            if chain is None or chain.is_ec:
                return None
            alt = None
            for t in chain.targets:
                if (t.public_state == PublicTargetState.SERVING
                        and t.target_id != op.target_id):
                    node = routing.node_of_target(t.target_id)
                    if node is not None and node.node_id != primary_node:
                        alt = (node.node_id,
                               replace(op, target_id=t.target_id))
                        break
            if alt is None:
                return None
            alts.append(alt)

        def _backup() -> List[ReadReply]:
            out: List[Optional[ReadReply]] = [None] * len(alts)
            by_n: Dict[int, List[int]] = defaultdict(list)
            for i, (n, _a) in enumerate(alts):
                by_n[n].append(i)
            for n, iidx in by_n.items():
                try:
                    got = self._messenger(
                        n, "batch_read", [alts[i][1] for i in iidx])
                except FsError as e:
                    got = [ReadReply(e.code)] * len(iidx)
                for i, r in zip(iidx, got):
                    out[i] = r
            return [r if r is not None else ReadReply(Code.RPC_PEER_CLOSED)
                    for r in out]

        return _backup

    def batch_write(
        self,
        writes: List[Tuple[int, ChunkId, int, bytes]],
        *,
        chunk_size: int = 1 << 20,
        op_crcs: Optional[List[Optional[int]]] = None,
        full_replace: bool = False,
    ) -> List[UpdateReply]:
        """Traced entry: see _batch_write_op. The root span is the
        client-observed latency the trace assembler's stage coverage is
        measured against (docs/observability.md)."""
        with _spans.root_span(
                "client.batch_write",
                nbytes=sum(len(w[3]) for w in writes)), self._op_scope():
            return self._batch_write_op(writes, chunk_size=chunk_size,
                                        op_crcs=op_crcs,
                                        full_replace=full_replace)

    def _batch_write_op(
        self,
        writes: List[Tuple[int, ChunkId, int, bytes]],
        *,
        chunk_size: int = 1 << 20,
        op_crcs: Optional[List[Optional[int]]] = None,
        full_replace: bool = False,
    ) -> List[UpdateReply]:
        """Batched CRAQ writes: (chain_id, chunk_id, offset, data) ops are
        grouped by head node and issued as ONE BatchWrite per node (ref
        batchWriteWithRetry StorageClientImpl.cc:1771). Failed ops fall back
        to the single-op retry ladder.

        ``op_crcs`` (aligned with ``writes``) carries content CRC32Cs the
        caller already computed over these very buffers. They ride as
        WriteReq.trusted_crc ONLY when the messenger direct-dispatches in
        this process (the fabric) — the head then installs without a CRC
        recompute and hands the whole chain ONE checksum pass. Socket
        messengers ignore them: anything that crosses a wire gets
        re-verified server-side."""
        replies: List[Optional[UpdateReply]] = [None] * len(writes)
        routing = self._routing()
        by_node: Dict[int, List[int]] = defaultdict(list)
        reqs: List[Optional[WriteReq]] = [None] * len(writes)
        channels: List[Optional[Tuple[int, int]]] = [None] * len(writes)
        trusted = op_crcs is not None and bool(
            getattr(self._messenger, "in_process", False)
            or getattr(getattr(self._messenger, "__self__", None),
                       "in_process", False))
        try:
            for i, (chain_id, chunk_id, offset, data) in enumerate(writes):
                chain = routing.chains.get(chain_id)
                if chain is not None and chain.is_ec:
                    replies[i] = UpdateReply(
                        Code.INVALID_ARG,
                        message="CRAQ batch_write on EC chain: use write_stripes")
                    continue
                head = chain.head() if chain is not None else None
                node = (routing.node_of_target(head.target_id)
                        if head is not None else None)
                if chain is None or head is None or node is None:
                    replies[i] = UpdateReply(Code.TARGET_OFFLINE)
                    continue
                ch, seq = self._channels.acquire()
                channels[i] = (ch, seq)
                reqs[i] = WriteReq(
                    chain_id=chain_id,
                    chain_ver=chain.chain_version,
                    chunk_id=chunk_id,
                    offset=offset,
                    data=data,
                    chunk_size=chunk_size,
                    client_id=self.client_id,
                    channel_id=ch,
                    seqnum=seq,
                    full_replace=full_replace,
                    trusted_crc=(op_crcs[i] if trusted
                                 and op_crcs[i] is not None else -1),
                )
                by_node[node.node_id].append(i)

            items = list(by_node.items())
            pipelined = getattr(self._messenger, "batch_write_pipelined",
                                None)
            if pipelined is not None and items and getattr(
                    self._messenger, "write_pipelined", True):
                # striped multi-connection fan-out with pipelined issue:
                # every node group's stripes (bulk frames gathered straight
                # from the caller's buffers) go on the wire BEFORE any
                # reply is collected — the server overlaps engine staging
                # and chain forwarding of one stripe with the upload of
                # the next (socket messengers only; the in-process fabric
                # keeps direct dispatch below)
                groups = [(node_id, [reqs[i] for i in idxs])
                          for node_id, idxs in items]
                for (node_id, idxs), got in zip(items, pipelined(groups)):
                    for i, reply in zip(idxs, got):
                        replies[i] = reply
            else:
                def _issue_write(item) -> None:
                    node_id, idxs = item
                    try:
                        got = self._messenger(
                            node_id, "batch_write", [reqs[i] for i in idxs])
                        for i, reply in zip(idxs, got):
                            replies[i] = reply
                    except FsError as e:
                        for i in idxs:
                            replies[i] = UpdateReply(e.code)

                self._fan_out(_issue_write, items)
        finally:
            for slot in channels:
                if slot is not None:
                    self._channels.release(slot[0])
        # single-op ladder mops up failures (chain bumps, dead heads);
        # hard rejections (EC misuse) are final
        for i, r in enumerate(replies):
            if r is None or (not r.ok and r.code != Code.INVALID_ARG):
                chain_id, chunk_id, offset, data = writes[i]
                replies[i] = self.write_chunk(
                    chain_id, chunk_id, offset, data, chunk_size=chunk_size,
                    full_replace=full_replace)
        return replies  # type: ignore[return-value]

    # -- EC stripes (the device data plane; added capability) ----------------
    def write_stripe(
        self,
        chain_id: int,
        chunk_id: ChunkId,
        data: bytes,
        *,
        chunk_size: int = 1 << 20,
        update_ver: int = 0,
    ) -> UpdateReply:
        """Erasure-code one chunk into k data + m parity shards on device
        (RSCode encode + BatchCrc32c on the client's device) and install each shard
        on its chain-position target. update_ver=0 probes: try 1, bump past
        any newer committed stripe on conflict."""
        from tpu3fs_torch.ops.stripe import get_codec, shard_size_of

        chain = self._chain(chain_id)
        if not chain.is_ec:
            raise FsError(Status(Code.INVALID_ARG, "write_stripe on CR chain"))
        if len(data) > chunk_size:
            raise FsError(Status(Code.INVALID_ARG, "stripe exceeds chunk size"))
        k, m = chain.ec_k, chain.ec_m
        S = shard_size_of(chunk_size, k)
        codec = get_codec(k, m, S, self.device)
        t_enc = time.monotonic()
        shards, crcs = codec.encode_stripe(data)
        self.encode_cpu_s += time.monotonic() - t_enc
        ver = update_ver or self._ec_next_ver(0)
        last: Optional[UpdateReply] = None
        done: set = set()     # shard indices STAGED at `ver`
        landed: set = set()   # shard indices COMMITTED at `ver`
        for attempt in range(self._retry.max_retries + 1):
            if attempt and self._deadline_expired():
                return UpdateReply(Code.DEADLINE_EXCEEDED,
                                   message="op deadline exhausted")
            chain = self._chain(chain_id)
            routing = self._routing()
            writable = 0
            acked = 0
            bump_to = 0
            hard: Optional[UpdateReply] = None
            for j in range(k + m):
                t = chain.target_of_shard(j)
                if t is None or not t.public_state.can_write:
                    continue  # non-writable targets rebuild before SERVING
                writable += 1
                if j in done:
                    acked += 1
                    continue
                node = routing.node_of_target(t.target_id)
                if node is None:
                    continue
                # data shards ship the trimmed host bytes; parity ships the
                # device-encoded rows (always full S). The wire CRC covers
                # the STORED (trimmed) bytes, so the server validates with
                # the one CRC pass its engine does during staging
                if j < k:
                    payload = data[j * S : (j + 1) * S]
                else:
                    payload = shards[j].tobytes()
                crc = (int(crcs[j]) if len(payload) == S
                       else codec.crc_host(payload))
                req = ShardWriteReq(
                    chain_id=chain_id,
                    chain_ver=chain.chain_version,
                    target_id=t.target_id,
                    chunk_id=chunk_id,
                    data=payload,
                    crc=crc,
                    update_ver=ver,
                    chunk_size=S,
                    logical_len=len(data),
                    phase=1,  # STAGE: the committed stripe survives failure
                )
                try:
                    reply = self._messenger(node.node_id, "write_shard", req)
                except FsError as e:
                    reply = UpdateReply(e.code, message=e.status.message)
                if reply.ok:
                    acked += 1
                    done.add(j)
                elif reply.code in (Code.CHUNK_STALE_UPDATE,
                                    Code.CHUNK_ADVANCE_UPDATE):
                    # STALE: a newer COMMITTED stripe exists — re-write
                    # above it (whole-stripe versioning, fresh nonce).
                    # ADVANCE: an ABANDONED pending (e.g. an aborted
                    # chain-encode relay or a crashed writer) sits above
                    # our version with the same logical number — bumping
                    # the logical version clears it (staging displaces
                    # older pendings), where retrying the same ver would
                    # wedge forever on the orphan.
                    bump_to = max(
                        bump_to,
                        self._ec_next_ver(max(reply.commit_ver, ver)))
                elif Status(reply.code).retryable() or reply.code in (
                    Code.RPC_PEER_CLOSED, Code.RPC_CONNECT_FAILED,
                ):
                    last = reply
                else:
                    hard = reply
            if hard is not None:
                return hard
            if bump_to:
                ver = bump_to
                done.clear()  # everything must be re-staged at the new ver
                landed.clear()
                self._sleep(attempt)
                continue
            # STRICT staging: every currently-writable shard staged (and at
            # least k overall, or the stripe would be undecodable). Only
            # then does phase 2 COMMIT — the first point where the old
            # version is destroyed, and by then every writable shard holds
            # the new content as pending. A partial commit (node dies
            # mid-round) is finished by the rebuilder's roll-forward.
            if acked == writable and acked >= k:
                # snapshot of the fully-staged shard set: commits must land
                # on EVERY one of these. A CHUNK_MISSING_UPDATE discard
                # shrinks `done` for re-staging — the ack below compares
                # against this snapshot so a shrunken set can never ack
                # with fewer than the full writable coverage (review: ack
                # with < k commits after displaced pendings).
                full = set(done)
                for j in sorted(done - landed):
                    t = chain.target_of_shard(j)
                    node = (routing.node_of_target(t.target_id)
                            if t is not None else None)
                    if node is None:
                        continue
                    creq = ShardWriteReq(
                        chain_id=chain_id,
                        chain_ver=chain.chain_version,
                        target_id=t.target_id,
                        chunk_id=chunk_id,
                        data=b"",
                        crc=0,
                        update_ver=ver,
                        chunk_size=S,
                        logical_len=len(data),
                        phase=2,
                    )
                    try:
                        r2 = self._messenger(node.node_id, "write_shard",
                                             creq)
                    except FsError as e:
                        r2 = UpdateReply(e.code, message=e.status.message)
                    if r2.ok:
                        landed.add(j)
                    elif r2.code == Code.CHUNK_MISSING_UPDATE:
                        # our pending was displaced (e.g. by a concurrent
                        # writer's stage): re-STAGE this shard next attempt
                        # instead of re-sending a commit that cannot land
                        done.discard(j)
                if landed >= full:
                    return UpdateReply(Code.OK, update_ver=ver,
                                       commit_ver=ver)
                last = UpdateReply(
                    Code.TARGET_OFFLINE,
                    message=f"{len(landed)}/{len(full)} commits acked")
                self._sleep(attempt)
                continue
            last = last or UpdateReply(
                Code.TARGET_OFFLINE,
                message=f"{acked}/{writable} writable shards acked")
            self._sleep(attempt, _hint_ms(last))
        return last or UpdateReply(Code.CLIENT_RETRIES_EXHAUSTED)

    def _send_shard_batches(self, by_node) -> List[Tuple[int, object]]:
        """One batch_write_shard per node — striped + pipelined across
        pooled connections when the messenger supports it (socket
        transports), thread-pool fan-out otherwise; -> merged
        [(stripe index, reply)] collected after the barrier (list.append
        is atomic; the CALLER merges counters single-threaded to avoid
        lost-update races on shared indices)."""
        events: List[Tuple[int, object]] = []
        items = list(by_node.items())
        pipelined = getattr(self._messenger, "batch_write_pipelined", None)
        if pipelined is not None and items and getattr(
                self._messenger, "write_pipelined", True):
            groups = [(node_id, [r for _, r in group])
                      for node_id, group in items]
            for (node_id, group), got in zip(
                    items, pipelined(groups, method="batch_write_shard")):
                for (b, _), reply in zip(group, got):
                    events.append((b, reply))
            return events

        def _send(item) -> None:
            node_id, group = item
            try:
                got = self._messenger(
                    node_id, "batch_write_shard", [r for _, r in group])
            except FsError:
                return
            for (b, _), reply in zip(group, got):
                events.append((b, reply))

        self._fan_out(_send, items)
        return events

    def write_stripes(
        self,
        chain_id: int,
        items: List[Tuple[ChunkId, bytes]],
        *,
        chunk_size: int = 1 << 20,
    ) -> List[UpdateReply]:
        """Traced entry: see _write_stripes_op."""
        with _spans.root_span("client.write_stripes",
                              nbytes=sum(len(d) for _, d in items)), \
                self._op_scope():
            return self._write_stripes_op(chain_id, items,
                                          chunk_size=chunk_size)

    def _write_stripes_op(
        self,
        chain_id: int,
        items: List[Tuple[ChunkId, bytes]],
        *,
        chunk_size: int = 1 << 20,
    ) -> List[UpdateReply]:
        """Batched EC writes: encode MANY stripes with ONE device kernel
        launch (amortizing the host-device round trip — the whole point of
        the device data plane) and install shards with one BatchShardWrite per node.
        Overwrites are handled by probing the current stripe versions with
        ONE statChunks RPC up front (shard 0's target holds every stripe of
        the chain), so rewriting existing stripes stays on the batch path;
        stripes that still conflict fall back to write_stripe."""
        import numpy as np

        from tpu3fs_torch.ops.stripe import get_codec, shard_size_of

        chain = self._chain(chain_id)
        if not chain.is_ec:
            raise FsError(Status(Code.INVALID_ARG, "write_stripes on CR chain"))
        k, m = chain.ec_k, chain.ec_m
        S = shard_size_of(chunk_size, k)
        codec = get_codec(k, m, S, self.device)
        B = len(items)
        if B == 0:
            return []
        routing = self._routing()
        # one-RPC version probe: max committed over probed shards is the
        # floor for this batch's stripe versions (a later shard write may
        # still be ahead — that stripe falls to the per-stripe ladder)
        vers = [self._ec_next_ver(0)] * B
        t0 = chain.target_of_shard(0)
        if t0 is not None:
            node0 = routing.node_of_target(t0.target_id)
            if node0 is not None:
                try:
                    stats = self._messenger(
                        node0.node_id, "stat_chunks",
                        (t0.target_id, [cid for cid, _ in items]))
                    vers = [self._ec_next_ver(int(st[0]))
                            for st in stats]
                except FsError:
                    pass  # probe is an optimization; conflicts still ladder
        if _chain_encode_enabled():
            # pipelined chain encode: ship RAW data shards down the
            # encode-ordered chain — the hops compute the parity
            # (docs/ec.md "Pipelined chain encode"); None = plan not
            # viable / relay aborted before staging -> client encode
            out = self._write_stripes_chain(chain, routing, items, vers,
                                            S, chunk_size)
            if out is not None:
                return out
        buf = np.zeros((B, k, S), dtype=np.uint8)  # copy-ok: device encode input
        for b, (_, data) in enumerate(items):
            flat = np.frombuffer(data, dtype=np.uint8)
            buf[b].reshape(-1)[: flat.size] = flat
        # parity-only encode: data-shard payloads below are slices of the
        # caller's bytes, so materializing a concatenated (B, k+m, S)
        # array would be a multi-MiB copy per batch for nothing
        t_enc = time.monotonic()
        parity, crcs = codec.encode_parity(buf)
        dt_enc = time.monotonic() - t_enc
        self.encode_cpu_s += dt_enc
        if dt_enc > 0:
            self._ec_encode_gibps.set(B * k * S / dt_enc / (1 << 30))
        by_node: Dict[int, List[Tuple[int, ShardWriteReq]]] = defaultdict(list)
        acked = [0] * B
        hard: List[Optional[UpdateReply]] = [None] * B
        writable = 0
        for j in range(k + m):
            t = chain.target_of_shard(j)
            if t is None or not t.public_state.can_write:
                continue
            writable += 1
            node = routing.node_of_target(t.target_id)
            if node is None:
                continue
            for b, (cid, data) in enumerate(items):
                # shard payloads are VIEWS of the caller's stripe bytes /
                # the encoded parity rows — the bulk frame gathers them
                # straight into the socket, no per-shard slice copies
                payload = (memoryview(data)[j * S : (j + 1) * S] if j < k
                           else memoryview(parity[b, j - k]))
                crc = (int(crcs[b, j]) if len(payload) == S
                       else codec.crc_host(payload))
                by_node[node.node_id].append((b, ShardWriteReq(
                    chain_id=chain_id,
                    chain_ver=chain.chain_version,
                    target_id=t.target_id,
                    chunk_id=cid,
                    data=payload,
                    crc=crc,
                    update_ver=vers[b],
                    chunk_size=S,
                    logical_len=len(data),
                    phase=1,  # STAGE: committed stripe survives a failure
                )))
        # -- phase 1: stage every shard (pending only) -----------------------
        # merge AFTER the _send_shard_batches barrier: `acked[b] += 1`
        # from concurrent node threads would be a lost-update race
        for b, reply in self._send_shard_batches(by_node):
            if reply.ok:
                acked[b] += 1
            elif reply.code == Code.CHUNK_STALE_UPDATE:
                hard[b] = reply
        # -- phase 2: commit fully-staged stripes ----------------------------
        # an overwrite only destroys the previous version HERE, and only
        # for stripes whose every writable shard holds the staged content;
        # a partial commit is completed by the rebuilder's roll-forward
        # (committed+pending >= k at the staged version)
        committed = [0] * B
        commit_by_node: Dict[int, List[Tuple[int, ShardWriteReq]]] = (
            defaultdict(list))
        full_staged = {b for b in range(B)
                       if acked[b] == writable and acked[b] >= k
                       and hard[b] is None}
        for node_id, group in by_node.items():
            for b, r in group:
                if b in full_staged:
                    commit_by_node[node_id].append((b, replace(
                        r, data=b"", crc=0, phase=2)))
        for b, reply in self._send_shard_batches(commit_by_node):
            if reply.ok:
                committed[b] += 1
        out: List[UpdateReply] = []
        for b, (cid, data) in enumerate(items):
            # strict rule: every writable shard staged AND committed
            if b in full_staged and committed[b] == acked[b]:
                out.append(UpdateReply(
                    Code.OK, update_ver=vers[b], commit_ver=vers[b]))
            else:
                # conflict or partial: the single-stripe ladder re-probes
                out.append(self.write_stripe(
                    chain_id, cid, data, chunk_size=chunk_size,
                    update_ver=vers[b]))
        return out

    def _write_stripes_chain(
        self,
        chain: ChainInfo,
        routing: RoutingInfo,
        items: List[Tuple[ChunkId, bytes]],
        vers: List[int],
        S: int,
        chunk_size: int,
    ) -> Optional[List[UpdateReply]]:
        """Stage a stripe batch through the PIPELINED CHAIN ENCODE: one
        chain_encode RPC to shard 0's node carries the RAW data shards
        (parity frames empty — the hops accumulate them), then the same
        phase-2 commit round as the client-encode path. Returns None when
        the plan is not viable (a shard target non-writable/unroutable,
        m = 0, or the relay failed before staging anything) — the caller
        runs the client-side encode. Per-stripe relay failures fall to
        the write_stripe ladder, which IS the client-side encode."""
        k, m = chain.ec_k, chain.ec_m
        if m < 1:
            return None
        targets, nodes = [], []
        for j in range(k + m):
            t = chain.target_of_shard(j)
            if t is None or not t.public_state.can_write:
                return None  # a relay needs EVERY hop writable
            node = routing.node_of_target(t.target_id)
            if node is None:
                return None
            targets.append(t)
            nodes.append(node)
        B = len(items)
        width = k + m
        reqs: List[ShardWriteReq] = []
        for b, (cid, data) in enumerate(items):
            for j in range(width):
                # data shards: trimmed VIEWS of the caller's stripe bytes
                # (the bulk frame gathers them — no slice copies); crc -1
                # = "no client CRC": raw data shards install under the
                # CR-write trust model (the hop engine's staging CRC
                # stands), parity frames start empty and accumulate CRCs
                # hop by hop
                payload = (memoryview(data)[j * S : (j + 1) * S]
                           if j < k else b"")
                reqs.append(ShardWriteReq(
                    chain_id=chain.chain_id,
                    chain_ver=chain.chain_version,
                    target_id=targets[j].target_id,
                    chunk_id=cid,
                    data=payload,
                    crc=-1,
                    update_ver=vers[b],
                    chunk_size=S,
                    logical_len=len(data),
                    phase=1,  # STAGE: committed stripe survives a failure
                ))
            del cid, data
        try:
            replies = self._messenger(nodes[0].node_id, "chain_encode",
                                      reqs)
        except FsError:
            # relay unreachable (old server, dead head, ring trouble):
            # nothing staged — the client-encode path takes the batch
            self._ec_chain_fallback.add(B)
            return None
        if not isinstance(replies, list) or len(replies) != len(reqs):
            self._ec_chain_fallback.add(B)
            return None
        staged = [True] * B
        for i, rep in enumerate(replies):
            if rep is None or not rep.ok:
                staged[i // width] = False
        # phase-2 commits for fully-staged stripes: direct per-node
        # fan-out (no relay — commits carry no payload), the SAME commit
        # round and strict all-(k+m) rule as the client-encode path, so
        # the whole-stripe-version invariant is untouched
        commit_by_node: Dict[int, List[Tuple[int, ShardWriteReq]]] = (
            defaultdict(list))
        for b, (cid, data) in enumerate(items):
            if not staged[b]:
                continue
            for j in range(width):
                commit_by_node[nodes[j].node_id].append((b, ShardWriteReq(
                    chain_id=chain.chain_id,
                    chain_ver=chain.chain_version,
                    target_id=targets[j].target_id,
                    chunk_id=cid,
                    data=b"",
                    crc=0,
                    update_ver=vers[b],
                    chunk_size=S,
                    logical_len=len(data),
                    phase=2,
                )))
        committed = [0] * B
        for b, reply in self._send_shard_batches(commit_by_node):
            if reply.ok:
                committed[b] += 1
        out: List[UpdateReply] = []
        for b, (cid, data) in enumerate(items):
            if staged[b] and committed[b] == width:
                self._ec_chain_stripes.add()
                out.append(UpdateReply(
                    Code.OK, update_ver=vers[b], commit_ver=vers[b]))
            else:
                # aborted mid-chain / version conflict / partial commit:
                # the single-stripe CLIENT-ENCODE ladder converges it
                self._ec_chain_fallback.add()
                out.append(self.write_stripe(
                    chain.chain_id, cid, data, chunk_size=chunk_size,
                    update_ver=vers[b]))
        return out

    def write_stripe_rmw(
        self,
        chain_id: int,
        chunk_id: ChunkId,
        in_off: int,
        part,
        *,
        chunk_size: int = 1 << 20,
    ) -> Optional[UpdateReply]:
        """Sub-stripe write via DELTA PARITY (see _write_stripe_rmw);
        every fast-path decline counts on ec.parity_rmw_fallback so the
        monitor can answer "is the RMW path actually engaging"."""
        with _spans.root_span("client.write_stripe_rmw",
                              nbytes=len(part)):
            out = self._write_stripe_rmw(chain_id, chunk_id, in_off, part,
                                         chunk_size=chunk_size)
        if out is None:
            self._ec_rmw_fallback.add()
        return out

    def _write_stripe_rmw(
        self,
        chain_id: int,
        chunk_id: ChunkId,
        in_off: int,
        part,
        *,
        chunk_size: int = 1 << 20,
    ) -> Optional[UpdateReply]:
        """Sub-stripe write via DELTA PARITY: read only the touched data
        shards + the m parity shards, apply ``P' = P ^ c_ij * (D' ^ D)``
        (ops/rs.py delta_parity), stage the touched shards and new parity
        under a fresh stripe version, and bump the UNTOUCHED data shards
        with payload-free rebase stages (ShardWriteReq.rebase_of) — the
        server re-stages its own committed bytes. A sub-stripe write thus
        moves (touched + m) shards each way instead of reading k and
        rewriting k+m, with no stripe re-encode anywhere.

        Returns an UpdateReply on success; None when the fast path does
        not apply (missing/degraded/mid-write stripe, version race,
        partial stage) — the caller falls back to the full
        read-reencode-rewrite ladder, which handles every case. The
        whole-stripe-version invariant is preserved: every shard of the
        stripe lands at the new version (rebase included), so readers
        never see mixed versions from a completed RMW."""
        import numpy as np

        from tpu3fs_torch.ops.stripe import get_codec, shard_size_of

        chain = self._chain(chain_id)
        if not chain.is_ec:
            raise FsError(Status(Code.INVALID_ARG,
                                 "write_stripe_rmw on CR chain"))
        k, m = chain.ec_k, chain.ec_m
        n = len(part)
        if m == 0 or n == 0 or in_off + n > chunk_size:
            return None
        S = shard_size_of(chunk_size, k)
        routing = self._routing()
        ja0, ja1 = in_off // S, (in_off + n - 1) // S + 1
        touched = list(range(ja0, ja1))
        if len(touched) >= k:
            return None  # whole-stripe rewrite: plain re-encode is cheaper
        # the delta path has no partial-staging story: every shard target
        # must be writable, readable and routable, or fall back
        nodes: Dict[int, tuple] = {}
        for j in range(k + m):
            t = chain.target_of_shard(j)
            if (t is None or not t.public_state.can_write
                    or not t.public_state.can_read):
                return None
            node = routing.node_of_target(t.target_id)
            if node is None:
                return None
            nodes[j] = (t, node)
        # old content: touched data shards + every parity shard, one
        # node-grouped batched fetch
        fetch_idx = touched + [k + i for i in range(m)]
        wire = [(nodes[j][1].node_id,
                 ReadReq(chain_id, chunk_id, 0, -1, nodes[j][0].target_id))
                for j in fetch_idx]
        got = dict(zip(fetch_idx, self._issue_wire_reads(wire)))
        vers = set()
        for r in got.values():
            if not r.ok:
                return None  # absent stripe / degraded shard: fall back
            vers.add(r.commit_ver)
        if len(vers) != 1:
            return None  # a write is mid-flight: fall back (ladder retries)
        base_ver = vers.pop()
        logical = max((r.logical_len for r in got.values()
                       if r.logical_len), default=0)
        if logical == 0:
            return None  # aux-less legacy stripe: exact extent unknown
        new_logical = max(logical, in_off + n)
        codec = get_codec(k, m, S, self.device)
        mv = memoryview(part)
        payloads: Dict[int, bytes] = {}
        crcs: Dict[int, int] = {}
        parity = [
            np.frombuffer(
                bytes(got[k + i].data)  # copy-ok: delta math re-buffers
                .ljust(S, b"\x00"), dtype=np.uint8).copy()  # copy-ok: XOR target
            for i in range(m)
        ]
        pos = 0
        for j in touched:
            old = np.frombuffer(
                bytes(got[j].data)  # copy-ok: delta math re-buffers
                .ljust(S, b"\x00"), dtype=np.uint8)
            new = old.copy()  # copy-ok: merged shard content
            lo = max(in_off - j * S, 0)
            hi = min(in_off + n - j * S, S)
            new[lo:hi] = np.frombuffer(mv[pos : pos + (hi - lo)],
                                       dtype=np.uint8)
            pos += hi - lo
            for i, row in enumerate(codec.delta_parity(j, old ^ new)):
                parity[i] ^= row
            extent = min(max(new_logical - j * S, 0), S)
            payload = new[:extent].tobytes()
            payloads[j] = payload
            crcs[j] = codec.crc_host(payload)
        for i in range(m):
            payloads[k + i] = parity[i].tobytes()
            crcs[k + i] = codec.crc_host(payloads[k + i])
        ver = self._ec_next_ver(base_ver)
        by_node: Dict[int, List[Tuple[int, ShardWriteReq]]] = defaultdict(list)
        for j in range(k + m):
            t, node = nodes[j]
            if j in payloads:
                req = ShardWriteReq(
                    chain_id=chain_id, chain_ver=chain.chain_version,
                    target_id=t.target_id, chunk_id=chunk_id,
                    data=payloads[j], crc=crcs[j], update_ver=ver,
                    chunk_size=S, logical_len=new_logical, phase=1)
            else:
                # untouched data shard: payload-free version bump — the
                # server stages its own committed bytes iff still at
                # base_ver (a racing writer fails the rebase, we fall back)
                req = ShardWriteReq(
                    chain_id=chain_id, chain_ver=chain.chain_version,
                    target_id=t.target_id, chunk_id=chunk_id,
                    data=b"", crc=0, update_ver=ver, chunk_size=S,
                    logical_len=new_logical, phase=1, rebase_of=base_ver)
            by_node[node.node_id].append((j, req))
        staged = {j for j, reply in self._send_shard_batches(by_node)
                  if reply.ok}
        if len(staged) != k + m:
            # version race or unreachable shard: orphan pendings are
            # displaced by the fallback's re-stage / reclaimed by the
            # repair sweep
            return None
        commit_by_node: Dict[int, List[Tuple[int, ShardWriteReq]]] = (
            defaultdict(list))
        for node_id, group in by_node.items():
            for j, r in group:
                commit_by_node[node_id].append((j, replace(
                    r, data=b"", crc=0, phase=2, rebase_of=0)))
        landed: set = set()
        for attempt in range(self._retry.max_retries + 1):
            displaced = False
            for j, reply in self._send_shard_batches(commit_by_node):
                if reply.ok:
                    landed.add(j)
                elif reply.code == Code.CHUNK_MISSING_UPDATE:
                    displaced = True
            if len(landed) == k + m:
                self._ec_parity_rmw.add()
                return UpdateReply(Code.OK, update_ver=ver, commit_ver=ver)
            # commits are idempotent: retry the stragglers (transient
            # node hiccup); a pending displaced by a concurrent writer
            # (CHUNK_MISSING_UPDATE) can never land — fall back
            if displaced:
                break
            commit_by_node = defaultdict(list)
            for node_id, group in by_node.items():
                for j, r in group:
                    if j not in landed:
                        commit_by_node[node_id].append((j, replace(
                            r, data=b"", crc=0, phase=2, rebase_of=0)))
            if not commit_by_node:
                break
            self._sleep(attempt)
        # partial commit: the staged version holds a full-coverage quorum,
        # so the repair sweep's roll-forward (or the fallback's re-stage)
        # converges the stripe — report "not applied" to the caller
        return None

    def _plan_stripe_read(self, chain: ChainInfo, routing: RoutingInfo,
                          req: ReadReq) -> dict:
        """Shard-read plan for one EC range request: which shards cover
        [offset, offset+length) and the wire ops (node-routed, target-
        addressed whole-shard reads) that fetch them. Unroutable or
        publicly-unreadable shards simply get no wire entry — the finish
        step treats them as failed and goes degraded."""
        from tpu3fs_torch.ops.stripe import shard_size_of

        k, m = chain.ec_k, chain.ec_m
        S = shard_size_of(req.chunk_size, k)
        length = req.length if req.length >= 0 else req.chunk_size - req.offset
        length = max(0, min(length, req.chunk_size - req.offset))
        j0 = req.offset // S
        j1 = (req.offset + length - 1) // S + 1 if length else j0 + 1
        spec = {"chain": chain, "k": k, "m": m, "S": S, "j0": j0, "j1": j1,
                "offset": req.offset, "length": length, "wire": {}}
        for j in range(j0, j1):
            t = chain.target_of_shard(j)
            if t is None or not t.public_state.can_read:
                continue
            node = routing.node_of_target(t.target_id)
            if node is None:
                continue
            spec["wire"][j] = (node.node_id, ReadReq(
                chain.chain_id, req.chunk_id, 0, -1, t.target_id))
        return spec

    @staticmethod
    def _stripe_logical(spec: dict, replies: Dict[int, ReadReply],
                        group: Optional[Dict[int, bytes]] = None,
                        shards: Optional[Dict[int, object]] = None) -> int:
        """Logical (pre-padding) stripe length: exact from any shard's
        stored aux tag (ShardWriteReq.logical_len persisted by the
        server); full-cover reads without one infer it from stored shard
        extents (decoded shards via trim_rebuilt_shard)."""
        k, S, j0, j1 = spec["k"], spec["S"], spec["j0"], spec["j1"]
        logical = max(
            (r.logical_len for r in replies.values()
             if r is not None and r.ok and r.logical_len), default=0)
        if logical == 0 and (j0, j1) == (0, k):
            if group is None:
                logical = max(
                    (j * S + len(replies[j].data) for j in range(j0, j1)
                     if len(replies[j].data) > 0), default=0)
            else:
                from tpu3fs_torch.ops.stripe import trim_rebuilt_shard

                lens = {j: len(group[j]) for j in group if j < k}
                logical = max(
                    (j * S + len(group[j]) for j in group
                     if j < k and len(group[j]) > 0), default=0)
                for j in range(j0, j1):
                    if j in group or j >= k:
                        continue
                    trimmed = trim_rebuilt_shard(
                        bytes(shards[j]), j, lens, k, S)  # copy-ok: no aux tag
                    if len(trimmed) > 0:
                        logical = max(logical, j * S + len(trimmed))
        return logical

    @staticmethod
    def _range_data(spec: dict, shards: Dict[int, object], joined: bool):
        """A stripe's [offset, offset+length) from its covering shards'
        buffers (stored trimmed: a short shard reads as zeros up to S), as
        parts in file order: each buffer whole, or a memoryview cut to the
        range at a partial first or last shard, and a short shard's zero
        padding as a part of its own. ``joined``: the one ``bytes`` the
        public replies carry; else the list of parts, which FileIoClient's
        assembly copies once into its call's result."""
        S = spec["S"]
        lo, hi = spec["offset"], spec["offset"] + spec["length"]
        parts: list = []
        for j in range(spec["j0"], spec["j1"]):
            buf = shards[j]
            n = len(buf)
            a, b = max(lo - j * S, 0), min(hi - j * S, S)
            end = min(b, n)
            if a < end:
                parts.append(buf if (a, end) == (0, n)
                             else memoryview(buf)[a:end])
            if b > max(a, n):
                parts.append(bytes(b - max(a, n)))
        return b"".join(parts) if joined else parts  # copy-ok: range assembly

    def _pinned_rows(self, k: int, S: int):
        """This thread's page-locked staging as a (k, S) uint8 array: a
        degraded stripe's survivors land here so the card reads them by
        DMA, with no pageable staging of the driver's. One buffer per
        client per thread (prefetch workers decode on their own threads),
        grown to the largest k x S seen. The copy to the card is
        synchronous and nothing keeps the rows after it, so the next
        stripe may overwrite them."""
        buf = getattr(self._pinned, "tensor", None)
        if buf is None or buf.numel() < k * S:
            import torch

            buf = self._pinned.tensor = torch.empty(
                k * S, dtype=torch.uint8, pin_memory=True)
        return buf.numpy()[: k * S].reshape(k, S)

    def _stripe_clean(self, spec: dict, direct: Dict[int, ReadReply],
                      joined: bool) -> Optional[ReadReply]:
        """Assemble the fast path: every covering shard answered OK at ONE
        committed version. None = not clean (degraded decode next)."""
        j0, j1 = spec["j0"], spec["j1"]
        rs = [direct.get(j) for j in range(j0, j1)]
        if any(r is None or not r.ok for r in rs):
            return None
        vers = {r.commit_ver for r in rs}
        if len(vers) != 1:
            return None
        with _spans.span("client.read_stripe", "assemble"):
            data = self._range_data(
                spec, {j: direct[j].data for j in range(j0, j1)}, joined)
        return ReadReply(
            Code.OK,
            data=data,
            commit_ver=vers.pop(),
            logical_len=self._stripe_logical(spec, direct),
        )

    def _stripe_degraded(self, spec: dict, replies: Dict[int, ReadReply],
                         joined: bool) -> Optional[ReadReply]:
        """Degraded decode over ALL fetched shards: group by committed
        version, reconstruct the covering shards from the newest version
        holding a k-quorum. CHUNK_NOT_FOUND when every shard is missing;
        None when no version is decodable yet (mixed versions mid-write —
        the caller's ladder retries)."""
        import numpy as np

        from tpu3fs_torch.ops.stripe import get_codec

        k, m, S = spec["k"], spec["m"], spec["S"]
        j0, j1 = spec["j0"], spec["j1"]
        with _spans.span("ec.decode", "gather"):
            by_ver: Dict[int, Dict[int, bytes]] = defaultdict(dict)
            all_missing = True
            for j, r in replies.items():
                if r is None:
                    continue
                if r.ok:
                    # the decode path pads and ndarray-stacks shard
                    # payloads: materialize any zero-copy transport view once
                    by_ver[r.commit_ver][j] = bytes(r.data)  # copy-ok: decode input
                    all_missing = False
                elif r.code != Code.CHUNK_NOT_FOUND:
                    all_missing = False
            if all_missing:
                return ReadReply(Code.CHUNK_NOT_FOUND)
            usable = [v for v, g in by_ver.items() if len(g) >= k]
            if not usable:
                return None
            ver = max(usable)
            group = by_ver[ver]
            present = sorted(group)[:k]
            lost = [j for j in range(j0, j1) if j not in present]
            if lost:
                codec = get_codec(k, m, S, self.device)
                # on the card the survivors land in page-locked memory,
                # which it reads by DMA; the rebuilt shards come back in
                # fresh memory, so the staging is free once this returns
                pinned = codec.device.type == "cuda"
                surv = np.stack([
                    np.frombuffer(
                        group[j].ljust(S, b"\x00"), dtype=np.uint8)
                    for j in present
                ], out=self._pinned_rows(k, S) if pinned else None)
        shards: Dict[int, object] = {
            j: group[j] for j in range(j0, j1) if j in group}
        if lost:
            rebuilt = codec.reconstruct_batch(present, lost, surv[None])[0]
            if pinned:
                self._ec_decode_pinned.add()
        with _spans.span("client.read_stripe", "assemble"):
            for i, j in enumerate(lost):
                shards[j] = memoryview(rebuilt[i])
            data = self._range_data(spec, shards, joined)
        ok_replies = {j: r for j, r in replies.items()
                      if r is not None and r.ok and r.commit_ver == ver}
        return ReadReply(
            Code.OK, data=data, commit_ver=ver,
            logical_len=self._stripe_logical(spec, ok_replies, group, shards))

    def _finish_stripe_reads(self, reqs, replies, ec_specs,
                             shard_replies, routing, joined: bool) -> None:
        """Resolve every EC request of a batch from its first-round shard
        replies; stripes that did not assemble cleanly go DEGRADED
        together — the missing/failed shards of ALL of them fetch in one
        more batched round (any k of k+m survive), decode inline, and the
        detour is recorded (ec.degraded_read / ec.degraded_read_ms)."""
        degraded: List[int] = []
        for i, spec in ec_specs.items():
            out = self._stripe_clean(spec, shard_replies[i], joined)
            if out is not None:
                replies[i] = out
            else:
                degraded.append(i)
        if not degraded:
            return
        t0 = time.monotonic()
        wire: List[Tuple[int, ReadReq]] = []
        tags: List[Tuple[int, int]] = []
        for i in degraded:
            spec = ec_specs[i]
            chain = spec["chain"]
            have = shard_replies[i]
            for j in range(spec["k"] + spec["m"]):
                r = have.get(j)
                if r is not None and r.ok:
                    continue
                t = chain.target_of_shard(j)
                if t is None or not t.public_state.can_read:
                    continue
                node = routing.node_of_target(t.target_id)
                if node is None:
                    continue
                tags.append((i, j))
                wire.append((node.node_id, ReadReq(
                    chain.chain_id, reqs[i].chunk_id, 0, -1, t.target_id)))
        with _spans.span("client.batch_read", "fetch_degraded"):
            got = self._issue_wire_reads(wire)
        for (i, j), r in zip(tags, got):
            shard_replies[i][j] = r
        self._count_shard_bytes(got)
        fetch_s = time.monotonic() - t0
        for i in degraded:
            t1 = time.monotonic()
            out = self._stripe_degraded(ec_specs[i], shard_replies[i],
                                        joined)
            if out is not None and out.ok:
                self._note_degraded(fetch_s + time.monotonic() - t1)
            elif out is None:
                # no decodable version in this snapshot (write/rebuild in
                # flight): the single-op ladder retries with backoff
                out = self._read_stripe(
                    reqs[i].chain_id, reqs[i].chunk_id,
                    ec_specs[i]["offset"], ec_specs[i]["length"],
                    reqs[i].chunk_size, joined)
            replies[i] = out

    def read_stripe(
        self,
        chain_id: int,
        chunk_id: ChunkId,
        offset: int = 0,
        length: int = -1,
        *,
        chunk_size: int = 1 << 20,
    ) -> ReadReply:
        """Read [offset, offset+length) of an EC-striped chunk: fetch the
        covering data shards (batched per node); on a missing/failed
        shard, gather any k same-version survivors and reconstruct
        (degraded read). Shares its planning/assembly/decode helpers with
        batch_read so the two paths cannot drift apart."""
        return self._read_stripe(chain_id, chunk_id, offset, length,
                                 chunk_size, True)

    def read_stripe_parts(
        self,
        chain_id: int,
        chunk_id: ChunkId,
        offset: int = 0,
        length: int = -1,
        *,
        chunk_size: int = 1 << 20,
    ) -> ReadReply:
        """read_stripe for FileIoClient's assembly: ``data`` is the range
        as a list of buffers in file order (see _range_data), which the
        caller's one join copies."""
        return self._read_stripe(chain_id, chunk_id, offset, length,
                                 chunk_size, False)

    def _read_stripe(self, chain_id: int, chunk_id: ChunkId, offset: int,
                     length: int, chunk_size: int,
                     joined: bool) -> ReadReply:
        with _spans.root_span("client.read_stripe", nbytes=max(0, length)), \
                self._op_scope():
            return self._read_stripe_op(chain_id, chunk_id, offset, length,
                                        chunk_size, joined)

    def _count_shard_bytes(self, replies) -> None:
        """ec.read_shard_bytes: the bytes of a round's OK shard replies."""
        n = sum(len(r.data) for r in replies if r.ok)
        if n:
            self._ec_read_shard_bytes.add(n)

    def _note_degraded(self, seconds: float) -> None:
        """One stripe served by decode: ec.degraded_read, and in
        ec.degraded_read_ms its survivors' fetch plus its decode."""
        self._ec_degraded.add()
        self._ec_degraded_ms.record(seconds * 1000.0)

    def _read_stripe_op(self, chain_id: int, chunk_id: ChunkId, offset: int,
                        length: int, chunk_size: int,
                        joined: bool) -> ReadReply:
        chain = self._chain(chain_id)
        if not chain.is_ec:
            raise FsError(Status(Code.INVALID_ARG, "read_stripe on CR chain"))
        if length < 0:
            length = chunk_size - offset
        length = max(0, min(length, chunk_size - offset))
        if length == 0:
            return ReadReply(Code.OK, data=b"")
        req = ReadReq(chain_id, chunk_id, offset, length,
                      chunk_size=chunk_size)

        last = ReadReply(Code.TARGET_NOT_FOUND)
        for attempt in range(self._retry.max_retries + 1):
            chain = self._chain(chain_id)
            routing = self._routing()
            spec = self._plan_stripe_read(chain, routing, req)
            wire = list(spec["wire"].items())
            direct: Dict[int, ReadReply] = {}
            with _spans.span("client.read_stripe", "fetch"):
                got = self._issue_wire_reads([entry for _, entry in wire])
            for (j, _), r in zip(wire, got):
                direct[j] = r
            self._count_shard_bytes(got)
            out = self._stripe_clean(spec, direct, joined)
            if out is not None:
                return out
            # degraded: gather every remaining readable shard, group by
            # version, reconstruct from the newest k-quorum
            t0 = time.monotonic()
            extra: List[Tuple[int, Tuple[int, ReadReq]]] = []
            for j in range(spec["k"] + spec["m"]):
                r = direct.get(j)
                if r is not None and r.ok:
                    continue
                t = chain.target_of_shard(j)
                if t is None or not t.public_state.can_read:
                    continue
                node = routing.node_of_target(t.target_id)
                if node is None:
                    continue
                extra.append((j, (node.node_id, ReadReq(
                    chain_id, chunk_id, 0, -1, t.target_id))))
            with _spans.span("client.read_stripe", "fetch_degraded"):
                got = self._issue_wire_reads([entry for _, entry in extra])
            for (j, _), r in zip(extra, got):
                direct[j] = r
            self._count_shard_bytes(got)
            out = self._stripe_degraded(spec, direct, joined)
            if out is not None:
                if out.ok:
                    self._note_degraded(time.monotonic() - t0)
                return out
            # mixed versions / not enough shards yet: transient (a stripe
            # write or rebuild is in flight) — retry
            last = ReadReply(Code.CHUNK_NOT_COMMIT)
            if self._deadline_expired():
                return ReadReply(Code.DEADLINE_EXCEEDED)
            self._sleep(attempt)
        return last

    # -- maintenance ----------------------------------------------------------
    def _chain_nodes(self, chain: ChainInfo) -> List[int]:
        """Distinct node ids hosting any target of the chain (EC fan-out)."""
        routing = self._routing()
        seen: List[int] = []
        for t in chain.targets:
            node = routing.node_of_target(t.target_id)
            if node is not None and node.node_id not in seen:
                seen.append(node.node_id)
        return seen

    def remove_file_chunks(self, chain_id: int, file_id: int) -> None:
        chain = self._chain(chain_id)
        if chain.is_ec:
            # no propagation order on EC chains: address every node directly
            for node_id in self._chain_nodes(chain):
                try:
                    self._messenger(
                        node_id, "remove_file_chunks", (chain_id, file_id))
                except FsError:
                    continue  # dead node: resync reconciles its stale shards
            return
        head = chain.head()
        if head is None:
            raise FsError(Status(Code.TARGET_OFFLINE, "no head"))
        node = self._routing().node_of_target(head.target_id)
        self._messenger(node.node_id, "remove_file_chunks", (chain_id, file_id))

    def truncate_file_chunks(
        self, chain_id: int, file_id: int, last_index: int, last_length: int
    ) -> None:
        chain = self._chain(chain_id)
        if chain.is_ec:
            for node_id in self._chain_nodes(chain):
                try:
                    self._messenger(
                        node_id, "truncate_file_chunks",
                        (chain_id, file_id, last_index, last_length))
                except FsError:
                    continue
            return
        head = chain.head()
        if head is None:
            raise FsError(Status(Code.TARGET_OFFLINE, "no head"))
        node = self._routing().node_of_target(head.target_id)
        self._messenger(
            node.node_id,
            "truncate_file_chunks",
            (chain_id, file_id, last_index, last_length),
        )

    def space_info(self) -> SpaceInfo:
        """Cluster-wide space: spaceInfo from every live storage node
        (ref admin_cli statFs path aggregating per-node spaceInfo)."""
        total = SpaceInfo()
        for node in self._routing().nodes.values():
            if node.type != NodeType.STORAGE:
                continue
            try:
                si = self._messenger(node.node_id, "space_info", None)
            except FsError:
                continue  # dead node: its space is unavailable, not free
            total.capacity += si.capacity
            total.used += si.used
            total.chunk_count += si.chunk_count
        return total

    # -- maintenance plane (migration worker / admin sweeps) ------------------
    def dump_chunkmeta(self, node_id: int, target_id: int):
        """A target's full chunk-metadata inventory (committed + pending):
        the diff primitive of every copy/verify sweep. Plain messenger
        pass-through — breaker/fault-plane guards apply."""
        return self._messenger(node_id, "dump_chunkmeta", target_id)

    def sync_done(self, node_id: int, target_id: int) -> None:
        """Declare a syncing target caught up (it reports UPTODATE on its
        next heartbeat and mgmtd promotes it SERVING)."""
        self._messenger(node_id, "sync_done", target_id)

    def remove_target_chunk(self, node_id: int, target_id: int,
                            chunk_id: ChunkId) -> bool:
        return bool(self._messenger(node_id, "remove_chunk",
                                    (target_id, chunk_id)))

    def batch_read_rebuild(self, node_id: int,
                           reqs: List[ReadReq]) -> List[ReadReply]:
        """Batched rebuild-tier reads addressed at ONE node's targets,
        bypassing the public-state gate (chain_id 0 = target-addressed
        out-of-chain read: the EC drain direct copy reads the detached
        outgoing member). Transport errors come back as per-op replies."""
        if not reqs:
            return []
        try:
            return list(self._messenger(node_id, "batch_read_rebuild",
                                        reqs))
        except FsError as e:
            return [ReadReply(e.code) for _ in reqs]

    def batch_write_shard(self, node_id: int,
                          reqs: List[ShardWriteReq]) -> List[UpdateReply]:
        """Batched EC shard installs addressed at ONE node (the rebuild/
        direct-copy install leg). Version-deduped server-side: a shard
        already committed at (or past) the request's stripe version
        answers OK / CHUNK_STALE_UPDATE instead of double-applying."""
        if not reqs:
            return []
        try:
            return list(self._messenger(node_id, "batch_write_shard",
                                        reqs))
        except FsError as e:
            return [UpdateReply(e.code, message=e.status.message)
                    for _ in reqs]

    def batch_sync_write(self, node_id: int,
                         reqs: List[WriteReq]) -> List[UpdateReply]:
        """Batched full-chunk-replace installs addressed at ONE node's
        syncing chain member (WriteReq.from_target names the predecessor,
        so the server resolves the receiving target; update_ver pins the
        source's committed version — a racing foreground write that
        already moved the chunk past it dedupes as CHUNK_STALE_UPDATE).
        Rides the striped pipelined batch_update fan-out on socket
        messengers; one direct batch_update otherwise. Transport errors
        come back as per-op replies — the caller's round loop retries."""
        if not reqs:
            return []
        pipelined = getattr(self._messenger, "batch_write_pipelined", None)
        if pipelined is not None and getattr(
                self._messenger, "write_pipelined", True):
            return pipelined([(node_id, reqs)], method="batch_update")[0]
        try:
            return list(self._messenger(node_id, "batch_update", reqs))
        except FsError as e:
            return [UpdateReply(e.code, message=e.status.message)
                    for _ in reqs]

    def query_last_chunk(self, chain_id: int, file_id: int) -> Tuple[int, int]:
        """Last (chunk index, byte length) of a file on one chain — the
        length-settlement primitive. The POLICY throughout: unavailability
        must surface as an ERROR, never as (-1, 0) — a caller settling a
        close would write a silently-truncated length into the inode. An
        EMPTY chain is only ever reported as (-1, 0) by a replica that
        actually answered. Retry ladder with per-replica failover covers
        the just-killed-but-still-SERVING heartbeat window and transient
        no-serving windows during failover."""
        last_err: Optional[FsError] = None
        for attempt in range(self._retry.max_retries + 1):
            chain = self._chain(chain_id)
            if chain.is_ec:
                # each target holds a different shard: the precise length
                # is the max over ALL serving targets' contributions — a
                # partial sweep could under-report the tail shard, so any
                # per-target failure fails the whole attempt
                best = (-1, 0)
                failed: Optional[FsError] = None
                queried = 0
                for t in chain.targets:
                    if t.public_state != PublicTargetState.SERVING:
                        continue
                    node = self._routing().node_of_target(t.target_id)
                    if node is None:
                        # SERVING but unroutable counts as a failure: a
                        # partial sweep could under-report the tail shard
                        failed = failed or FsError(Status(
                            Code.TARGET_OFFLINE,
                            f"no route to target {t.target_id}"))
                        continue
                    try:
                        got = self._messenger(
                            node.node_id, "query_last_chunk",
                            (chain_id, file_id))
                    except FsError as e:
                        failed = e
                        continue
                    queried += 1
                    if got[0] > best[0] or (
                            got[0] == best[0] and got[1] > best[1]):
                        best = tuple(got)
                if failed is None and queried > 0:
                    return best
                # zero targets answered, or a partial sweep: UNAVAILABLE
                last_err = failed or FsError(Status(
                    Code.TARGET_OFFLINE,
                    f"no serving shard target on chain {chain_id}"))
            else:
                answered = False
                for t in chain.targets[::-1]:  # prefer tail: committed
                    if t.public_state != PublicTargetState.SERVING:
                        continue
                    node = self._routing().node_of_target(t.target_id)
                    if node is None:
                        continue
                    try:
                        return self._messenger(
                            node.node_id, "query_last_chunk",
                            (chain_id, file_id))
                    except FsError as e:
                        last_err = e
                        answered = True
                        continue
                if not answered and last_err is None:
                    # zero serving replicas right now (failover window):
                    # that means UNAVAILABLE, not empty — retry then raise
                    last_err = FsError(Status(
                        Code.TARGET_OFFLINE,
                        f"no serving replica on chain {chain_id}"))
            if attempt < self._retry.max_retries:
                if self._deadline_expired():
                    raise FsError(Status(Code.DEADLINE_EXCEEDED,
                                         "op deadline exhausted"))
                self._sleep(attempt)
        raise last_err
