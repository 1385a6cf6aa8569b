"""RPC service bindings: storage / meta / mgmtd / core over the TCP transport.

The port's own copy of ``tpu3fs/rpc/services.py``: the same wire types,
service and method ids, so the port's clients and servers interoperate
with the JAX package's, and the same messenger, which rides the USRBIO
shared-memory rings (``usrbio/``) to co-located storage nodes unless
``TPU3FS_USRBIO=0``, over the same ring ABI. The port's messenger also
counts its data-plane calls by transport (``transport_calls``).

Service and method ids mirror the reference's registry: StorageSerde id 3
(src/fbs/storage/Service.h:8-23), MetaSerde id 4 (src/fbs/meta/
Service.h:709-746), Mgmtd id 217 (src/fbs/mgmtd/MgmtdServiceDef.h:3-26), Core
id 10001 on every server (src/fbs/core/service/CoreServiceDef.h:3-8).

Each binding pairs wire dataclasses with handlers over the in-process
operators, plus a client-side stub exposing the same methods; the storage
stub implements the Messenger signature so the CRAQ forwarding path and the
ResyncWorker run unchanged over sockets.
"""

from __future__ import annotations

import collections
import os
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from tpu3fs_torch.meta.store import (
    BatchCloseItem,
    BatchCreateItem,
    MetaStore,
    OpenResult,
    StatFs,
    User,
)
from tpu3fs_torch.meta.types import DirEntry, Inode, Layout
from tpu3fs_torch.metashard.partition import (
    DEFAULT_PARTITIONS,
    partition_of_dir,
    partition_of_inode,
    partition_of_path,
)
from tpu3fs_torch.metashard.twophase import IntentRecord
from tpu3fs_torch.mgmtd.service import HeartbeatReply, Mgmtd
from tpu3fs_torch.mgmtd.types import LocalTargetState, NodeType, RoutingInfo
from tpu3fs_torch.migration.types import MigrationJob, MoveSpec
from tpu3fs_torch.rpc.net import RpcClient, RpcServer, ServiceDef
from tpu3fs_torch.storage.craq import (
    ReadReply,
    ReadReq,
    ShardWriteReq,
    StorageService,
    UpdateReply,
    WriteReq,
)
from tpu3fs_torch.storage.types import ChunkId, ChunkMeta, SpaceInfo
from tpu3fs_torch.utils.result import Code, FsError, Status
from tpu3fs_torch.utils.result import err as _err

STORAGE_SERVICE_ID = 3     # ref fbs/storage/Service.h
META_SERVICE_ID = 4        # ref fbs/meta/Service.h
MGMTD_SERVICE_ID = 217     # ref fbs/mgmtd/MgmtdServiceDef.h
CORE_SERVICE_ID = 10001    # ref fbs/core/service/CoreServiceDef.h


# -- small wire wrappers ----------------------------------------------------

@dataclass
class TargetIdReq:
    target_id: int


@dataclass
class ChunkMetaList:
    metas: List[ChunkMeta] = field(default_factory=list)


@dataclass
class RemoveChunkReq:
    target_id: int
    chunk_id: ChunkId


@dataclass
class FileChunksReq:
    chain_id: int
    file_id: int


@dataclass
class TruncateChunksReq:
    chain_id: int
    file_id: int
    last_index: int
    last_length: int


@dataclass
class PruneClientReq:
    client_id: str


@dataclass
class BatchReadReq:
    reqs: List[ReadReq] = field(default_factory=list)


@dataclass
class BatchReadRsp:
    replies: List[ReadReply] = field(default_factory=list)


@dataclass
class StatChunksReq:
    target_id: int
    chunk_ids: List[ChunkId] = field(default_factory=list)


@dataclass
class StatChunksRsp:
    stats: List[List[int]] = field(default_factory=list)


@dataclass
class BatchWriteReq:
    reqs: List[WriteReq] = field(default_factory=list)


@dataclass
class BatchShardWriteReq:
    reqs: List[ShardWriteReq] = field(default_factory=list)


@dataclass
class BatchWriteRsp:
    replies: List[UpdateReply] = field(default_factory=list)


@dataclass
class IntReply:
    value: int = 0


@dataclass
class PairReply:
    a: int = 0
    b: int = 0


@dataclass
class Empty:
    pass


@dataclass
class EchoReq:
    text: str = ""


@dataclass
class EchoRsp:
    text: str = ""


@dataclass
class FlightDumpReq:
    path: str = ""      # "" = the process's configured flight.dir


@dataclass
class FlightDumpRsp:
    path: str = ""      # "" = no dir configured, nothing written
    events: int = 0     # ring occupancy at dump time


@dataclass
class HeartbeatReq:
    node_id: int
    hb_version: int
    local_states: Dict[int, int] = field(default_factory=dict)
    # per-partition op-rate gauge from META nodes (metashard) — trailing
    # field: pre-metashard peers interop (rpc/serde.py evolution rule)
    meta_loads: Dict[int, float] = field(default_factory=dict)


@dataclass
class RoutingReq:
    known_version: int = -1


@dataclass
class RoutingRsp:
    changed: bool = False
    routing: Optional[RoutingInfo] = None


@dataclass
class RegisterNodeReq:
    node_id: int
    node_type: int
    host: str = ""
    port: int = 0


@dataclass
class ServingRegisterReq:
    """Publish/renew a KVCache serving endpoint (tpu3fs/serving) in the
    routing snapshot's peer directory."""

    node_id: int
    host: str = ""
    port: int = 0
    ttl_s: float = 30.0


@dataclass
class ServingUnregisterReq:
    node_id: int


# -- storage ----------------------------------------------------------------
#
# Data-path methods are bulk-capable: chunk payloads ride the frame's bulk
# section (FLAG_BULK, net.py) instead of the serde envelope — the analogue
# of the reference separating control packets from RDMA READ/WRITE batches
# (src/common/net/ib/IBSocket.h:155-229). A bulk-mode client always sets
# the flag (an empty section on pure reads signals "reply in bulk"); legacy
# inline-payload requests are still served inline, so the two wire forms
# interoperate.

def _attach(op, seg):
    """Re-attach a bulk segment as an op's data field — ZERO-COPY: the
    segment is a memoryview over the transport's receive buffer, and the
    buffer is detached from the pool (GC-owned) so it stays alive exactly
    as long as the op references the view. The dispatch is synchronous
    (update-worker submit blocks until replies are built), so nothing
    retains the view past the request; the engine takes its own owned
    copy at install time — the only copy left on the receive path."""
    return replace(op, data=seg)


def _detach(rsp):
    """Split a reply's data field off into a bulk segment."""
    return replace(rsp, data=b""), rsp.data


def bind_storage_service(server: RpcServer, svc: StorageService) -> None:
    s = ServiceDef(STORAGE_SERVICE_ID, "StorageSerde")

    def _one_write(fn):
        def _write_h(r, bulk):
            # `is not None`, not truthiness: a bulk-flagged request with a
            # count=0 section must be rejected, not silently run with
            # data=b'' (empty-section probes are a read-path convention)
            if bulk is not None:
                if len(bulk) != 1:
                    raise FsError(Status(
                        Code.RPC_BAD_REQUEST,
                        f"bulk segments {len(bulk)} != 1"))
                r = _attach(r, bulk[0])
            return fn(r), None
        return _write_h

    def _batch_write(fn):
        def _batch_write_h(r, bulk):
            reqs = r.reqs
            if bulk is not None:
                if len(bulk) != len(reqs):
                    raise FsError(Status(
                        Code.RPC_BAD_REQUEST,
                        f"bulk segments {len(bulk)} != ops {len(reqs)}"))
                reqs = [_attach(op, seg) for op, seg in zip(reqs, bulk)]
            return BatchWriteRsp(fn(reqs)), None
        return _batch_write_h

    def _read_h(r, bulk):
        # bulk mode rides the zero-copy serving path: engine hands out
        # buffer views, the transport gathers them into the socket — the
        # reply payload is never copied into the serde envelope
        if bulk is None:
            return svc.read(r), None
        rsp = svc.batch_read([r], views=True)[0]
        ctrl, data = _detach(rsp)
        return ctrl, [data]

    def _batch_read_h(r, bulk):
        replies = svc.batch_read(r.reqs, views=bulk is not None)
        if bulk is None:
            return BatchReadRsp(replies), None
        ctrls, iovs = [], []
        for rp in replies:
            ctrl, data = _detach(rp)
            ctrls.append(ctrl)
            iovs.append(data)
        return BatchReadRsp(ctrls), iovs

    s.method(1, "write", WriteReq, UpdateReply, _one_write(svc.write),
             bulk=True)
    s.method(2, "update", WriteReq, UpdateReply, _one_write(svc.update),
             bulk=True)
    s.method(3, "read", ReadReq, ReadReply, _read_h, bulk=True)
    s.method(4, "dumpChunkMeta", TargetIdReq, ChunkMetaList,
             lambda r: ChunkMetaList(svc.dump_chunkmeta(r.target_id)))
    s.method(5, "syncDone", TargetIdReq, Empty,
             lambda r: (svc.sync_done(r.target_id), Empty())[1])
    s.method(6, "removeChunk", RemoveChunkReq, IntReply,
             lambda r: IntReply(int(svc.remove_chunk(r.target_id, r.chunk_id))))
    s.method(7, "removeFileChunks", FileChunksReq, IntReply,
             lambda r: IntReply(svc.remove_file_chunks(r.chain_id, r.file_id)))
    s.method(8, "queryLastChunk", FileChunksReq, PairReply,
             lambda r: PairReply(*svc.query_last_chunk(r.chain_id, r.file_id)))
    s.method(9, "truncateChunks", TruncateChunksReq, IntReply,
             lambda r: IntReply(svc.truncate_file_chunks(
                 r.chain_id, r.file_id, r.last_index, r.last_length)))
    s.method(10, "spaceInfo", Empty, SpaceInfo, lambda r: svc.space_info())
    s.method(11, "batchRead", BatchReadReq, BatchReadRsp, _batch_read_h,
             bulk=True)
    s.method(12, "batchWrite", BatchWriteReq, BatchWriteRsp,
             _batch_write(svc.batch_write), bulk=True)
    s.method(13, "writeShard", ShardWriteReq, UpdateReply,
             _one_write(svc.write_shard), bulk=True)
    s.method(14, "batchWriteShard", BatchShardWriteReq, BatchWriteRsp,
             _batch_write(svc.batch_write_shard), bulk=True)
    s.method(15, "batchUpdate", BatchWriteReq, BatchWriteRsp,
             _batch_write(svc.batch_update), bulk=True)
    s.method(16, "statChunks", StatChunksReq, StatChunksRsp,
             lambda r: StatChunksRsp(
                 [list(t) for t in svc.stat_chunks(r.target_id, r.chunk_ids)]))
    # channel reaping for departed clients (the reference prunes update
    # channels via client sessions, UpdateChannelAllocator.h:11-34)
    s.method(17, "pruneClientChannels", PruneClientReq, IntReply,
             lambda r: IntReply(svc.prune_client_channels(r.client_id)))
    # local data-path offlining (ref offlineTarget, fbs/storage/Service.h:14)
    s.method(18, "offlineTarget", TargetIdReq, IntReply,
             lambda r: IntReply(int(svc.offline_target(r.target_id))))
    # rebuild-coordinator read: bypasses the public-state gate (EC
    # opportunistic rebuild; ec_resync._read_shard)
    s.method(19, "readRebuild", ReadReq, ReadReply, svc.read_rebuild)
    s.method(20, "dumpPendingChunkMeta", TargetIdReq, ChunkMetaList,
             lambda r: ChunkMetaList(svc.dump_pending_chunkmeta(r.target_id)))
    # batched rebuild-coordinator reads: the EC rebuilder's recovery
    # fan-in (one RPC per surviving peer per stripe batch)
    s.method(21, "batchReadRebuild", BatchReadReq, BatchReadRsp,
             lambda r: BatchReadRsp(svc.batch_read_rebuild(r.reqs)))
    # pipelined chain encode: one hop of the in-chain EC encoder (raw
    # data shards + in-flight parity accumulator frames ride the bulk
    # section; craq.StorageService.chain_encode)
    s.method(22, "chainEncodeWrite", BatchShardWriteReq, BatchWriteRsp,
             _batch_write(svc.chain_encode), bulk=True)
    server.add_service(s)


class _RingPending:
    """A pipelined fan-out entry riding a shm ring instead of a socket."""

    __slots__ = ("ring", "pending")

    def __init__(self, ring, pending):
        self.ring = ring
        self.pending = pending


class RpcMessenger:
    """Messenger over sockets — with a transparent USRBIO shm fast path.

    The same signature the fabric's direct-dispatch messenger has, so
    StorageService forwarding, ResyncWorker and the clients are transport
    agnostic. It declares no ``in_process``: CRAQ successors re-verify the
    bytes every hop delivers (one checksum per hop, on the node's device).

    TRANSPORT SELECTION (usrbio/transport.py): on first data-plane
    use of a node, the messenger handshakes the node's Usrbio control
    service; if the node proves same-host (the client can read a nonce
    the server wrote into /dev/shm), a registered (ring, iov) pair is
    established and every ring-capable method (RING_METHODS) rides it —
    request staged in shm, reply gathered into shm by the storage
    process, no socket on the data path. Cross-host nodes, pre-USRBIO
    servers and ANY ring-level failure fall back to the pipelined
    sockets, so callers never see a new failure mode.
    """

    # real sockets: per-node batch RPCs are worth issuing concurrently
    # (StorageClient._fan_out); in-process messengers leave this unset
    parallel_fanout = True

    def __init__(self, routing_provider, client: Optional[RpcClient] = None):
        import threading

        from tpu3fs_torch.rpc.health import HealthRegistry

        self._routing = routing_provider
        self._client = client or RpcClient()
        from tpu3fs_torch.usrbio import transport as _ut

        # USRBIO shm rings: node id -> RingClient (None = handshake tried
        # and failed / not same-host — sockets for that node until it
        # registers another address). TPU3FS_USRBIO=0 is the A/B lever.
        self._usrbio = os.environ.get("TPU3FS_USRBIO", "1") != "0"
        self._usrbio_entries = int(os.environ.get(
            "TPU3FS_USRBIO_ENTRIES", "128"))
        self._usrbio_iov_bytes = int(os.environ.get(
            "TPU3FS_USRBIO_IOV_MB", "64")) << 20
        self._rings = _ut.RingTable(self._client,
                                    entries=self._usrbio_entries,
                                    iov_bytes=self._usrbio_iov_bytes)
        #: (transport, method, node id) -> data-plane calls issued, where
        #: transport is "ring" or "socket": a call counts on each transport
        #: it was tried on, so one that fell back from a ring to a socket
        #: counts once on each; the process-wide recorders
        #: usrbio.calls_ring and usrbio.calls_socket count them too
        self.transport_calls: collections.Counter = collections.Counter()
        self._calls_lock = threading.Lock()
        # ring WRITE stripe cap: socket write stripes exist to pipeline
        # bytes over separate connections, but over shm a stripe is a
        # separate chain-batch on the server (its own engine crossing,
        # update-queue round and commit) with no wire to overlap —
        # measured ~35% faster as ONE SQE per node group. Reads keep the
        # socket striping (stripe replies pipeline the agent's copy with
        # the client's parse even on one core; measured ~2x vs one SQE).
        self._ring_write_stripes = max(1, int(os.environ.get(
            "TPU3FS_USRBIO_WRITE_STRIPES", "1")))
        # per-peer health + circuit breakers (rpc/health.py): every timed
        # call feeds the node's EWMA/error streak; an OPEN breaker makes
        # MUTATING calls fail fast with the retryable PEER_UNHEALTHY
        # (reads are replica-reordered client-side instead, and serve as
        # free probes). StorageClient shares this registry for its
        # replica ordering + hedge delays.
        self.health = HealthRegistry()
        # A/B lever: TPU3FS_RPC_INLINE=1 turns bulk framing off so the
        # two wire forms can be benchmarked against each other
        self._bulk = os.environ.get("TPU3FS_RPC_INLINE", "") != "1"
        # striped read fan-out: a node group whose estimated payload
        # clears the threshold is split into up to TPU3FS_READ_STRIPES
        # sub-batches, each pipelined on its OWN pooled connection — the
        # server's workers run the stripes concurrently and the replies
        # stream back in parallel instead of serializing on one socket
        # threshold tuned on the rpc storage_bench: sub-MiB stripes cost
        # more in per-RPC serde/GIL than they win in parallelism, so only
        # multi-MiB node groups (ckpt restore, large batch loads) split
        self._stripes = max(1, int(os.environ.get(
            "TPU3FS_READ_STRIPES", "4")))
        self._stripe_min_bytes = int(os.environ.get(
            "TPU3FS_READ_STRIPE_MIN", str(4 << 20)))
        # write-side twin of the read striping knobs; write_pipelined is
        # the A/B lever the write bench uses (off = the per-node fan-out
        # path, the pre-pipelining wire behavior)
        self.write_pipelined = os.environ.get(
            "TPU3FS_WRITE_PIPELINED", "1") != "0"
        self._write_stripes = max(1, int(os.environ.get(
            "TPU3FS_WRITE_STRIPES", "4")))
        self._write_stripe_min_bytes = int(os.environ.get(
            "TPU3FS_WRITE_STRIPE_MIN", str(4 << 20)))

    def _addr(self, node_id: int) -> Tuple[str, int]:
        node = self._routing().nodes.get(node_id)
        if node is None or not node.host:
            raise FsError(Status(Code.RPC_CONNECT_FAILED, f"no address for node {node_id}"))
        return node.host, node.port

    # -- USRBIO ring transport (usrbio/) -------------------------------------

    #: messenger methods that may ride a ring -> wire method id
    _RING_CAPABLE = {
        "read": 3, "write": 1, "update": 2, "write_shard": 13,
        "batch_read": 11, "batch_write": 12, "batch_write_shard": 14,
        "batch_update": 15, "batch_read_rebuild": 21, "chain_encode": 22,
    }

    @property
    def _usrbio_rings(self) -> Dict[int, object]:
        return self._rings.rings

    def _ring_for(self, node_id: int):
        """The node's RingClient, or None (cross-host / unsupported /
        handshake in flight — callers use sockets); the rules are
        ``usrbio/transport.py:RingTable``'s."""
        if not self._usrbio:
            return None
        return self._rings.get(node_id, lambda: self._addr_of(node_id))

    def _addr_of(self, node_id: int):
        """The node's address, or None when routing has none."""
        try:
            return self._addr(node_id)
        except FsError:
            return None

    def _count(self, transport: str, method: str, node_id: int) -> None:
        from tpu3fs_torch.usrbio import transport as _ut

        with self._calls_lock:
            self.transport_calls[(transport, method, node_id)] += 1
        _ut.recorders()[f"calls_{transport}"].add()

    def _ring_fallback(self, node_id: int, ring, e: FsError):
        """Classify a ring-path FsError: transport-level USRBIO codes mean
        "this call goes over sockets" (fatal ones also drop the ring) and
        return None; anything else is a real remote/application error and
        re-raises for the caller's normal handling."""
        self._rings.fallback(node_id, ring, e)
        return None

    def close_rings(self) -> None:
        """Orderly teardown: deregister every ring with its server (so
        the agent worker stops now, not at the next reaper pass) and
        unlink the client-owned shm."""
        self._rings.close()

    @staticmethod
    def _cap_spans(spans, cap: int):
        """Merge contiguous stripe spans down to at most `cap` spans."""
        if len(spans) <= cap:
            return spans
        n = len(spans)
        out = []
        i = 0
        for k in range(cap):
            take = (n - i) // (cap - k)
            out.append((spans[i][0], spans[i + take - 1][1]))
            i += take
        return out

    @staticmethod
    def _read_rsp_est(reqs) -> int:
        """Reply-region data estimate for read-ish ops: requested bytes
        (chunk size stands in for read-to-end) + per-op control slack."""
        return sum(
            r.length if r.length >= 0 else (r.chunk_size or (1 << 20))
            for r in reqs) + 160 * len(reqs)

    def _ring_dispatch(self, ring, method: str, payload):
        """One messenger method over the ring — same reply semantics as
        the socket branches in _dispatch_method. Raises FsError with a
        USRBIO code on ring trouble (caller falls back to sockets)."""
        sid = STORAGE_SERVICE_ID
        if method == "read":
            rsp, segs = ring.call(
                sid, 3, payload, ReadReply, bulk_iovs=(),
                rsp_data_est=self._read_rsp_est([payload]))
            if segs and len(segs[0]):
                rsp = replace(rsp, data=segs[0])
            return rsp
        if method == "batch_read":
            rsp, segs = ring.call(
                sid, 11, BatchReadReq(payload), BatchReadRsp, bulk_iovs=(),
                rsp_data_est=self._read_rsp_est(payload))
            return self._attach_read_segs(rsp.replies, segs)
        if method == "batch_read_rebuild":
            # method 21 is not bulk-capable: inline replies, data in the
            # serde payload — size the region for it
            rsp, _ = ring.call(
                sid, 21, BatchReadReq(payload), BatchReadRsp,
                rsp_data_est=2 * self._read_rsp_est(payload))
            return rsp.replies
        if method in ("write", "update", "write_shard"):
            mid = self._RING_CAPABLE[method]
            ctrl = replace(payload, data=b"")
            rsp, _ = ring.call(sid, mid, ctrl, UpdateReply,
                               req_type=type(payload),
                               bulk_iovs=[payload.data],
                               rsp_data_est=256)
            return rsp
        if method in ("batch_write", "batch_write_shard", "batch_update",
                      "chain_encode"):
            mid, req_cls = self._WRITE_METHODS[method]
            ctrl = req_cls([replace(op, data=b"") for op in payload])
            rsp, _ = ring.call(sid, mid, ctrl, BatchWriteRsp,
                               bulk_iovs=[op.data for op in payload],
                               rsp_data_est=256 * len(payload))
            return rsp.replies
        raise FsError(Status(Code.USRBIO_UNSUPPORTED, method))

    #: transport error codes that count against a peer's breaker (an
    #: application error reply proves the peer alive — never counted)
    _HEALTH_ERROR_CODES = (Code.RPC_CONNECT_FAILED, Code.RPC_PEER_CLOSED,
                           Code.RPC_TIMEOUT, Code.RPC_SEND_FAILED)

    def _guard(self, node_id: int, method: str) -> None:
        """Pre-send gate: the fault plane's send hook, then the breaker.
        Mutating methods to an OPEN-breaker peer fail FAST with the
        retryable PEER_UNHEALTHY (the client ladder refreshes routing and
        retries; the half-open probe re-tests the peer); hedge-safe reads
        always pass — read selection already routes around suspects, and
        a read reaching an open peer is a free probe."""
        from tpu3fs_torch.rpc.idempotency import HEDGE_SAFE_MESSENGER_METHODS
        from tpu3fs_torch.utils.fault_injection import plane as _fault_plane

        try:
            _fault_plane().fire(f"rpc.send.{method}", node=node_id)
        except ConnectionError as e:
            raise FsError(Status(Code.RPC_PEER_CLOSED, str(e)))
        if method in HEDGE_SAFE_MESSENGER_METHODS:
            return
        if not self.health.allow(node_id):
            raise FsError(Status(
                Code.PEER_UNHEALTHY,
                f"breaker open for node {node_id} ({method})"))

    def _observe(self, node_id: int, t0: float, err=None) -> None:
        if err is None:
            self.health.observe(node_id, time.monotonic() - t0, ok=True)
        elif err.code in self._HEALTH_ERROR_CODES:
            self.health.observe(node_id, 0.0, ok=False)
        elif err.code == Code.PEER_UNHEALTHY:
            pass  # our own fail-fast: no new evidence about the peer
        else:
            # an application-level reply: the peer answered — clear any
            # half-open probe by scoring the round trip as a success
            self.health.observe(node_id, time.monotonic() - t0, ok=True)

    @staticmethod
    def _attach_read_segs(replies, segs):
        """Re-attach bulk segments as reply data — ZERO-COPY: each .data
        is a memoryview over the transport's receive buffer, which stays
        alive exactly as long as the views do. Consumers that retain
        replies beyond the request must copy (bytes(data))."""
        if not segs:
            return replies
        return [replace(rp, data=seg) if len(seg) else rp
                for rp, seg in zip(replies, segs)]

    def _stripe_spans(self, reqs) -> List[Tuple[int, int]]:
        """Split one node group into contiguous stripe spans. Groups below
        2x the stripe threshold stay whole (a tiny stripe pays more in
        per-RPC overhead than it wins in parallelism)."""
        n = len(reqs)
        if n <= 1 or self._stripes <= 1:
            return [(0, n)]
        est = sum(
            r.length if r.length >= 0 else (r.chunk_size or (1 << 20))
            for r in reqs)
        if est < 2 * self._stripe_min_bytes:
            return [(0, n)]
        k = min(self._stripes, n,
                max(1, est // self._stripe_min_bytes))
        base, rem = divmod(n, k)
        spans, lo = [], 0
        for i in range(k):
            hi = lo + base + (1 if i < rem else 0)
            spans.append((lo, hi))
            lo = hi
        return spans

    def batch_read_pipelined(self, groups):
        """Striped, pipelined batch-read fan-out: `groups` is
        [(node_id, [ReadReq, ...])]. Every group is split into stripes
        (each a BatchRead RPC on its own pooled connection), ALL requests
        are issued before any reply is collected — so the last node's
        stripes are on the wire while the first node is still reading —
        then replies are collected in issue order. -> per-group reply
        lists aligned with the input reqs; ops a stripe failed for carry
        the transport error code as their reply."""
        pend = []     # (group idx, span lo, span hi,
        #                pending | _RingPending | FsError)
        results = [[None] * len(reqs) for _, reqs in groups]
        c = self._client
        for gi, (node_id, reqs) in enumerate(groups):
            try:
                addr = self._addr(node_id)
            except FsError as e:
                pend.append((gi, 0, len(reqs), e))
                continue
            if not self._bulk:
                # inline wire form: one unstriped call per group (the A/B
                # lever measures framing, not fan-out)
                try:
                    pend.append((gi, 0, len(reqs), c.start_call(
                        addr, STORAGE_SERVICE_ID, 11, BatchReadReq(reqs),
                        BatchReadRsp)))
                    self._count("socket", "batch_read", node_id)
                except FsError as e:
                    pend.append((gi, 0, len(reqs), e))
                continue
            ring = self._ring_for(node_id)
            for lo, hi in self._stripe_spans(reqs):
                span = reqs[lo:hi]
                if ring is not None:
                    # same-host: the stripe rides the shm ring (the
                    # agent dispatches stripes concurrently, so the
                    # socket pipelining shape is preserved)
                    self._count("ring", "batch_read", node_id)
                    try:
                        pend.append((gi, lo, hi, _RingPending(
                            ring, ring.start(
                                STORAGE_SERVICE_ID, 11,
                                BatchReadReq(span), BatchReadRsp,
                                bulk_iovs=(),
                                rsp_data_est=self._read_rsp_est(span)))))
                        continue
                    except FsError as e:
                        ring = self._ring_fallback(node_id, ring, e)
                try:
                    pend.append((gi, lo, hi, c.start_call(
                        addr, STORAGE_SERVICE_ID, 11,
                        BatchReadReq(span), BatchReadRsp,
                        bulk_iovs=())))
                    self._count("socket", "batch_read", node_id)
                except FsError as e:
                    pend.append((gi, lo, hi, e))
        t_issue = time.monotonic()
        for gi, lo, hi, p in pend:
            node_id = groups[gi][0]
            if isinstance(p, FsError):
                err = p
                self._observe(node_id, t_issue, err=err)
            else:
                try:
                    if isinstance(p, _RingPending):
                        try:
                            rsp, segs = p.ring.finish(p.pending)
                        except FsError as e:
                            # ring died mid-call: replay THIS span over a
                            # socket so callers never see a new failure
                            # mode from the fast path
                            self._ring_fallback(node_id, p.ring, e)
                            self._count("socket", "batch_read", node_id)
                            rsp, segs = c.call_bulk(
                                self._addr(node_id), STORAGE_SERVICE_ID,
                                11, BatchReadReq(groups[gi][1][lo:hi]),
                                BatchReadRsp, bulk_iovs=())
                    else:
                        rsp, segs = c.finish_call(p)
                    self._observe(node_id, t_issue)
                    replies = self._attach_read_segs(rsp.replies, segs)
                    results[gi][lo:lo + len(replies)] = replies
                    continue
                except FsError as e:
                    err = e
                    self._observe(node_id, t_issue, err=err)
            # envelope-level sheds (native gates, dispatch admission)
            # carry their retry-after hint only in the message: surface
            # it in the typed field so ladders/hedging honor it
            from tpu3fs_torch.qos.core import retry_after_ms_of

            hint = retry_after_ms_of(err.status.message)
            for i in range(lo, min(hi, len(results[gi]))):
                if results[gi][i] is None:
                    results[gi][i] = ReadReply(err.code,
                                               retry_after_ms=hint)
        for out in results:
            for i, r in enumerate(out):
                if r is None:  # short reply list from a confused server
                    out[i] = ReadReply(Code.RPC_PEER_CLOSED)
        return results

    def _write_stripe_spans(self, ops) -> List[Tuple[int, int]]:
        """Split one node group of write ops into contiguous stripe spans
        (payload-weighted twin of _stripe_spans: write sizes are known
        exactly from the op data, no estimation)."""
        n = len(ops)
        if n <= 1 or self._write_stripes <= 1:
            return [(0, n)]
        est = sum(len(op.data) for op in ops)
        if est < 2 * self._write_stripe_min_bytes:
            return [(0, n)]
        k = min(self._write_stripes, n,
                max(1, est // self._write_stripe_min_bytes))
        base, rem = divmod(n, k)
        spans, lo = [], 0
        for i in range(k):
            hi = lo + base + (1 if i < rem else 0)
            spans.append((lo, hi))
            lo = hi
        return spans

    # wire method ids of the batched write-ish RPCs (bind_storage_service)
    _WRITE_METHODS = {
        "batch_write": (12, BatchWriteReq),
        "batch_write_shard": (14, BatchShardWriteReq),
        "batch_update": (15, BatchWriteReq),
        "chain_encode": (22, BatchShardWriteReq),
    }

    def batch_write_pipelined(self, groups, method: str = "batch_write"):
        """Striped, pipelined batch-write fan-out — the send-side mirror
        of batch_read_pipelined: `groups` is [(node_id, [op, ...])] where
        each op is a WriteReq/ShardWriteReq whose payload rides the bulk
        section (gather-written straight from the caller's buffers, no
        assembly copy). Every group splits into stripes, each a bulk RPC
        on its OWN pooled connection; ALL requests go on the wire before
        any reply is collected, so the server pipelines engine staging of
        stripe K with the upload of stripe K+1 and the chain forward of
        earlier stripes. -> per-group reply lists aligned with the input
        ops; ops a stripe failed for carry the transport error code."""
        method_id, req_cls = self._WRITE_METHODS[method]
        pend = []     # (group idx, span lo, span hi,
        #                pending | _RingPending | FsError)
        results = [[None] * len(ops) for _, ops in groups]
        c = self._client
        for gi, (node_id, ops) in enumerate(groups):
            try:
                self._guard(node_id, method)
                addr = self._addr(node_id)
            except FsError as e:
                pend.append((gi, 0, len(ops), e))
                continue
            if not self._bulk:
                # inline wire form: one unstriped call per group (the A/B
                # lever measures framing, not fan-out)
                try:
                    pend.append((gi, 0, len(ops), c.start_call(
                        addr, STORAGE_SERVICE_ID, method_id, req_cls(ops),
                        BatchWriteRsp)))
                    self._count("socket", method, node_id)
                except FsError as e:
                    pend.append((gi, 0, len(ops), e))
                continue
            ring = self._ring_for(node_id)
            spans = self._write_stripe_spans(ops)
            if ring is not None:
                spans = self._cap_spans(spans, self._ring_write_stripes)
            for lo, hi in spans:
                span = ops[lo:hi]
                ctrl = req_cls([replace(op, data=b"") for op in span])
                if ring is not None:
                    # same-host: payload staged straight into the shared
                    # iov — the server installs from the client's memory
                    self._count("ring", method, node_id)
                    try:
                        pend.append((gi, lo, hi, _RingPending(
                            ring, ring.start(
                                STORAGE_SERVICE_ID, method_id, ctrl,
                                BatchWriteRsp,
                                bulk_iovs=[op.data for op in span],
                                rsp_data_est=256 * len(span)))))
                        continue
                    except FsError as e:
                        ring = self._ring_fallback(node_id, ring, e)
                try:
                    pend.append((gi, lo, hi, c.start_call(
                        addr, STORAGE_SERVICE_ID, method_id, ctrl,
                        BatchWriteRsp,
                        bulk_iovs=[op.data for op in span])))
                    self._count("socket", method, node_id)
                except FsError as e:
                    pend.append((gi, lo, hi, e))
        t_issue = time.monotonic()
        for gi, lo, hi, p in pend:
            node_id = groups[gi][0]
            if isinstance(p, FsError):
                err = p
                self._observe(node_id, t_issue, err=err)
            else:
                try:
                    if isinstance(p, _RingPending):
                        try:
                            rsp, _ = p.ring.finish(p.pending)
                        except FsError as e:
                            # ring died mid-call: the write may or may not
                            # have dispatched — replay over a socket; the
                            # server's exactly-once channel table dedupes
                            # a double-landed update like any retry
                            self._ring_fallback(node_id, p.ring, e)
                            self._count("socket", method, node_id)
                            span = groups[gi][1][lo:hi]
                            rsp, _ = c.call_bulk(
                                self._addr(node_id), STORAGE_SERVICE_ID,
                                method_id,
                                req_cls([replace(op, data=b"")
                                         for op in span]),
                                BatchWriteRsp,
                                bulk_iovs=[op.data for op in span])
                    else:
                        rsp, _ = c.finish_call(p)
                    self._observe(node_id, t_issue)
                    results[gi][lo:lo + len(rsp.replies)] = rsp.replies
                    continue
                except FsError as e:
                    err = e
                    self._observe(node_id, t_issue, err=err)
            # envelope-level sheds (native write gates, dispatch
            # admission) carry their retry-after hint only in the
            # message: surface it in the typed field, mirroring the
            # read-side fill above, so client ladders honor the hint
            # whether the shed came from Python or the C fast path
            from tpu3fs_torch.qos.core import retry_after_ms_of

            hint = retry_after_ms_of(err.status.message)
            for i in range(lo, min(hi, len(results[gi]))):
                if results[gi][i] is None:
                    results[gi][i] = UpdateReply(err.code,
                                                 message=err.status.message,
                                                 retry_after_ms=hint)
        for out in results:
            for i, r in enumerate(out):
                if r is None:  # short reply list from a confused server
                    out[i] = UpdateReply(Code.RPC_PEER_CLOSED)
        return results

    def _one_write(self, addr, method_id: int, op):
        """Single write-ish op: the chunk payload rides the bulk section,
        the control envelope carries everything else — no payload
        concatenation anywhere on the send path."""
        if not self._bulk:
            return self._client.call(addr, STORAGE_SERVICE_ID, method_id,
                                     op, UpdateReply)
        ctrl = replace(op, data=b"")
        rsp, _ = self._client.call_bulk(
            addr, STORAGE_SERVICE_ID, method_id, ctrl, UpdateReply,
            req_type=type(op), bulk_iovs=[op.data])
        return rsp

    def _batch_write(self, addr, method_id: int, ops, req_cls):
        if not self._bulk:
            return self._client.call(addr, STORAGE_SERVICE_ID, method_id,
                                     req_cls(ops), BatchWriteRsp).replies
        iovs = [op.data for op in ops]
        ctrl = req_cls([replace(op, data=b"") for op in ops])
        rsp, _ = self._client.call_bulk(
            addr, STORAGE_SERVICE_ID, method_id, ctrl, BatchWriteRsp,
            bulk_iovs=iovs)
        return rsp.replies

    def __call__(self, node_id: int, method: str, payload):
        self._guard(node_id, method)
        t0 = time.monotonic()
        try:
            out = self._dispatch_method(node_id, method, payload)
        except FsError as e:
            self._observe(node_id, t0, err=e)
            raise
        self._observe(node_id, t0)
        return out

    def _dispatch_method(self, node_id: int, method: str, payload):
        ring = (self._ring_for(node_id)
                if method in self._RING_CAPABLE else None)
        if ring is not None:
            self._count("ring", method, node_id)
            try:
                return self._ring_dispatch(ring, method, payload)
            except FsError as e:
                # ring-level trouble means "use sockets", never an op
                # failure; application/remote codes propagate unchanged
                self._ring_fallback(node_id, ring, e)
        addr = self._addr(node_id)
        if method in self._RING_CAPABLE:
            self._count("socket", method, node_id)
        c = self._client
        sid = STORAGE_SERVICE_ID
        if method == "write":
            return self._one_write(addr, 1, payload)
        if method == "update":
            return self._one_write(addr, 2, payload)
        if method == "read":
            if not self._bulk:
                return c.call(addr, sid, 3, payload, ReadReply)
            # empty bulk section = "I speak bulk; reply with data in bulk"
            rsp, segs = c.call_bulk(addr, sid, 3, payload, ReadReply,
                                    bulk_iovs=())
            if segs and len(segs[0]):
                # ZERO-COPY hand-off: .data is a memoryview over the
                # transport's receive buffer (alive as long as the view);
                # consumers that retain replies must copy (bytes(data))
                rsp = replace(rsp, data=segs[0])
            return rsp
        if method == "dump_chunkmeta":
            return c.call(addr, sid, 4, TargetIdReq(payload), ChunkMetaList).metas
        if method == "dump_pending_chunkmeta":
            return c.call(addr, sid, 20, TargetIdReq(payload),
                          ChunkMetaList).metas
        if method == "sync_done":
            c.call(addr, sid, 5, TargetIdReq(payload), Empty)
            return None
        if method == "remove_chunk":
            return bool(c.call(addr, sid, 6, RemoveChunkReq(*payload), IntReply).value)
        if method == "remove_file_chunks":
            return c.call(addr, sid, 7, FileChunksReq(*payload), IntReply).value
        if method == "query_last_chunk":
            r = c.call(addr, sid, 8, FileChunksReq(*payload), PairReply)
            return r.a, r.b
        if method == "truncate_file_chunks":
            return c.call(addr, sid, 9, TruncateChunksReq(*payload), IntReply).value
        if method == "space_info":
            return c.call(addr, sid, 10, Empty(), SpaceInfo)
        if method == "batch_read":
            if not self._bulk:
                return c.call(addr, sid, 11, BatchReadReq(payload),
                              BatchReadRsp).replies
            rsp, segs = c.call_bulk(addr, sid, 11, BatchReadReq(payload),
                                    BatchReadRsp, bulk_iovs=())
            return self._attach_read_segs(rsp.replies, segs)
        if method == "batch_write":
            return self._batch_write(addr, 12, payload, BatchWriteReq)
        if method == "write_shard":
            return self._one_write(addr, 13, payload)
        if method == "batch_write_shard":
            return self._batch_write(addr, 14, payload, BatchShardWriteReq)
        if method == "batch_update":
            return self._batch_write(addr, 15, payload, BatchWriteReq)
        if method == "chain_encode":
            return self._batch_write(addr, 22, payload, BatchShardWriteReq)
        if method == "stat_chunks":
            rsp = c.call(addr, sid, 16, StatChunksReq(*payload), StatChunksRsp)
            return [tuple(t) for t in rsp.stats]
        if method == "read_rebuild":
            return c.call(addr, sid, 19, payload, ReadReply)
        if method == "batch_read_rebuild":
            return c.call(addr, sid, 21, BatchReadReq(payload),
                          BatchReadRsp).replies
        raise FsError(Status(Code.RPC_METHOD_NOT_FOUND, method))


# -- mgmtd ------------------------------------------------------------------

def bind_mgmtd_service(server: RpcServer, mgmtd: Mgmtd) -> ServiceDef:
    s = ServiceDef(MGMTD_SERVICE_ID, "Mgmtd")

    def heartbeat(req: HeartbeatReq) -> HeartbeatReply:
        states = {t: LocalTargetState(v) for t, v in req.local_states.items()}
        return mgmtd.heartbeat(req.node_id, req.hb_version, states,
                               meta_loads=req.meta_loads or None)

    def routing(req: RoutingReq) -> RoutingRsp:
        ri = mgmtd.get_routing_info(req.known_version)
        return RoutingRsp(changed=ri is not None, routing=ri)

    def register(req: RegisterNodeReq) -> Empty:
        mgmtd.register_node(
            req.node_id, NodeType(req.node_type), req.host, req.port
        )
        return Empty()

    def serving_register(req: ServingRegisterReq) -> Empty:
        mgmtd.serving_register(req.node_id, req.host, req.port,
                               ttl_s=req.ttl_s)
        return Empty()

    def serving_unregister(req: ServingUnregisterReq) -> Empty:
        mgmtd.serving_unregister(req.node_id)
        return Empty()

    s.method(1, "heartbeat", HeartbeatReq, HeartbeatReply, heartbeat)
    s.method(2, "getRoutingInfo", RoutingReq, RoutingRsp, routing)
    s.method(3, "registerNode", RegisterNodeReq, Empty, register)
    # 4-16 are the admin half (bind_mgmtd_admin); serving-directory ops
    # are ForClient-role like registerNode, so they live here
    s.method(17, "servingRegister", ServingRegisterReq, Empty,
             serving_register)
    s.method(18, "servingUnregister", ServingUnregisterReq, Empty,
             serving_unregister)
    server.add_service(s)
    return s


class MgmtdRpcClient:
    """Routing-info poller + heartbeat sender over RPC (ref MgmtdClient's
    ForClient/ForServer split: this class serves both roles).

    Accepts ONE address or a LIST of mgmtd addresses (ref MgmtdClient's
    server list): calls stick to the last-good server and fail over on
    transport errors or MGMTD_NOT_PRIMARY — a dead primary's lease
    expires and a standby's tick acquires it, so rotating through the
    list finds the new primary."""

    # codes that mean "try the next mgmtd in the list"
    _FAILOVER_CODES = (
        Code.RPC_CONNECT_FAILED, Code.RPC_PEER_CLOSED, Code.RPC_TIMEOUT,
        Code.RPC_SEND_FAILED, Code.MGMTD_NOT_PRIMARY,
    )

    def __init__(self, addr, client: Optional[RpcClient] = None, *,
                 routing_ttl_s: float = 0.0):
        try:
            if (isinstance(addr, (tuple, list)) and len(addr) == 2
                    and isinstance(addr[0], str)):
                addrs = [(addr[0], int(addr[1]))]
            else:
                addrs = [(a[0], int(a[1])) for a in addr]
            ok = bool(addrs) and all(isinstance(h, str) for h, _ in addrs)
        except (TypeError, ValueError, IndexError):
            ok = False
            addrs = []
        if not ok:
            raise ValueError(f"bad mgmtd address list: {addr!r}")
        self._addrs = addrs
        self._cursor = 0
        self._client = client or RpcClient()
        self._routing: Optional[RoutingInfo] = None
        # refresh_routing TTL: with ttl 0 (default) every call is an RPC
        # (legacy behavior); a positive ttl serves the cached snapshot and
        # only polls mgmtd when it expires — data-plane hot paths resolve
        # node addresses on EVERY op, and one getRoutingInfo round trip
        # per read was a measured double-digit share of served-read time.
        # Retry ladders call invalidate_routing() before re-resolving, so
        # failover convergence does not wait out the TTL.
        self._routing_ttl_s = float(routing_ttl_s)
        self._routing_ts = float("-inf")

    @property
    def _addr(self):  # sticky current server (back-compat accessor)
        return self._addrs[self._cursor % len(self._addrs)]

    def _call(self, method_id: int, req, rsp_type):
        last: Optional[FsError] = None
        for i in range(len(self._addrs)):
            addr = self._addrs[(self._cursor + i) % len(self._addrs)]
            try:
                out = self._client.call(addr, MGMTD_SERVICE_ID, method_id,
                                        req, rsp_type)
            except FsError as e:
                if e.code in self._FAILOVER_CODES:
                    last = e
                    continue
                raise
            self._cursor = (self._cursor + i) % len(self._addrs)
            return out
        raise last  # every server refused/unreachable

    def register_node(self, node_id: int, node_type: NodeType,
                      host: str = "", port: int = 0) -> None:
        self._call(3, RegisterNodeReq(node_id, int(node_type), host, port),
                   Empty)

    def serving_register(self, node_id: int, host: str, port: int,
                         ttl_s: float = 30.0) -> None:
        self._call(17, ServingRegisterReq(node_id, host, port, ttl_s),
                   Empty)

    def serving_unregister(self, node_id: int) -> None:
        self._call(18, ServingUnregisterReq(node_id), Empty)

    def heartbeat(
        self, node_id: int, hb_version: int,
        local_states: Optional[Dict[int, LocalTargetState]] = None,
        meta_loads: Optional[Dict[int, float]] = None,
    ) -> HeartbeatReply:
        req = HeartbeatReq(
            node_id, hb_version,
            {t: int(v) for t, v in (local_states or {}).items()},
            meta_loads=dict(meta_loads or {}),
        )
        return self._call(1, req, HeartbeatReply)

    def invalidate_routing(self) -> None:
        """Expire the TTL cache now: the next refresh_routing polls mgmtd.
        Called by retry ladders before re-resolving a failed op."""
        self._routing_ts = float("-inf")

    def known_routing_version(self) -> int:
        """Version of the cached snapshot (-1 = none yet) — lets the
        heartbeat loop detect a routing bump in the reply and expire the
        TTL cache promptly (no full-TTL stale window after a demotion)."""
        return self._routing.version if self._routing is not None else -1

    def refresh_routing(self) -> RoutingInfo:
        import time as _time

        if (self._routing is not None and self._routing_ttl_s > 0
                and _time.monotonic() - self._routing_ts
                < self._routing_ttl_s):
            return self._routing
        known = self._routing.version if self._routing else -1
        rsp = self._call(2, RoutingReq(known), RoutingRsp)
        if rsp.changed and rsp.routing is not None:
            # MONOTONIC install only: after a failover rotation a lagging
            # standby may answer with an OLDER snapshot — installing it
            # would resurrect targets the primary already rotated out
            if self._routing is None or \
                    rsp.routing.version > self._routing.version:
                self._routing = rsp.routing
        self._routing_ts = _time.monotonic()
        assert self._routing is not None
        return self._routing

    def routing(self) -> RoutingInfo:
        if self._routing is None:
            return self.refresh_routing()
        return self._routing


# -- meta -------------------------------------------------------------------

@dataclass
class PathReq:
    path: str
    uid: int = 0
    gid: int = 0
    follow: bool = True
    token: str = ""


@dataclass
class XattrReq:
    path: str
    name: str = ""
    value: bytes = b""
    uid: int = 0
    gid: int = 0
    token: str = ""
    flags: int = 0   # XATTR_CREATE / XATTR_REPLACE


@dataclass
class XattrRsp:
    value: bytes = b""
    names: List[str] = field(default_factory=list)


@dataclass
class CreateReq:
    path: str
    uid: int = 0
    gid: int = 0
    perm: int = 0o644
    flags: int = 0
    chunk_size: int = 0
    stripe: int = 0
    client_id: str = ""
    token: str = ""
    # explicit chain placement (MetaStore.create layout= parity): the
    # ckpt archiver creating files on EC chains over RPC (trailing
    # field; older encoders omit it and decoders default to None)
    layout: Optional[Layout] = None


@dataclass
class BatchCreateReq:
    items: List[BatchCreateItem] = field(default_factory=list)
    uid: int = 0
    gid: int = 0
    token: str = ""


@dataclass
class BatchCreateRspItem:
    ok: bool = False
    inode: Optional[Inode] = None
    session_id: str = ""
    code: int = 0
    message: str = ""


@dataclass
class BatchCreateRsp:
    results: List[BatchCreateRspItem] = field(default_factory=list)


@dataclass
class OpenReq:
    path: str
    uid: int = 0
    gid: int = 0
    flags: int = 1
    client_id: str = ""
    token: str = ""


@dataclass
class CloseReq:
    inode_id: int
    session_id: str
    length_hint: int = -1
    client_id: str = ""
    request_id: str = ""
    wrote: int = -1  # -1 unknown, 0 read-only session, 1 wrote
    token: str = ""


@dataclass
class BatchCloseReq:
    items: List[BatchCloseItem] = field(default_factory=list)
    token: str = ""


@dataclass
class BatchCloseRspItem:
    ok: bool = False
    inode: Optional[Inode] = None
    code: int = 0
    message: str = ""


@dataclass
class BatchCloseRsp:
    results: List[BatchCloseRspItem] = field(default_factory=list)


@dataclass
class MkdirsReq:
    path: str
    uid: int = 0
    gid: int = 0
    perm: int = 0o755
    recursive: bool = False
    token: str = ""


@dataclass
class RemoveReq:
    path: str
    uid: int = 0
    gid: int = 0
    recursive: bool = False
    client_id: str = ""
    request_id: str = ""
    token: str = ""


@dataclass
class RenameReq:
    src: str
    dst: str
    uid: int = 0
    gid: int = 0
    token: str = ""


@dataclass
class SymlinkReq:
    path: str
    target: str
    uid: int = 0
    gid: int = 0
    token: str = ""


@dataclass
class HardLinkReq:
    src: str
    dst: str
    uid: int = 0
    gid: int = 0
    token: str = ""


@dataclass
class ListReq:
    path: str
    uid: int = 0
    gid: int = 0
    limit: int = 0
    prefix: str = ""
    token: str = ""


@dataclass
class ListRsp:
    entries: List[DirEntry] = field(default_factory=list)


@dataclass
class SetAttrReq:
    path: str
    uid: int = 0
    gid: int = 0
    perm: int = -1
    new_uid: int = -1
    new_gid: int = -1
    # explicit has_* flags: negative times are legitimate (pre-epoch)
    atime: float = 0.0
    mtime: float = 0.0
    has_atime: bool = False
    has_mtime: bool = False
    token: str = ""


@dataclass
class BatchSetAttrReq:
    """Batched time touch (atime/mtime only — see MetaStore.batch_set_attr
    for why ownership changes stay single-op). Address by paths OR by
    inode_ids (walk-free; exactly one list may be non-empty)."""

    paths: List[str] = field(default_factory=list)
    inode_ids: List[int] = field(default_factory=list)
    uid: int = 0
    gid: int = 0
    atime: float = 0.0
    mtime: float = 0.0
    has_atime: bool = False
    has_mtime: bool = False
    token: str = ""


@dataclass
class BatchSetAttrRsp:
    # per-item inode-or-error, same shape as a batched close settle
    results: List[BatchCloseRspItem] = field(default_factory=list)


@dataclass
class TruncateReq:
    path: str
    length: int
    uid: int = 0
    gid: int = 0
    token: str = ""


@dataclass
class SyncReq:
    inode_id: int
    length_hint: int = -1
    token: str = ""


@dataclass
class PruneSessionReq:
    client_id: str
    token: str = ""


@dataclass
class BatchStatReq:
    inode_ids: List[int] = field(default_factory=list)
    token: str = ""


@dataclass
class BatchStatRsp:
    inodes: List[Optional[Inode]] = field(default_factory=list)


@dataclass
class BatchMkdirsReq:
    """Batched ensure-directory (mkdir -p semantics by default) — the
    kvcache cold-drain shape: one RPC for every uncached shard dir
    instead of one mkdirs round trip per directory."""

    paths: List[str] = field(default_factory=list)
    uid: int = 0
    gid: int = 0
    perm: int = 0o755
    recursive: bool = True
    exist_ok: bool = True
    token: str = ""


@dataclass
class BatchMkdirsRsp:
    # per-item inode-or-error, same shape as a batched close settle
    results: List[BatchCloseRspItem] = field(default_factory=list)


@dataclass
class RenamePrepareReq:
    """Phase B of a cross-partition rename/hardlink, sent by the
    coordinator to the participant partition's owner
    (tpu3fs/metashard/twophase.py). Idempotent per intent.txn_id."""

    intent: "IntentRecord"
    dst_path: str = ""
    token: str = ""


@dataclass
class RenameFinishReq:
    """Best-effort post-commit cleanup: clear the participant's prepare
    record. Losing this RPC is harmless — the resolver clears orphan
    prepare records whose intent is gone."""

    txn_id: str = ""
    token: str = ""


@dataclass
class RenameResolveReq:
    """Admin/recovery surface: converge dangling two-phase records
    (resolve_intents). ``force`` ignores intent deadlines — only for
    quiesced clusters and tests."""

    force: bool = False
    token: str = ""


@dataclass
class StrReply:
    value: str = ""


@dataclass
class InodeRsp:
    inode: Inode


@dataclass
class OpenRsp:
    inode: Inode
    session_id: str = ""


@dataclass
class StatFsReq:
    token: str = ""


@dataclass
class AuthReq:
    token: str = ""


@dataclass
class AuthRsp:
    uid: int = 0
    gid: int = 0
    name: str = ""
    admin: bool = False


def bind_meta_service(server: RpcServer, meta: MetaStore, *,
                      user_store=None, acl_ttl_s: float = 5.0,
                      tenant_mode: str = "enforce") -> None:
    """With a user_store, every op authenticates its bearer token through a
    TTL AclCache and the SERVER derives identity from the user record —
    claimed uid/gid in requests are ignored (ref UserStore + AclCache;
    MetaSerde has an authenticate method the same way). Without one,
    requests are trusted (single-tenant/dev mode, like the reference run
    without token enforcement).

    Tenant binding (docs/tenancy.md): when the authenticated user record
    carries a nonempty ``tenant``, the wire-declared ``u1.*`` tenant must
    match it. ``tenant_mode="enforce"`` rejects mismatches with
    META_NO_PERMISSION; ``"permissive"`` (compat for old clients) only
    counts them on ``meta.tenant_mismatch``. Unbound users and untenanted
    requests always pass — enforcement bites only where an admin
    explicitly bound a tenant."""
    s = ServiceDef(META_SERVICE_ID, "MetaSerde")

    acl_cache = None
    if user_store is not None:
        from tpu3fs_torch.core.user import AclCache

        acl_cache = AclCache(user_store, ttl_s=acl_ttl_s)

    def _check_tenant(rec) -> None:
        bound = getattr(rec, "tenant", "")
        if not bound:
            return
        from tpu3fs_torch.metashard import metrics as _ms_metrics
        from tpu3fs_torch.tenant import current_tenant

        declared = current_tenant()
        if declared is None or declared == bound:
            return
        _ms_metrics.tenant_mismatch.add()
        if tenant_mode == "enforce":
            raise _err(
                Code.META_NO_PERMISSION,
                f"tenant {declared!r} not bound to user {rec.name!r} "
                f"(bound: {bound!r})")

    def _auth(req):
        rec = acl_cache.authenticate(getattr(req, "token", ""))
        _check_tenant(rec)
        return rec

    def u(req) -> User:
        if acl_cache is None:
            return User(req.uid, req.gid)
        return _auth(req).as_user()

    def gate(req) -> None:
        """Session-scoped ops (statFs) carry no path identity but still
        require a valid bearer token in auth mode."""
        if acl_cache is not None:
            _auth(req)

    def su(req) -> Optional[User]:
        """Resolved identity for session-scoped ops (sync/close/batchStat):
        None in dev mode (store skips authorization), the token's user in
        auth mode — so the store's PERM_W/PERM_R guards actually run."""
        if acl_cache is None:
            return None
        return _auth(req).as_user()

    def prune_session(req: PruneSessionReq) -> IntReply:
        if acl_cache is None:
            return IntReply(meta.prune_session(req.client_id))
        rec = acl_cache.authenticate(req.token)
        return IntReply(meta.prune_session(
            req.client_id, rec.as_user(), admin=rec.admin))

    def authenticate(req: AuthReq) -> AuthRsp:
        if acl_cache is None:
            return AuthRsp(0, 0, "root", True)
        rec = acl_cache.authenticate(req.token)
        return AuthRsp(rec.uid, rec.gid, rec.name, rec.admin)

    s.method(18, "authenticate", AuthReq, AuthRsp, authenticate)

    s.method(1, "statFs", StatFsReq, StatFs,
             lambda r: (gate(r), meta.stat_fs())[1])
    s.method(2, "stat", PathReq, InodeRsp,
             lambda r: InodeRsp(meta.stat(r.path, u(r), follow=r.follow)))
    s.method(3, "create", CreateReq, OpenRsp, lambda r: _open_rsp(
        meta.create(r.path, u(r), r.perm, flags=r.flags,
                    chunk_size=r.chunk_size or None, stripe=r.stripe or None,
                    client_id=r.client_id, layout=r.layout)))
    s.method(4, "mkdirs", MkdirsReq, InodeRsp, lambda r: InodeRsp(
        meta.mkdirs(r.path, u(r), r.perm, recursive=r.recursive)))
    s.method(5, "symlink", SymlinkReq, InodeRsp,
             lambda r: InodeRsp(meta.symlink(r.path, r.target, u(r))))
    s.method(6, "hardLink", HardLinkReq, InodeRsp,
             lambda r: InodeRsp(meta.hard_link(r.src, r.dst, u(r))))
    s.method(7, "remove", RemoveReq, Empty, lambda r: (
        meta.remove(r.path, u(r), recursive=r.recursive,
                    client_id=r.client_id, request_id=r.request_id), Empty())[1])
    s.method(8, "open", OpenReq, OpenRsp, lambda r: _open_rsp(
        meta.open(r.path, u(r), flags=r.flags, client_id=r.client_id)))
    s.method(9, "sync", SyncReq, InodeRsp, lambda r: InodeRsp(
        meta.sync(r.inode_id,
                  length_hint=None if r.length_hint < 0 else r.length_hint,
                  user=su(r))))
    s.method(10, "close", CloseReq, InodeRsp, lambda r: InodeRsp(
        meta.close(r.inode_id, r.session_id,
                   length_hint=None if r.length_hint < 0 else r.length_hint,
                   client_id=r.client_id, request_id=r.request_id,
                   wrote=None if r.wrote < 0 else bool(r.wrote),
                   user=su(r))))
    s.method(11, "rename", RenameReq, Empty,
             lambda r: (meta.rename(r.src, r.dst, u(r)), Empty())[1])
    s.method(12, "list", ListReq, ListRsp, lambda r: ListRsp(
        meta.list_dir(r.path, u(r), limit=r.limit, prefix=r.prefix)))
    s.method(13, "truncate", TruncateReq, InodeRsp,
             lambda r: InodeRsp(meta.truncate(r.path, r.length, u(r))))
    s.method(14, "getRealPath", PathReq, StrReply,
             lambda r: StrReply(meta.get_real_path(r.path, u(r))))
    s.method(15, "setAttr", SetAttrReq, InodeRsp, lambda r: InodeRsp(
        meta.set_attr(r.path, u(r),
                      perm=None if r.perm < 0 else r.perm,
                      uid=None if r.new_uid < 0 else r.new_uid,
                      gid=None if r.new_gid < 0 else r.new_gid,
                      atime=r.atime if r.has_atime else None,
                      mtime=r.mtime if r.has_mtime else None)))
    s.method(16, "pruneSession", PruneSessionReq, IntReply, prune_session)
    s.method(17, "batchStat", BatchStatReq, BatchStatRsp,
             lambda r: BatchStatRsp(meta.batch_stat(r.inode_ids, user=su(r))))
    s.method(19, "setXattr", XattrReq, InodeRsp, lambda r: InodeRsp(
        meta.set_xattr(r.path, r.name, r.value, u(r), flags=r.flags)))
    s.method(20, "getXattr", XattrReq, XattrRsp, lambda r: XattrRsp(
        value=meta.get_xattr(r.path, r.name, u(r))))
    s.method(21, "listXattrs", XattrReq, XattrRsp, lambda r: XattrRsp(
        names=meta.list_xattrs(r.path, u(r))))
    s.method(22, "removeXattr", XattrReq, InodeRsp, lambda r: InodeRsp(
        meta.remove_xattr(r.path, r.name, u(r))))

    def batch_close(r):
        # one transaction per 64 closes (ref BatchOperation.cc:750)
        out = []
        for res in meta.batch_close(r.items, user=su(r)):
            if isinstance(res, FsError):
                out.append(BatchCloseRspItem(
                    ok=False, code=int(res.code),
                    message=res.status.message))
            else:
                out.append(BatchCloseRspItem(ok=True, inode=res))
        return BatchCloseRsp(out)

    s.method(23, "batchClose", BatchCloseReq, BatchCloseRsp, batch_close)

    def batch_set_attr(r: BatchSetAttrReq) -> BatchSetAttrRsp:
        out = []
        for res in meta.batch_set_attr(
                r.paths if r.paths or not r.inode_ids else None, u(r),
                inode_ids=r.inode_ids or None,
                atime=r.atime if r.has_atime else None,
                mtime=r.mtime if r.has_mtime else None):
            if isinstance(res, FsError):
                out.append(BatchCloseRspItem(
                    ok=False, code=int(res.code),
                    message=res.status.message))
            else:
                out.append(BatchCloseRspItem(ok=True, inode=res))
        return BatchSetAttrRsp(out)

    s.method(24, "batchSetAttr", BatchSetAttrReq, BatchSetAttrRsp,
             batch_set_attr)

    def batch_create(r: BatchCreateReq) -> BatchCreateRsp:
        # one transaction per 64 creates (MetaStore.batch_create) — the
        # create fan-in that unblocks the kvcache write-back drain
        out = []
        for res in meta.batch_create(r.items, u(r)):
            if isinstance(res, FsError):
                out.append(BatchCreateRspItem(
                    ok=False, code=int(res.code),
                    message=res.status.message))
            else:
                out.append(BatchCreateRspItem(
                    ok=True, inode=res.inode, session_id=res.session_id))
        return BatchCreateRsp(out)

    s.method(25, "batchCreate", BatchCreateReq, BatchCreateRsp, batch_create)

    def batch_mkdirs(r: BatchMkdirsReq) -> BatchMkdirsRsp:
        # directory fan-in for the kvcache drain: the per-item _ensure_dir
        # mkdirs collapse into chunked transactions (MetaStore.batch_mkdirs)
        out = []
        for res in meta.batch_mkdirs(r.paths, u(r), perm=r.perm,
                                     recursive=r.recursive,
                                     exist_ok=r.exist_ok):
            if isinstance(res, FsError):
                out.append(BatchCloseRspItem(
                    ok=False, code=int(res.code),
                    message=res.status.message))
            else:
                out.append(BatchCloseRspItem(ok=True, inode=res))
        return BatchMkdirsRsp(out)

    s.method(26, "batchMkdirs", BatchMkdirsReq, BatchMkdirsRsp, batch_mkdirs)

    # Two-phase participant plane (cross-partition rename/hardlink): bound
    # only when the store is sharded. All three are replay-safe — prepare
    # and finish are idempotent behind the prepare record, resolve converges
    # (rpc/idempotency.py TWOPHASE rows; tools/check_rpc_registry.py check 9).
    if hasattr(meta, "twophase_prepare"):
        def rename_prepare(r: RenamePrepareReq) -> Empty:
            meta.twophase_prepare(r.intent, r.dst_path, u(r))
            return Empty()

        def rename_finish(r: RenameFinishReq) -> Empty:
            gate(r)
            meta.twophase_finish(r.txn_id)
            return Empty()

        def rename_resolve(r: RenameResolveReq) -> IntReply:
            if acl_cache is not None:
                rec = _auth(r)
                if not (rec.admin or rec.root):
                    raise _err(Code.META_NO_PERMISSION,
                               "renameResolve requires admin")
            return IntReply(meta.resolve_intents(force=r.force))

        s.method(27, "renamePrepare", RenamePrepareReq, Empty, rename_prepare)
        s.method(28, "renameFinish", RenameFinishReq, Empty, rename_finish)
        s.method(29, "renameResolve", RenameResolveReq, IntReply,
                 rename_resolve)

    server.add_service(s)


def _open_rsp(res: OpenResult) -> OpenRsp:
    return OpenRsp(res.inode, res.session_id)


class MetaRpcClient:
    """Full meta API over RPC with server failover
    (ref MetaClient.h:55-226 + ServerSelectionStrategy).

    With an ``mgmtd`` routing source (MgmtdRpcClient or anything with
    routing()/refresh_routing()/invalidate_routing()), every op routes to
    the OWNER of its metadata partition first (docs/metashard.md): by-path
    ops hash the parent directory, by-inode ops read the id's partition
    tag, and batched ops fan out per-partition in parallel, merging
    per-item results back in request order. A META_WRONG_PARTITION answer
    means the table is stale — refresh and retry the new owner, then fall
    back to the failover ladder (non-owners keep answering retryable
    WRONG_PARTITION, so the ladder converges on the owner regardless).
    Without mgmtd the client behaves exactly as before: one server ladder,
    one batch RPC."""

    def __init__(
        self,
        addrs: List[Tuple[str, int]],
        client: Optional[RpcClient] = None,
        client_id: str = "",
        token: str = "",
        *,
        mgmtd=None,
        nparts: int = DEFAULT_PARTITIONS,
    ):
        if not addrs:
            raise ValueError("need at least one meta server address")
        self._addrs = list(addrs)
        self._client = client or RpcClient()
        self.client_id = client_id
        self.token = token
        self._cursor = 0
        self._mgmtd = mgmtd
        self.nparts = nparts

    def authenticate(self, token: Optional[str] = None) -> "AuthRsp":
        return self._call(18, AuthReq(self.token if token is None else token),
                          AuthRsp)

    # -- partition routing --------------------------------------------------

    def _pid_path(self, path: str) -> Optional[int]:
        return (partition_of_path(path, self.nparts)
                if self._mgmtd is not None else None)

    def _pid_dir(self, path: str) -> Optional[int]:
        return (partition_of_dir(path, self.nparts)
                if self._mgmtd is not None else None)

    def _pid_inode(self, inode_id: int) -> Optional[int]:
        return (partition_of_inode(inode_id, self.nparts)
                if self._mgmtd is not None else None)

    def _owner_addr(self, pid: int) -> Optional[Tuple[str, int]]:
        try:
            node = self._mgmtd.routing().meta_owner(pid)
        except FsError:
            return None  # mgmtd unreachable: the ladder still converges
        if node is None or not node.host:
            return None
        return (node.host, node.port)

    def _call(self, method_id: int, req, rsp_type, *, pid: Optional[int] = None):
        if self.token and hasattr(req, "token") and not req.token:
            req.token = self.token
        if pid is not None and self._mgmtd is not None:
            addr = self._owner_addr(pid)
            if addr is not None:
                try:
                    return self._client.call(
                        addr, META_SERVICE_ID, method_id, req, rsp_type)
                except FsError as e:
                    if not e.status.retryable():
                        raise
                    if e.status.code == Code.META_WRONG_PARTITION:
                        # stale partition table: refresh, retry new owner
                        try:
                            self._mgmtd.invalidate_routing()
                            self._mgmtd.refresh_routing()
                        except FsError:
                            pass
                        addr2 = self._owner_addr(pid)
                        if addr2 is not None and addr2 != addr:
                            try:
                                return self._client.call(
                                    addr2, META_SERVICE_ID, method_id, req,
                                    rsp_type)
                            except FsError as e2:
                                if not e2.status.retryable():
                                    raise
                    # fall through to the ladder
        last: Optional[FsError] = None
        for i in range(len(self._addrs)):
            addr = self._addrs[(self._cursor + i) % len(self._addrs)]
            try:
                out = self._client.call(addr, META_SERVICE_ID, method_id, req, rsp_type)
                self._cursor = (self._cursor + i) % len(self._addrs)
                return out
            except FsError as e:
                if e.status.retryable():
                    last = e
                    continue  # evict failing server: try the next
                raise
        assert last is not None
        raise last

    def _fan_batches(self, pids, items, call_one):
        """Run one batch RPC per partition group (threads when >1 group),
        merging per-item results back in request order. ``pids[i]`` may be
        None (unrouted mode) — then everything goes out as one batch."""
        items = list(items)
        if not items:
            return []
        groups: Dict[Optional[int], List[Tuple[int, object]]] = {}
        for i, (pid, it) in enumerate(zip(pids, items)):
            groups.setdefault(pid, []).append((i, it))
        if len(groups) == 1:
            (pid, pairs), = groups.items()
            return call_one(pid, [it for _, it in pairs])
        out: List[object] = [None] * len(items)

        def run(pid, pairs):
            res = call_one(pid, [it for _, it in pairs])
            for (i, _), r in zip(pairs, res):
                out[i] = r

        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(8, len(groups))) as ex:
            for f in [ex.submit(run, pid, pairs)
                      for pid, pairs in groups.items()]:
                f.result()
        return out

    # NOTE on `user=` below: in-process MetaStore callers pass an explicit
    # User; over RPC the server derives identity from the bearer token
    # (claimed uids are ignored in auth mode), so the kwarg is accepted
    # for surface compatibility (utils/trash.py, ckpt retention) and
    # dropped on the wire.

    def stat(self, path: str, user=None, *, follow: bool = True) -> Inode:
        return self._call(2, PathReq(path, follow=follow), InodeRsp,
                          pid=self._pid_path(path)).inode

    def create(self, path: str, **kw) -> OpenRsp:
        kw.pop("user", None)
        kw.setdefault("client_id", self.client_id)
        return self._call(3, CreateReq(path, **kw), OpenRsp,
                          pid=self._pid_path(path))

    def mkdirs(self, path: str, user=None, perm: int = 0o755,
               *, recursive: bool = False) -> Inode:
        return self._call(4, MkdirsReq(path, perm=perm,
                                       recursive=recursive), InodeRsp,
                          pid=self._pid_path(path)).inode

    def remove(self, path: str, user=None, *, recursive: bool = False,
               request_id: str = "") -> None:
        self._call(7, RemoveReq(path, recursive=recursive,
                                client_id=self.client_id, request_id=request_id), Empty,
                   pid=self._pid_path(path))

    def open(self, path: str, flags: int = 1,
             client_id: Optional[str] = None) -> OpenRsp:
        return self._call(8, OpenReq(path, flags=flags,
                                     client_id=client_id or self.client_id),
                          OpenRsp, pid=self._pid_path(path))

    def close(self, inode_id: int, session_id: str,
              length_hint: Optional[int] = None,
              request_id: str = "", wrote: Optional[bool] = None) -> Inode:
        hint = -1 if length_hint is None else length_hint
        w = -1 if wrote is None else int(wrote)
        return self._call(10, CloseReq(inode_id, session_id, hint,
                                       self.client_id, request_id, w),
                          InodeRsp, pid=self._pid_inode(inode_id)).inode

    def batch_create(self, items: List[BatchCreateItem],
                     user=None) -> List[object]:
        """Create many files in O(len/64) server transactions; each
        result is an OpenResult or an FsError (MetaStore parity — the
        kvcache flusher and the ckpt archiver drive either surface).
        Items without a client_id inherit this client's. Routed mode fans
        the batch per parent-dir partition in parallel."""
        items = list(items)
        for it in items:
            if not it.client_id:
                it.client_id = self.client_id

        def one(pid, sub):
            rsp = self._call(25, BatchCreateReq(sub), BatchCreateRsp, pid=pid)
            return [OpenResult(r.inode, r.session_id) if r.ok
                    else FsError(Status(Code(r.code), r.message))
                    for r in rsp.results]

        return self._fan_batches(
            [self._pid_path(it.path) for it in items], items, one)

    def batch_close(self, items: List[BatchCloseItem]) -> List[object]:
        """Settle many sessions in O(len/64) server transactions; each
        result is an Inode or an FsError (per-item failures don't poison
        batch-mates). Ref BatchOperation.cc:750."""
        items = list(items)

        def one(pid, sub):
            rsp = self._call(23, BatchCloseReq(sub), BatchCloseRsp, pid=pid)
            return [r.inode if r.ok
                    else FsError(Status(Code(r.code), r.message))
                    for r in rsp.results]

        return self._fan_batches(
            [self._pid_inode(it.inode_id) for it in items], items, one)

    def batch_mkdirs(self, paths: List[str], user=None, perm: int = 0o755,
                     *, recursive: bool = True,
                     exist_ok: bool = True) -> List[object]:
        """Make many directories in O(len/64) server transactions; each
        result is an Inode or an FsError. The kvcache drain's _ensure_dir
        fan-in (one RPC per partition instead of one per directory)."""
        paths = list(paths)

        def one(pid, sub):
            rsp = self._call(
                26, BatchMkdirsReq(sub, perm=perm, recursive=recursive,
                                   exist_ok=exist_ok),
                BatchMkdirsRsp, pid=pid)
            return [r.inode if r.ok
                    else FsError(Status(Code(r.code), r.message))
                    for r in rsp.results]

        return self._fan_batches(
            [self._pid_path(p) for p in paths], paths, one)

    def symlink(self, path: str, target: str) -> Inode:
        return self._call(5, SymlinkReq(path, target), InodeRsp,
                          pid=self._pid_path(path)).inode

    def hard_link(self, src: str, dst: str) -> Inode:
        # dst's owner coordinates the cross-partition protocol
        # (docs/metashard.md: the link lands on dst's partition)
        return self._call(6, HardLinkReq(src, dst), InodeRsp,
                          pid=self._pid_path(dst)).inode

    def sync(self, inode_id: int, length_hint: Optional[int] = None) -> Inode:
        hint = -1 if length_hint is None else length_hint
        return self._call(9, SyncReq(inode_id, hint), InodeRsp,
                          pid=self._pid_inode(inode_id)).inode

    def truncate(self, path: str, length: int) -> Inode:
        return self._call(13, TruncateReq(path, length), InodeRsp,
                          pid=self._pid_path(path)).inode

    def set_attr(self, path: str, *, perm: Optional[int] = None,
                 uid: Optional[int] = None, gid: Optional[int] = None,
                 atime: Optional[float] = None,
                 mtime: Optional[float] = None) -> Inode:
        req = SetAttrReq(
            path,
            perm=-1 if perm is None else perm,
            new_uid=-1 if uid is None else uid,
            new_gid=-1 if gid is None else gid,
            atime=atime or 0.0,
            mtime=mtime or 0.0,
            has_atime=atime is not None,
            has_mtime=mtime is not None,
        )
        return self._call(15, req, InodeRsp, pid=self._pid_path(path)).inode

    def batch_set_attr(self, paths: Optional[List[str]] = None, user=None,
                       *, inode_ids: Optional[List[int]] = None,
                       atime: Optional[float] = None,
                       mtime: Optional[float] = None) -> List[object]:
        """Touch many inodes' times in one RPC (per partition), by path or
        walk-free by inode id (MetaStore parity: each result is an Inode
        or an FsError; per-item failures don't poison batch-mates)."""
        kw = dict(atime=atime or 0.0, mtime=mtime or 0.0,
                  has_atime=atime is not None, has_mtime=mtime is not None)

        def unpack(rsp):
            return [r.inode if r.ok
                    else FsError(Status(Code(r.code), r.message))
                    for r in rsp.results]

        if inode_ids is not None:
            def one(pid, sub):
                return unpack(self._call(
                    24, BatchSetAttrReq([], list(sub), **kw),
                    BatchSetAttrRsp, pid=pid))

            return self._fan_batches(
                [self._pid_inode(i) for i in inode_ids], inode_ids, one)

        def one(pid, sub):
            return unpack(self._call(
                24, BatchSetAttrReq(list(sub), [], **kw),
                BatchSetAttrRsp, pid=pid))

        return self._fan_batches(
            [self._pid_path(p) for p in (paths or [])], paths or [], one)

    def prune_session(self, client_id: str) -> int:
        return self._call(16, PruneSessionReq(client_id), IntReply).value

    def batch_stat(self, inode_ids: List[int]) -> List[Optional[Inode]]:
        def one(pid, sub):
            return self._call(17, BatchStatReq(list(sub)),
                              BatchStatRsp, pid=pid).inodes

        return self._fan_batches(
            [self._pid_inode(i) for i in inode_ids], inode_ids, one)

    def batch_stat_by_path(self, paths: List[str]) -> List[Optional[Inode]]:
        """Missing/forbidden paths come back as None (MetaStore parity —
        consumers like the ckpt loader and kvcache batch_get treat None
        as a miss)."""
        out: List[Optional[Inode]] = []
        for p in paths:
            try:
                out.append(self.stat(p))
            except FsError:
                out.append(None)
        return out

    def rename(self, src: str, dst: str, user=None) -> None:
        # src's owner coordinates (it clears the src dirent at commit);
        # cross-partition dst lands via the renamePrepare participant RPC
        self._call(11, RenameReq(src, dst), Empty, pid=self._pid_path(src))

    def list_dir(self, path: str, user=None, *, limit: int = 0,
                 prefix: str = "") -> List[DirEntry]:
        return self._call(12, ListReq(path, limit=limit, prefix=prefix), ListRsp,
                          pid=self._pid_dir(path)).entries

    def stat_fs(self) -> StatFs:
        return self._call(1, StatFsReq(), StatFs)

    def set_xattr(self, path: str, name: str, value: bytes,
                  *, flags: int = 0) -> Inode:
        return self._call(
            19, XattrReq(path, name=name, value=value, flags=flags),
            InodeRsp, pid=self._pid_path(path)).inode

    def get_xattr(self, path: str, name: str) -> bytes:
        return self._call(20, XattrReq(path, name=name), XattrRsp,
                          pid=self._pid_path(path)).value

    def list_xattrs(self, path: str) -> List[str]:
        return self._call(21, XattrReq(path), XattrRsp,
                          pid=self._pid_path(path)).names

    def remove_xattr(self, path: str, name: str) -> Inode:
        return self._call(22, XattrReq(path, name=name), InodeRsp,
                          pid=self._pid_path(path)).inode

    def get_real_path(self, path: str) -> str:
        return self._call(14, PathReq(path), StrReply,
                          pid=self._pid_path(path)).value

    # -- two-phase participant plane (server-to-server; docs/metashard.md) --

    def rename_prepare(self, pid: int, intent: "IntentRecord",
                       dst_path: str = "") -> None:
        """Apply one prepare on the participant owning partition ``pid``
        (idempotent behind the prepare record — safe to re-send)."""
        self._call(27, RenamePrepareReq(intent, dst_path), Empty, pid=pid)

    def rename_finish(self, pid: int, txn_id: str) -> None:
        """Best-effort prepare-record GC after commit (idempotent)."""
        self._call(28, RenameFinishReq(txn_id), Empty, pid=pid)

    def rename_resolve(self, *, force: bool = False) -> int:
        """Drive the crash resolver on a server (admin in auth mode);
        returns how many dangling intents it converged."""
        return self._call(29, RenameResolveReq(force), IntReply).value


# -- core (embedded in every server; ref CoreService) ------------------------

def bind_core_service(server: RpcServer, *, config=None, on_shutdown=None) -> None:
    s = ServiceDef(CORE_SERVICE_ID, "Core")
    s.method(1, "echo", EchoReq, EchoRsp, lambda r: EchoRsp(r.text))

    def render(_r: Empty) -> StrReply:
        return StrReply(config.render_toml() if config is not None else "")

    # last hot-update record (ref CoreServiceDef.h getLastConfigUpdateRecord)
    last_update = {"time": 0.0, "seq": 0, "ok": True, "detail": ""}

    def hot_update(req: StrReply) -> Empty:
        import time as _time

        if config is not None:
            # config.py's shim: stdlib tomllib on 3.11+, tomli on 3.10
            from tpu3fs_torch.utils.config import tomllib
            from tpu3fs_torch.monitor.flight import flight

            last_update["seq"] += 1
            last_update["time"] = _time.time()
            try:
                config.hot_update(_flatten(tomllib.loads(req.value)))
                last_update["ok"], last_update["detail"] = True, ""
                flight().record("config", ok=True, source="core-rpc",
                                nbytes=len(req.value))
            except Exception as e:
                last_update["ok"], last_update["detail"] = False, str(e)
                flight().record("config", ok=False, source="core-rpc",
                                error=repr(e))
                raise
        return Empty()

    def last_record(_r: Empty) -> StrReply:
        import json

        return StrReply(json.dumps(last_update))

    s.method(2, "renderConfig", Empty, StrReply, render)
    s.method(3, "hotUpdateConfig", StrReply, Empty, hot_update)
    # getConfig: same rendered TOML; the ref splits getConfig/renderConfig by
    # template-vs-effective view, both reduce to the live tree here
    s.method(5, "getConfig", Empty, StrReply, render)
    s.method(6, "getLastConfigUpdateRecord", Empty, StrReply, last_record)

    def shutdown(_r: Empty) -> Empty:
        if on_shutdown is not None:
            on_shutdown()
        return Empty()

    # flight recorder: dump THIS process's black box to disk on demand
    # (admin_cli flight-dump; the SLO-breach path rides the collector
    # Ack dump-epoch instead — see monitor/flight.py)
    def flight_dump(req: FlightDumpReq) -> FlightDumpRsp:
        from tpu3fs_torch.monitor.flight import flight

        fl = flight()
        path = fl.dump(req.path or None, reason="flightDump rpc")
        return FlightDumpRsp(path=path, events=len(fl.snapshot()))

    s.method(4, "shutdown", Empty, Empty, shutdown)
    s.method(7, "flightDump", FlightDumpReq, FlightDumpRsp, flight_dump)
    server.add_service(s)


def _flatten(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


# -- mgmtd admin ------------------------------------------------------------
# Admin half of the Mgmtd service (ref MgmtdServiceDef.h setChainTable/
# updateChain/setConfig/getConfig ops driven by admin_cli).

@dataclass
class CreateTargetReq:
    target_id: int
    node_id: int = 0
    disk_index: int = 0


@dataclass
class UploadChainReq:
    chain_id: int
    target_ids: List[int] = field(default_factory=list)
    # EC(k, m) chain tables (0,0 = CR replication chain); mirrors the
    # chain_table_type axis of the reference's placement solver
    # (deploy/data_placement/src/model/data_placement.py:30)
    ec_k: int = 0
    ec_m: int = 0


@dataclass
class UploadChainTableReq:
    table_id: int
    chain_ids: List[int] = field(default_factory=list)


@dataclass
class AddChainTargetReq:
    chain_id: int
    target_id: int
    node_id: int
    disk_index: int = 0
    replace_of: int = 0   # EC: member whose shard slot the target takes


@dataclass
class DropChainTargetReq:
    chain_id: int
    target_id: int
    min_serving: int = 1  # quorum floor the chain must keep after the drop


@dataclass
class SetNodeTagsReq:
    node_id: int
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class MigrationSubmitReq:
    specs: List[MoveSpec] = field(default_factory=list)


@dataclass
class MigrationIdsRsp:
    job_ids: List[int] = field(default_factory=list)


@dataclass
class MigrationJobsRsp:
    jobs: List[MigrationJob] = field(default_factory=list)


@dataclass
class MigrationClaimReq:
    worker: str
    max_jobs: int = 4
    lease_s: float = 30.0


@dataclass
class MigrationReportReq:
    job_id: int
    worker: str
    phase: int = -1        # -1 = progress/renewal only, no transition
    copied_chunks: int = 0
    copied_bytes: int = 0
    error: str = ""
    lease_s: float = 30.0


@dataclass
class SetConfigReq:
    node_type: int
    content: str = ""


@dataclass
class GetConfigReq:
    node_type: int


@dataclass
class ConfigRsp:
    content: str = ""
    version: int = 0


def bind_mgmtd_admin(service: "ServiceDef", mgmtd: Mgmtd) -> None:
    """Extra admin methods registered on the Mgmtd service table."""

    def create_target(req: CreateTargetReq) -> Empty:
        mgmtd.create_target(req.target_id, node_id=req.node_id,
                            disk_index=req.disk_index)
        return Empty()

    def upload_chain(req: UploadChainReq) -> Empty:
        mgmtd.upload_chain(req.chain_id, req.target_ids,
                           ec_k=req.ec_k, ec_m=req.ec_m)
        return Empty()

    def upload_chain_table(req: UploadChainTableReq) -> Empty:
        mgmtd.upload_chain_table(req.table_id, req.chain_ids)
        return Empty()

    def set_config(req: SetConfigReq) -> IntReply:
        return IntReply(mgmtd.set_config(NodeType(req.node_type), req.content))

    def get_config(req: GetConfigReq) -> ConfigRsp:
        blob = mgmtd.get_config(NodeType(req.node_type))
        return ConfigRsp(blob.content, blob.version)

    def tick(_r: Empty) -> IntReply:
        mgmtd.tick()
        return IntReply(mgmtd.get_routing_info().version)

    # -- elasticity: live chain mutation + crash-safe migration jobs -------
    def add_chain_target(req: AddChainTargetReq) -> Empty:
        mgmtd.add_chain_target(req.chain_id, req.target_id, req.node_id,
                               disk_index=req.disk_index,
                               replace_of=req.replace_of)
        return Empty()

    def drop_chain_target(req: DropChainTargetReq) -> Empty:
        mgmtd.drop_chain_target(req.chain_id, req.target_id,
                                min_serving=req.min_serving)
        return Empty()

    def set_node_tags(req: SetNodeTagsReq) -> Empty:
        mgmtd.set_node_tags(req.node_id, req.tags)
        return Empty()

    def migration_submit(req: MigrationSubmitReq) -> MigrationIdsRsp:
        return MigrationIdsRsp(mgmtd.migration_submit(req.specs))

    def migration_list(_r: Empty) -> MigrationJobsRsp:
        return MigrationJobsRsp(mgmtd.migration_list())

    def migration_claim(req: MigrationClaimReq) -> MigrationJobsRsp:
        return MigrationJobsRsp(mgmtd.migration_claim(
            req.worker, max_jobs=req.max_jobs, lease_s=req.lease_s))

    def migration_report(req: MigrationReportReq) -> MigrationJobsRsp:
        job = mgmtd.migration_report(
            req.job_id, req.worker,
            phase=(req.phase if req.phase >= 0 else None),
            copied_chunks=req.copied_chunks,
            copied_bytes=req.copied_bytes,
            error=req.error, lease_s=req.lease_s)
        return MigrationJobsRsp([job])

    service.method(4, "createTarget", CreateTargetReq, Empty, create_target)
    service.method(5, "uploadChain", UploadChainReq, Empty, upload_chain)
    service.method(6, "uploadChainTable", UploadChainTableReq, Empty,
                   upload_chain_table)
    service.method(7, "setConfig", SetConfigReq, IntReply, set_config)
    service.method(8, "getConfig", GetConfigReq, ConfigRsp, get_config)
    service.method(9, "tick", Empty, IntReply, tick)
    service.method(10, "addChainTarget", AddChainTargetReq, Empty,
                   add_chain_target)
    service.method(11, "dropChainTarget", DropChainTargetReq, Empty,
                   drop_chain_target)
    service.method(12, "setNodeTags", SetNodeTagsReq, Empty, set_node_tags)
    service.method(13, "migrationSubmit", MigrationSubmitReq,
                   MigrationIdsRsp, migration_submit)
    service.method(14, "migrationList", Empty, MigrationJobsRsp,
                   migration_list)
    service.method(15, "migrationClaim", MigrationClaimReq,
                   MigrationJobsRsp, migration_claim)
    service.method(16, "migrationReport", MigrationReportReq,
                   MigrationJobsRsp, migration_report)


class MgmtdAdminRpcClient(MgmtdRpcClient):
    """ForAdmin role: same method names as the in-process Mgmtd so AdminCli
    and launchers work against a live cluster unchanged."""

    def create_target(self, target_id: int, node_id: int = 0,
                      disk_index: int = 0) -> None:
        self._call(4, CreateTargetReq(target_id, node_id, disk_index),
                   Empty)

    def upload_chain(self, chain_id: int, target_ids: List[int],
                     *, ec_k: int = 0, ec_m: int = 0) -> None:
        self._call(
            5,
            UploadChainReq(chain_id, list(target_ids), ec_k=ec_k, ec_m=ec_m),
            Empty)

    def upload_chain_table(self, table_id: int, chain_ids: List[int]) -> None:
        self._call(6, UploadChainTableReq(table_id, list(chain_ids)),
                   Empty)

    def set_config(self, node_type: NodeType, content: str) -> int:
        return self._call(7, SetConfigReq(int(node_type), content),
                          IntReply).value

    def get_config(self, node_type: NodeType):
        return self._call(8, GetConfigReq(int(node_type)), ConfigRsp)

    def tick(self) -> int:
        return self._call(9, Empty(), IntReply).value

    # -- elasticity (same names/signatures as the in-process Mgmtd) -------
    def add_chain_target(self, chain_id: int, target_id: int, node_id: int,
                         *, disk_index: int = 0, replace_of: int = 0) -> None:
        self._call(10, AddChainTargetReq(chain_id, target_id, node_id,
                                         disk_index, replace_of), Empty)

    def drop_chain_target(self, chain_id: int, target_id: int,
                          *, min_serving: int = 1) -> None:
        self._call(11, DropChainTargetReq(chain_id, target_id, min_serving),
                   Empty)

    def set_node_tags(self, node_id: int, tags: Dict[str, str]) -> None:
        self._call(12, SetNodeTagsReq(node_id, dict(tags)), Empty)

    def migration_submit(self, specs: List[MoveSpec]) -> List[int]:
        return self._call(13, MigrationSubmitReq(list(specs)),
                          MigrationIdsRsp).job_ids

    def migration_list(self) -> List[MigrationJob]:
        return self._call(14, Empty(), MigrationJobsRsp).jobs

    def migration_claim(self, worker: str, *, max_jobs: int = 4,
                        lease_s: float = 30.0) -> List[MigrationJob]:
        return self._call(15, MigrationClaimReq(worker, max_jobs, lease_s),
                          MigrationJobsRsp).jobs

    def migration_report(self, job_id: int, worker: str, *,
                         phase=None, copied_chunks: int = 0,
                         copied_bytes: int = 0, error: str = "",
                         lease_s: float = 30.0) -> MigrationJob:
        rsp = self._call(16, MigrationReportReq(
            job_id, worker,
            phase=(-1 if phase is None else int(phase)),
            copied_chunks=copied_chunks, copied_bytes=copied_bytes,
            error=error, lease_s=lease_s), MigrationJobsRsp)
        return rsp.jobs[0]

    def get_routing_info(self, known_version: int = -1):
        if known_version >= 0:
            rsp = self._call(2, RoutingReq(known_version), RoutingRsp)
            return rsp.routing if rsp.changed else None
        return self.refresh_routing()
