"""USRBIO ring transport: serde RPCs over shared-memory rings.

The port's own copy of ``tpu3fs/usrbio/transport.py`` (the same wire
types, framing and method table). Two additions. ``RingTable`` holds one
client's rings and the rules for making, dropping and remaking them,
which the storage messenger and the serving peer client share. A
``RingClient`` knows the pid of the process it registered with
(``agent_pid``, from the handshake), and once that process has exited a
call fails at once with the fatal USRBIO_AGENT_GONE instead of waiting
out the call timeout, so a client re-handshakes with a restarted storage
or serving process. It also counts its completions and the bytes the agent moved for them
(``completions``, ``bytes_moved``), as the agent's ``usrbio.completed``
and ``usrbio.bytes`` recorders count them on the other side.

The client half of the tentpole wiring (ROADMAP item: kill the single-host
wire ceiling): a co-located client speaks whole storage RPCs through an
``IoRing`` — one RPC-mode SQE per (possibly batched) call, the serialized
request staged in a registered ``Iov`` region, the reply (control + bulk
data) landing in a client-designated region of the SAME shm, gathered there
straight from engine buffer views by the storage process's ring agent
(tpu3fs/usrbio/server.py). Zero sockets, zero kernel copies, no per-op
syscall beyond the semaphore doorbell — the analogue of the reference's
USRBIO data path (hf3fs_usrbio.h) where RDMA moves bytes directly between
storage and user-registered buffers.

``RpcMessenger`` (tpu3fs/rpc/services.py) selects this transport
transparently for same-host storage nodes (shm-nonce handshake) and falls
back to the pipelined sockets on any USRBIO-class failure, so FileIoClient,
FUSE, dataload and kvcache inherit the fast path with no API change.

QoS class, tenant id, deadline and trace context ride the SQE itself — the
class bits at their envelope flag positions and the ``t1.*``/``d1.*``/
``u1.*`` token string in the SQE token field — and admission happens at
ring dequeue through the SAME ``dispatch_packet`` entry the socket
transports use, so the shm path is structurally unable to bypass
enforcement (tools/check_rpc_registry.py check 7).
"""

from __future__ import annotations

import os
import struct
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from tpu3fs_torch.rpc.net import pack_bulk_header, split_bulk
from tpu3fs_torch.rpc.serde import deserialize, serialize
from tpu3fs_torch.usrbio.ring import RSP_HDR, TOKEN_CAP, Iov, IoRing
from tpu3fs_torch.utils.result import Code, FsError, Status

#: control-plane service the storage binary binds for ring registration
#: (tpu3fs/usrbio/server.py bind_usrbio_service)
USRBIO_SERVICE_ID = 6

#: shm prefix of the handshake nonce files the serving process creates;
#: clients refuse to read any other path the server might name
from tpu3fs_torch.usrbio.ring import HS_PREFIX as HANDSHAKE_PREFIX

#: (service_id, method_id) -> (service name, method name): the ONLY RPCs
#: an RPC-mode SQE may carry. The ring agent refuses everything else with
#: USRBIO_UNSUPPORTED, and check_rpc_registry check 7 statically verifies
#: every row is bound by the storage binary and fully classified
#: (QoS + idempotency + tenant), so the shm path can never grow a
#: dispatch surface the admission stack does not know.
RING_METHODS: Dict[Tuple[int, int], Tuple[str, str]] = {
    (3, 1): ("StorageSerde", "write"),
    (3, 2): ("StorageSerde", "update"),
    (3, 3): ("StorageSerde", "read"),
    (3, 11): ("StorageSerde", "batchRead"),
    (3, 12): ("StorageSerde", "batchWrite"),
    (3, 13): ("StorageSerde", "writeShard"),
    (3, 14): ("StorageSerde", "batchWriteShard"),
    (3, 15): ("StorageSerde", "batchUpdate"),
    (3, 21): ("StorageSerde", "batchReadRebuild"),
    (3, 22): ("StorageSerde", "chainEncodeWrite"),
    # fleet serving data plane: co-located peer fills skip the loopback
    # stack (tpu3fs/serving — the serving binary binds Usrbio too, so
    # its agent dispatches peerRead into its own Serving table)
    (7, 1): ("Serving", "peerRead"),
}

_U32 = struct.Struct("<I")

#: USRBIO failure codes: the messenger treats every one as "use sockets
#: for this call", never as an op failure surfaced to ladders
TRANSPORT_CODES = frozenset({
    Code.USRBIO_RING_FULL, Code.USRBIO_BAD_IOV, Code.USRBIO_AGENT_GONE,
    Code.USRBIO_TORN_RING, Code.USRBIO_REPLY_OVERFLOW,
    Code.USRBIO_UNSUPPORTED,
})

#: codes after which the ring itself is unusable (re-handshake needed)
FATAL_CODES = frozenset({Code.USRBIO_AGENT_GONE, Code.USRBIO_TORN_RING})


# -- control-plane wire types (bound by bind_usrbio_service) -----------------

@dataclass
class UsrbioHandshakeRsp:
    supported: bool = False
    nonce_name: str = ""     # /dev/shm file holding the same-host proof
    pid: int = 0             # serving process (diagnostics)


@dataclass
class UsrbioRegisterReq:
    ring_name: str
    iov_name: str = ""
    entries: int = 0
    iov_size: int = 0
    owner_pid: int = 0
    nonce: str = ""          # hex of the nonce file's bytes: proves the
    #                          client reads the server's /dev/shm


@dataclass
class UsrbioRegisterRsp:
    ok: bool = False
    message: str = ""


@dataclass
class UsrbioDeregisterReq:
    ring_name: str


# -- observability (single declaration site for the usrbio.* family) ---------

_RECORDERS = None
_REC_LOCK = threading.Lock()


def recorders():
    """usrbio.* metric family (docs/observability.md): submitted/completed
    SQEs and bytes moved on the agent side, ring_full refusals on the
    client side, live agent dispatch depth. The port adds the
    messengers' data-plane calls by transport (``calls_ring``,
    ``calls_socket``), so a process's fallbacks to sockets show."""
    global _RECORDERS
    if _RECORDERS is None:
        with _REC_LOCK:
            if _RECORDERS is None:
                from tpu3fs_torch.monitor.recorder import (
                    CounterRecorder,
                    ValueRecorder,
                )

                _RECORDERS = {
                    "submitted": CounterRecorder("usrbio.submitted"),
                    "completed": CounterRecorder("usrbio.completed"),
                    "ring_full": CounterRecorder("usrbio.ring_full"),
                    "bytes": CounterRecorder("usrbio.bytes"),
                    "agent_depth": ValueRecorder("usrbio.agent_depth"),
                    "calls_ring": CounterRecorder("usrbio.calls_ring"),
                    "calls_socket": CounterRecorder("usrbio.calls_socket"),
                }
    return _RECORDERS


# -- request / reply region framing (both halves) ----------------------------

def request_size(payload: bytes, bulk_iovs) -> int:
    n = _U32.size + len(payload)
    if bulk_iovs is not None:
        n += len(pack_bulk_header(bulk_iovs)) + sum(
            len(b) for b in bulk_iovs)
    return n


def stage_request(iov: Iov, offset: int, payload: bytes, bulk_iovs) -> int:
    """Write [u32 payload_len][payload][bulk header + segments] at
    ``offset``; -> total bytes staged. The bulk copy here is the ring
    write path's ONE client-side copy (the socket path pays the same copy
    into the kernel)."""
    buf = iov.buf
    pos = offset
    buf[pos:pos + 4] = _U32.pack(len(payload))
    pos += 4
    buf[pos:pos + len(payload)] = payload
    pos += len(payload)
    if bulk_iovs is not None:
        hdr = pack_bulk_header(bulk_iovs)
        buf[pos:pos + len(hdr)] = hdr
        pos += len(hdr)
        for seg in bulk_iovs:
            n = len(seg)
            if n:
                buf[pos:pos + n] = seg
            pos += n
    return pos - offset


def parse_request(region: memoryview, has_bulk: bool):
    """Agent side: -> (payload bytes, bulk segment views | None). Views
    alias the client's shm — valid for the synchronous dispatch only."""
    if len(region) < 4:
        raise FsError(Status(Code.USRBIO_BAD_IOV, "request region short"))
    (plen,) = _U32.unpack(bytes(region[:4]))
    if 4 + plen > len(region):
        raise FsError(Status(Code.USRBIO_BAD_IOV,
                             "request payload overruns region"))
    payload = bytes(region[4:4 + plen])
    bulk = None
    if has_bulk:
        try:
            bulk = split_bulk(region[4 + plen:])
        except ConnectionError as e:
            raise FsError(Status(Code.USRBIO_BAD_IOV, str(e)))
    return payload, bulk


def write_reply(iov: Iov, offset: int, capacity: int, status: int,
                message: str, payload: bytes, reply_iovs) -> int:
    """Agent side: write [RSP_HDR][msg][payload][bulk] into the client's
    reply region — the engine-view -> registered-shm gather that replaces
    the socket's writev + recv copies. -> total bytes, or -1 when the
    reply does not fit ``capacity`` (client sees USRBIO_REPLY_OVERFLOW
    and retries over sockets)."""
    msg_b = message.encode("utf-8")
    bulk_hdr = b""
    bulk_len = 0
    if reply_iovs is not None:
        bulk_hdr = pack_bulk_header(reply_iovs)
        bulk_len = len(bulk_hdr) + sum(len(s) for s in reply_iovs)
    total = RSP_HDR.size + len(msg_b) + len(payload) + bulk_len
    if total > capacity:
        return -1
    buf = iov.buf
    pos = offset
    buf[pos:pos + RSP_HDR.size] = RSP_HDR.pack(
        status & 0xFFFFFFFF, len(msg_b), len(payload), bulk_len)
    pos += RSP_HDR.size
    buf[pos:pos + len(msg_b)] = msg_b
    pos += len(msg_b)
    buf[pos:pos + len(payload)] = payload
    pos += len(payload)
    if reply_iovs is not None:
        buf[pos:pos + len(bulk_hdr)] = bulk_hdr
        pos += len(bulk_hdr)
        for seg in reply_iovs:
            n = len(seg)
            if n:
                buf[pos:pos + n] = seg
            pos += n
    return total


def parse_reply(region: memoryview, total: int):
    """Client side: validate the reply framing against the CQE-reported
    ``total`` (torn/short replies surface as typed USRBIO errors, never
    as silently-wrong bytes) -> (status, message, payload bytes,
    bulk segment views | None)."""
    if total < RSP_HDR.size or total > len(region):
        raise FsError(Status(Code.USRBIO_TORN_RING,
                             f"reply length {total} escapes region"))
    status, msg_len, payload_len, bulk_len = RSP_HDR.unpack(
        bytes(region[:RSP_HDR.size]))
    if RSP_HDR.size + msg_len + payload_len + bulk_len != total:
        raise FsError(Status(Code.USRBIO_TORN_RING,
                             "reply header inconsistent with CQE length"))
    pos = RSP_HDR.size
    message = bytes(region[pos:pos + msg_len]).decode("utf-8", "replace")
    pos += msg_len
    payload = bytes(region[pos:pos + payload_len])
    pos += payload_len
    bulk = None
    if bulk_len:
        try:
            bulk = split_bulk(region[pos:pos + bulk_len])
        except ConnectionError as e:
            raise FsError(Status(Code.USRBIO_TORN_RING, str(e)))
    return status, message, payload, bulk


# -- shm arena ----------------------------------------------------------------

_ALIGN = 64


class _ShmArena:
    """First-fit free-list allocator over one registered Iov. Reply
    regions are exported as numpy-backed memoryviews with a finalizer:
    the region returns to the free list when the LAST view over it dies —
    the shm analogue of the socket path's detached receive buffers
    (consumers that retain replies past the request must copy)."""

    def __init__(self, iov: Iov):
        import numpy as np

        self._iov = iov
        self._np = np.frombuffer(iov.buf, dtype=np.uint8)
        self._lock = threading.Lock()
        self._free: List[Tuple[int, int]] = [(0, iov.size)]
        # prefault every page ONCE at setup: a fresh tmpfs mapping would
        # otherwise pay an allocating page fault per 4 KiB on the first
        # pass through the buffer — measured ~2x on the first big batch
        # (the server side then pays only cheap minor faults)
        self._np[::4096] = 0

    def alloc(self, n: int) -> Optional[int]:
        n = (n + _ALIGN - 1) & ~(_ALIGN - 1)
        with self._lock:
            for i, (off, size) in enumerate(self._free):
                if size >= n:
                    if size == n:
                        del self._free[i]
                    else:
                        self._free[i] = (off + n, size - n)
                    return off
        return None

    def free(self, off: int, n: int) -> None:
        n = (n + _ALIGN - 1) & ~(_ALIGN - 1)
        with self._lock:
            self._free.append((off, n))
            self._free.sort()
            merged: List[Tuple[int, int]] = []
            for o, s in self._free:
                if merged and merged[-1][0] + merged[-1][1] == o:
                    merged[-1] = (merged[-1][0], merged[-1][1] + s)
                else:
                    merged.append((o, s))
            self._free = merged

    def tracked_view(self, off: int, n: int) -> memoryview:
        """A memoryview over [off, off+n) whose region self-frees when all
        views over it are garbage (the exporting ndarray slice is weakref-
        finalized; every sub-slice of the returned view keeps it alive)."""
        sub = self._np[off:off + n]
        weakref.finalize(sub, self.free, off, n)
        return memoryview(sub)


# -- the ring transport client -----------------------------------------------

def _cleanup_shm(ring: IoRing, iov: Iov) -> None:
    """GC/exit finalizer for a RingClient's shm pair: the orderly half of
    the lifecycle for clients never closed explicitly — runs both when a
    client is garbage-collected mid-process AND at interpreter exit
    (weakref.finalize registers atexit). The crash half is the agent
    reaper's dead-owner-pid pass."""
    try:
        ring.close()
    except Exception:
        pass
    try:
        iov.close()
    except Exception:
        pass


def process_alive(pid: int) -> bool:
    """True while ``pid`` runs (a zombie, killed but not yet waited for,
    counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read()
    except OSError:
        return False
    return stat[stat.rindex(b")") + 2:][:1] != b"Z"


class _Pending:
    __slots__ = ("userdata", "rsp_type", "req_off", "req_size",
                 "rsp_off", "rsp_cap", "rpc_ctx", "t0", "nbytes", "bulk")

    def __init__(self, userdata, rsp_type, req_off, req_size, rsp_off,
                 rsp_cap, rpc_ctx, t0, nbytes, bulk=0):
        self.userdata = userdata
        self.rsp_type = rsp_type
        self.req_off = req_off
        self.req_size = req_size
        self.rsp_off = rsp_off
        self.rsp_cap = rsp_cap
        self.rpc_ctx = rpc_ctx
        self.t0 = t0
        self.nbytes = nbytes
        self.bulk = bulk


class RingClient:
    """One ring + iov pair against one co-located storage process,
    multiplexing whole serde RPCs from many threads: ``start`` preps an
    RPC-mode SQE (pipelined — many starts before any finish), ``finish``
    waits for its CQE and parses the reply out of shared memory. Raises
    FsError with a 12xx USRBIO code on transport-level trouble (the
    messenger's cue to use sockets) and the remote status code on
    application errors, exactly like RpcClient."""

    def __init__(self, entries: int = 128, iov_bytes: int = 64 << 20,
                 call_timeout: float = 30.0):
        self.iov = Iov(iov_bytes)
        self.ring = IoRing(entries, for_read=True)
        self._arena = _ShmArena(self.iov)
        self._sq_lock = threading.Lock()
        self._cv = threading.Condition()
        self._done: Dict[int, int] = {}
        #: ops whose caller gave up at a per-call deadline while the op
        #: was still in flight: userdata -> ((req_off, req_size),
        #: (rsp_off, rsp_cap)). The agent may yet read the request and
        #: WILL write the reply region, so both regions stay allocated
        #: until the late CQE is reaped (freed at publish, reply dropped).
        self._abandoned: Dict[int, tuple] = {}
        self._reaping = False
        self._next_ud = 0
        self._call_timeout = call_timeout
        self.closed = False
        #: pid and address of the serving process this ring is
        #: registered with (0 and None = unknown): a dead agent fails
        #: calls at once (agent_alive)
        self.agent_pid = 0
        self.agent_addr = None
        self.completions = 0
        self.bytes_moved = 0
        self._finalizer = weakref.finalize(
            self, _cleanup_shm, self.ring, self.iov)

    # -- issue ---------------------------------------------------------------
    def start(self, service_id: int, method_id: int, req, rsp_type, *,
              req_type=None, bulk_iovs=None, rsp_data_est: int = 0):
        """Serialize + stage + prep + doorbell. ``rsp_data_est`` sizes the
        reply region's data share (reads pass the requested byte total);
        control slack is added on top."""
        from tpu3fs_torch.analytics import spans as _spans
        from tpu3fs_torch.qos.core import class_to_flags, current_class
        from tpu3fs_torch.rpc.net import encode_envelope_message

        if self.closed:
            raise FsError(Status(Code.USRBIO_AGENT_GONE, "ring closed"))
        if not self.agent_alive():
            raise FsError(Status(Code.USRBIO_AGENT_GONE,
                                 f"agent process {self.agent_pid} exited"))
        tctx = _spans.current_trace()
        rpc_ctx = tctx.child() if tctx is not None else None
        token = encode_envelope_message(rpc_ctx)
        if len(token.encode("utf-8")) > TOKEN_CAP:
            raise FsError(Status(
                Code.USRBIO_BAD_IOV,
                f"envelope token exceeds SQE field ({len(token)} chars)"))
        payload = serialize(req, req_type or type(req))
        req_size = request_size(payload, bulk_iovs)
        rsp_cap = RSP_HDR.size + 4096 + int(rsp_data_est)
        req_off = self._arena.alloc(req_size)
        if req_off is None:
            raise FsError(Status(Code.USRBIO_RING_FULL,
                                 f"iov arena exhausted ({req_size}B req)"))
        rsp_off = self._arena.alloc(rsp_cap)
        if rsp_off is None:
            self._arena.free(req_off, req_size)
            raise FsError(Status(Code.USRBIO_RING_FULL,
                                 f"iov arena exhausted ({rsp_cap}B rsp)"))
        t0 = time.monotonic()
        try:
            stage_request(self.iov, req_off, payload, bulk_iovs)
            with self._sq_lock:
                self._next_ud += 1
                ud = self._next_ud
                slot = self.ring.prep_rpc(
                    service_id, method_id, req_off, req_size, rsp_off,
                    rsp_cap, userdata=ud,
                    token=token,
                    class_flags=class_to_flags(current_class()),
                    bulk=bulk_iovs is not None)
            if slot < 0:
                recorders()["ring_full"].add()
                raise FsError(Status(Code.USRBIO_RING_FULL,
                                     f"{self.ring.entries} ops in flight"))
            self.ring.submit()
        except BaseException:
            self._arena.free(req_off, req_size)
            self._arena.free(rsp_off, rsp_cap)
            raise
        nbytes = (sum(len(b) for b in bulk_iovs)
                  if bulk_iovs else len(payload))
        if rpc_ctx is not None:
            dur = time.monotonic() - t0
            _spans.add_span(rpc_ctx, "rpc.client", "issue",
                            time.time() - dur, dur, nbytes=nbytes)
        return _Pending(ud, rsp_type, req_off, req_size, rsp_off, rsp_cap,
                        rpc_ctx, t0, nbytes,
                        sum(len(b) for b in bulk_iovs) if bulk_iovs else 0)

    # -- collect -------------------------------------------------------------
    def finish(self, pending: _Pending, *,
               deadline_s: Optional[float] = None):
        """-> (rsp, reply bulk segment views | None). Reply segments alias
        this client's registered shm; their region recycles when the last
        view dies (retainers must copy, same contract as sockets).

        ``deadline_s`` bounds the wait: past it the call raises
        RPC_TIMEOUT and the op is ABANDONED — its arena regions move to
        ``_abandoned`` and are reclaimed when the late CQE lands, never
        freed under an agent that may still be reading/writing them."""
        from tpu3fs_torch.analytics import spans as _spans

        t_wait = time.monotonic()
        try:
            result = self._await(pending.userdata, deadline_s=deadline_s)
        except FsError as e:
            self._give_up(pending, e)
            raise
        self._arena.free(pending.req_off, pending.req_size)
        with self._cv:
            self.completions += 1
            if result >= 0:
                self.bytes_moved += pending.bulk + result
        rpc_ctx = pending.rpc_ctx
        if result < 0:
            self._arena.free(pending.rsp_off, pending.rsp_cap)
            try:
                code = Code(-result)
            except ValueError:
                code = Code.INTERNAL
            raise FsError(Status(code, "usrbio agent error"))
        # the region's lifetime now belongs to the views parse_reply hands
        # out; when the reply carries no bulk, nothing retains it and the
        # tracked view frees the region as soon as parsing ends
        region = self._arena.tracked_view(pending.rsp_off, pending.rsp_cap)
        try:
            status, message, payload, bulk = parse_reply(region, result)
        finally:
            del region
        if rpc_ctx is not None:
            now = time.monotonic()
            _spans.add_span(rpc_ctx, "rpc.client", "collect",
                            time.time() - (now - t_wait), now - t_wait)
            total = now - pending.t0
            _spans.tracer().end_op(
                rpc_ctx, "rpc.client.ring", time.time() - total, total,
                code=status if status != int(Code.OK) else 0)
        if status != int(Code.OK):
            try:
                code = Code(status)
            except ValueError:
                # version skew: a newer server's code outside our enum
                # must still surface as an FsError, not a ValueError that
                # escapes the messenger's error handling
                code = Code.INTERNAL
            raise FsError(Status(code, message))
        rsp = deserialize(payload, pending.rsp_type)
        return rsp, bulk

    def call(self, service_id: int, method_id: int, req, rsp_type, *,
             req_type=None, bulk_iovs=None, rsp_data_est: int = 0,
             deadline_s: Optional[float] = None):
        return self.finish(self.start(
            service_id, method_id, req, rsp_type, req_type=req_type,
            bulk_iovs=bulk_iovs, rsp_data_est=rsp_data_est),
            deadline_s=deadline_s)

    def _give_up(self, pending: _Pending, e: FsError) -> None:
        """Arena bookkeeping for a finish() that raised out of _await. A
        per-call deadline expiry (RPC_TIMEOUT) abandons the in-flight op:
        region ownership moves to the publish path. Any other failure
        keeps the old contract (free the request; the ring is dying)."""
        if e.code != Code.RPC_TIMEOUT:
            self._arena.free(pending.req_off, pending.req_size)
            return
        with self._cv:
            if pending.userdata in self._done:
                # completed inside the give-up window: drop the late
                # reply and reclaim both regions immediately
                self._done.pop(pending.userdata)
                self._arena.free(pending.req_off, pending.req_size)
                self._arena.free(pending.rsp_off, pending.rsp_cap)
            else:
                self._abandoned[pending.userdata] = (
                    (pending.req_off, pending.req_size),
                    (pending.rsp_off, pending.rsp_cap))

    def _await(self, ud: int, *, deadline_s: Optional[float] = None) -> int:
        """Wait for `ud`'s CQE. Many threads may wait concurrently: one of
        them at a time plays reaper (semaphore wait + reap + publish),
        the rest sleep on the condition. A caller ``deadline_s`` raises
        RPC_TIMEOUT (the op stays in flight — finish() abandons it);
        the default call timeout raises USRBIO_AGENT_GONE as before."""
        timeout = self._call_timeout if deadline_s is None else deadline_s
        code = (Code.USRBIO_AGENT_GONE if deadline_s is None
                else Code.RPC_TIMEOUT)
        deadline = time.monotonic() + timeout
        while True:
            with self._cv:
                while True:
                    if ud in self._done:
                        return self._done.pop(ud)
                    if self.closed:
                        raise FsError(Status(Code.USRBIO_AGENT_GONE,
                                             "ring closed while waiting"))
                    if not self._reaping:
                        self._reaping = True
                        break
                    left = deadline - time.monotonic()
                    if not self._cv.wait(
                            timeout=min(0.2, max(0.001, left))) \
                            and time.monotonic() > deadline:
                        raise FsError(Status(
                            code, f"no completion in {timeout}s"))
            try:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise FsError(Status(
                        code, f"no completion in {timeout}s"))
                self.ring.complete_sem.wait(timeout=min(0.2, remaining))
                cqes = self.ring.reap()
                if not cqes and not self.agent_alive():
                    raise FsError(Status(
                        Code.USRBIO_AGENT_GONE,
                        f"agent process {self.agent_pid} exited"))
            except (FsError, ValueError, OSError) as e:
                # _reaping MUST clear on ANY reaper failure — a ValueError
                # from the mmap closing under us (close() racing in-flight
                # calls) would otherwise leave every other waiter spinning
                # to its full call timeout with nobody reaping
                with self._cv:
                    self._reaping = False
                    self._cv.notify_all()
                if isinstance(e, FsError):
                    raise
                raise FsError(Status(
                    Code.USRBIO_AGENT_GONE,
                    f"ring torn down while waiting: {e}"))
            with self._cv:
                self._reaping = False
                if cqes:
                    for result, u in cqes:
                        regions = self._abandoned.pop(u, None)
                        if regions is not None:
                            # the caller left at its deadline: reclaim
                            for off, size in regions:
                                self._arena.free(off, size)
                        else:
                            self._done[u] = result
                self._cv.notify_all()

    def agent_alive(self) -> bool:
        """False once the registered serving process has exited: its
        ring will never complete another SQE."""
        return not self.agent_pid or process_alive(self.agent_pid)

    def close(self) -> None:
        """Tear the client half down (creator side: unlinks the shm)."""
        self.closed = True
        with self._cv:
            self._cv.notify_all()
        self._finalizer()  # idempotent: close + unlink ring and iov


# -- a client's rings, one a node --------------------------------------------

class RingTable:
    """One client's rings, node id -> ``RingClient``: the storage
    messenger's to storage nodes, the serving peer client's to serving
    peers. A None entry means sockets for that node (it refused the
    handshake, lives on another host or hosts no rings).

    The port's own (the JAX package keeps these rules inline in each
    client): the first caller for a node handshakes and registers outside
    the lock while concurrent callers use sockets; a ring whose host
    process has exited, or whose host runs in this process and whose node
    now has another address, is dropped and made again (a restarted or
    moved node); a node that refused rings is asked again once it has a
    new address; a fatal USRBIO code drops the ring; ``close`` deregisters
    every ring with its host and unlinks the client-owned shm."""

    def __init__(self, rpc_client, *, entries: int, iov_bytes: int):
        self._client = rpc_client
        self.entries, self.iov_bytes = int(entries), int(iov_bytes)
        self.rings: Dict[int, Optional[RingClient]] = {}
        #: node id -> the address whose handshake failed
        self._refused: Dict[int, tuple] = {}
        self._pending: set = set()
        self._mu = threading.Lock()

    def get(self, node_id: int, addr_of) -> Optional[RingClient]:
        """The node's ring, or None (sockets). ``addr_of()`` -> the node's
        current address, or None when it has none; it is called only
        when a ring's host runs in this process or a handshake is due."""
        with self._mu:
            known = node_id in self.rings
            ring = self.rings.get(node_id)
        if ring is not None:
            if ring.closed:
                return None
            if ring.agent_alive() and (
                    ring.agent_pid != os.getpid()
                    or addr_of() in (None, ring.agent_addr)):
                return ring
        elif known and addr_of() in (None, self._refused.get(node_id)):
            return None
        with self._mu:
            if known and self.rings.get(node_id, 0) is ring:
                del self.rings[node_id]
            if node_id in self.rings or node_id in self._pending:
                return None  # a handshake in flight: sockets meanwhile
            self._pending.add(node_id)
        if ring is not None:
            ring.close()
        ring = None
        try:
            addr = addr_of()
            if addr is not None:
                ring = self._connect(node_id, addr)
        except (FsError, OSError, ValueError):
            ring = None
        finally:
            with self._mu:
                self.rings[node_id] = ring
                self._pending.discard(node_id)
        return ring

    def _connect(self, node_id: int, addr) -> Optional[RingClient]:
        """Handshake + registration against one host; None = sockets (not
        same-host, an old server, or hosting disabled)."""
        from tpu3fs_torch.rpc.services import Empty
        from tpu3fs_torch.usrbio.ring import SHM_DIR

        self._refused[node_id] = addr  # until the ring registers
        try:
            rsp = self._client.call(addr, USRBIO_SERVICE_ID, 1, Empty(),
                                    UsrbioHandshakeRsp)
        except FsError:
            return None  # a pre-USRBIO server or a control error
        if not rsp.supported \
                or not rsp.nonce_name.startswith(HANDSHAKE_PREFIX) \
                or "/" in rsp.nonce_name:
            return None
        try:
            with open(os.path.join(SHM_DIR, rsp.nonce_name)) as f:
                nonce = f.read().strip()
        except OSError:
            return None  # cannot read the server's shm: another host
        ring = RingClient(entries=self.entries, iov_bytes=self.iov_bytes)
        try:
            reg = self._client.call(
                addr, USRBIO_SERVICE_ID, 2,
                UsrbioRegisterReq(
                    ring_name=ring.ring.name, iov_name=ring.iov.name,
                    entries=ring.ring.entries, iov_size=ring.iov.size,
                    owner_pid=os.getpid(), nonce=nonce),
                UsrbioRegisterRsp)
        except FsError:
            ring.close()
            return None
        if not reg.ok:
            ring.close()
            return None
        ring.agent_pid, ring.agent_addr = rsp.pid, addr
        self._refused.pop(node_id, None)
        return ring

    def drop(self, node_id: int, ring: RingClient) -> None:
        """Forget a dead ring; the node's next call handshakes again."""
        with self._mu:
            if self.rings.get(node_id) is ring:
                del self.rings[node_id]
        try:
            ring.close()
        except Exception:
            pass

    def fallback(self, node_id: int, ring: RingClient, e: FsError) -> None:
        """Classify a ring call's FsError: a USRBIO transport code means
        this call goes over sockets (a fatal one also drops the ring);
        any other code is the remote's answer and re-raises."""
        if e.code not in TRANSPORT_CODES:
            raise e
        if e.code in FATAL_CODES:
            self.drop(node_id, ring)

    def close(self) -> None:
        """Deregister every ring with its host (its worker stops now, not
        at the next reaper pass) and unlink the client-owned shm."""
        with self._mu:
            rings = dict(self.rings)
            self.rings.clear()
        for ring in rings.values():
            if ring is None:
                continue
            try:
                self._client.call(ring.agent_addr, USRBIO_SERVICE_ID, 3,
                                  UsrbioDeregisterReq(ring.ring.name),
                                  UsrbioRegisterRsp)
            except FsError:
                pass
            try:
                ring.close()
            except Exception:
                pass
