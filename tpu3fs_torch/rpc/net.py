"""TCP RPC transport: length-prefixed serde packets, threaded server, pooled
blocking client.

The port's own copy of ``tpu3fs/rpc/net.py``; frames are byte-identical
to the JAX package's, so either package's client talks to the other's
server. One addition: ``RpcServer.stop`` joins its accept and connection
threads with a bound, so a stopped server leaves no thread behind.

Re-expresses the reference's net + serde-RPC stack for the control plane
(src/common/net/{Server,Transport,IOWorker}.cc + src/common/serde/
MessagePacket.h): every request/response travels as a MessagePacket envelope
carrying service id, method id, a status code and an 8-point timestamp for
latency decomposition (MessagePacket.h:36-52). The reference's RDMA data
plane maps to ICI collectives on TPU (tpu3fs_torch.parallel); control RPCs are not
throughput-critical, so this transport favors simplicity: one thread per
server connection, one in-flight request per pooled client connection.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Type

from tpu3fs_torch.analytics import spans as _spans
from tpu3fs_torch.rpc import deadline as _deadline
from tpu3fs_torch.tenant import identity as _tenant_id
from tpu3fs_torch.rpc.serde import (
    _read_uvarint,
    _write_uvarint,
    deserialize,
    deserialize_prefix,
    serialize,
)
from tpu3fs_torch.utils.result import Code, FsError, Status


@dataclass
class Timestamps:
    """8 clock points: client build/send + server receive/queue/run/reply +
    client receive/done (ref MessagePacket.h Timestamp)."""

    client_build: float = 0.0
    client_send: float = 0.0
    server_receive: float = 0.0
    server_dequeue: float = 0.0
    server_run_start: float = 0.0
    server_run_end: float = 0.0
    client_receive: float = 0.0
    client_done: float = 0.0

    def server_latency(self) -> float:
        return self.server_run_end - self.server_receive

    def network_latency(self) -> float:
        total = self.client_receive - self.client_send
        return max(0.0, total - self.server_latency())


FLAG_IS_REQ = 1
FLAG_COMPRESS = 2     # reserved (ref UseCompress)
FLAG_CONTROL_RDMA = 4  # reserved (ref ControlRDMA)
# bulk framing: the frame body is [MessagePacket serde][bulk section]; the
# envelope's payload carries only control fields while chunk data rides the
# bulk section untouched by serde — the analogue of the reference splitting
# control packets from RDMA READ/WRITE batches into registered buffers
# (src/common/net/ib/IBSocket.h:155-229, RDMABuf.h:434). Senders gather
# caller buffers straight into sendmsg (no concatenation); receivers hand
# out memoryview slices of one recv buffer (no per-field copies).
FLAG_BULK = 8


@dataclass
class MessagePacket:
    uuid: str
    service_id: int
    method_id: int
    flags: int
    status: int                    # Code of the reply (OK for requests)
    payload: bytes
    message: str = ""
    timestamps: Timestamps = field(default_factory=Timestamps)


_LEN = struct.Struct(">I")
MAX_PACKET = 64 << 20


# -- bulk section codec ------------------------------------------------------
# self-describing so the control schemas never change shape:
#   varint count, varint len per segment, then the segments back to back.
# One wire-level varint codec for the whole transport: serde.py owns it.

def pack_bulk_header(iovs) -> bytes:
    hdr = bytearray()
    _write_uvarint(hdr, len(iovs))
    for iov in iovs:
        _write_uvarint(hdr, len(iov))
    return bytes(hdr)


def split_bulk(section) -> List[memoryview]:
    """Bulk section (memoryview) -> per-segment memoryviews, zero-copy."""
    mv = memoryview(section)
    try:
        count, pos = _read_uvarint(mv, 0)
        lens = []
        for _ in range(count):
            n, pos = _read_uvarint(mv, pos)
            lens.append(n)
    except IndexError:
        # truncated header (empty section / varint cut mid-byte) must fail
        # as a transport error, not leak IndexError past the FsError
        # contract / the server's connection-error handling
        raise ConnectionError("bulk section truncated header")
    out = []
    for n in lens:
        if pos + n > len(mv):
            raise ConnectionError("bulk segment overruns section")
        out.append(mv[pos:pos + n])
        pos += n
    if pos != len(mv):
        raise ConnectionError(f"bulk section trailing bytes: {len(mv) - pos}")
    return out


def _send_packet(
    sock: socket.socket, pkt: MessagePacket, lock: threading.Lock,
    bulk_iovs=None,
) -> None:
    if bulk_iovs is not None:
        pkt.flags |= FLAG_BULK
        raw = serialize(pkt)
        hdr = pack_bulk_header(bulk_iovs)
        total = len(raw) + len(hdr) + sum(len(b) for b in bulk_iovs)
        if total > MAX_PACKET:
            # the caller's sizing error, found BEFORE any bytes hit the
            # wire: the connection is still in sync, so this must not be
            # reported (or handled) as a peer/transport failure
            raise FsError(Status(
                Code.RPC_BAD_REQUEST, f"oversized packet: {total}"))
        # gather-write: caller buffers go straight to the kernel, no
        # concatenation of control + data
        iovs = [_LEN.pack(total) + raw + hdr] + list(bulk_iovs)
        with lock:
            _sendmsg_all(sock, iovs)
    else:
        raw = serialize(pkt)
        with lock:
            sock.sendall(_LEN.pack(len(raw)) + raw)


# one sendmsg accepts at most IOV_MAX (1024) buffers; stay under it so a
# wide batch (1000+ ops) doesn't fail with EMSGSIZE
_IOV_CAP = 512


def _sendmsg_all(sock: socket.socket, iovs) -> None:
    """sendmsg until every iov is fully written (sendmsg may stop short,
    and never takes more than _IOV_CAP buffers per call)."""
    iovs = list(iovs)
    while iovs:
        window = iovs[:_IOV_CAP]
        total = sum(len(b) for b in window)
        sent = sock.sendmsg(window)
        if sent >= total:
            del iovs[:len(window)]
            continue
        # drop fully-sent iovs, trim the partial one, go again
        remaining: List = []
        acc = 0
        for iov in window:
            if acc + len(iov) <= sent:
                acc += len(iov)
                continue
            # only the boundary iov is partially sent; later ones must go
            # whole (a negative off would tail-slice and drop bytes)
            off = max(0, sent - acc)
            mv = memoryview(iov)
            remaining.append(mv[off:] if off else mv)
            acc += len(iov)
        iovs = remaining + iovs[len(window):]


def _set_bulk_bufs(sock: socket.socket) -> None:
    """Size socket buffers for MiB-scale bulk frames: default loopback
    buffers force ~8+ send/recv syscalls per MiB payload; 1 MiB buffers
    measured ~25% more one-hop loopback throughput on this class of
    host. Best-effort — some environments cap or refuse the option."""
    for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
        try:
            sock.setsockopt(socket.SOL_SOCKET, opt, 1 << 20)
        except OSError:
            pass


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("peer closed")
        buf += part
    return bytes(buf)


def _recv_exact_into(sock: socket.socket, buf: bytearray, n: int) -> None:
    """recv_into the first n bytes of buf (no chunk-list joins).
    MSG_WAITALL lets the kernel loop internally — one syscall per bulk
    frame instead of one per RCVBUF drain; the outer loop stays for the
    partial returns signals/timeouts may still produce."""
    view = memoryview(buf)
    off = 0
    while off < n:
        got = sock.recv_into(view[off:n], n - off, socket.MSG_WAITALL)
        if not got:
            raise ConnectionError("peer closed")
        off += got


def _recv_packet(sock: socket.socket):
    """-> (MessagePacket, bulk_segments | None). Bulk segments are
    memoryviews over the single receive buffer — the buffer stays alive as
    long as any view does, so hand-offs are GC-safe.

    Receive buffers come from the shared BufferPool (the registered-
    buffer-pool role, ref RDMABuf.h:434). Inline frames release their
    buffer right after packet decode (serde copies every field out); bulk
    frames detach theirs — the escaped memoryviews own it, GC reclaims.
    """
    from tpu3fs_torch.utils.bufpool import GLOBAL_POOL

    (n,) = _LEN.unpack(_recv_exact(sock, 4))
    if n > MAX_PACKET:
        raise ConnectionError(f"oversized packet: {n}")
    buf = GLOBAL_POOL.acquire(n)
    try:
        _recv_exact_into(sock, buf, n)
        # decode bounded to the frame: a pooled buffer is longer than n
        # and its tail holds a PREVIOUS frame's bytes — an unbounded parse
        # of a truncated packet could read stale cross-request data
        pkt, pos = deserialize_prefix(memoryview(buf)[:n], MessagePacket)
    except BaseException:
        GLOBAL_POOL.release(buf)
        raise
    if pkt.flags & FLAG_BULK:
        # buffer detached: the segments escape with views into it
        return pkt, split_bulk(memoryview(buf)[pos:n])
    GLOBAL_POOL.release(buf)
    if pos != n:
        raise ConnectionError(f"trailing bytes after packet: {n - pos}")
    return pkt, None


# -- service declaration ----------------------------------------------------

@dataclass
class MethodDef:
    method_id: int
    name: str
    req_type: Type
    rsp_type: Type
    handler: Callable[[Any], Any]
    # bulk-capable methods take (req, bulk_segments|None) and return
    # (rsp, reply_iovs|None); plain methods take req and return rsp
    bulk: bool = False


class ServiceDef:
    """A service = u16 id + method table (ref SERDE_SERVICE, Service.h:80-128)."""

    def __init__(self, service_id: int, name: str):
        self.service_id = service_id
        self.name = name
        self.methods: Dict[int, MethodDef] = {}

    def method(
        self, method_id: int, name: str, req_type: Type, rsp_type: Type,
        handler: Callable[[Any], Any], *, bulk: bool = False,
    ) -> None:
        if method_id in self.methods:
            raise ValueError(f"duplicate method id {method_id} in {self.name}")
        self.methods[method_id] = MethodDef(
            method_id, name, req_type, rsp_type, handler, bulk)


def encode_envelope_message(rpc_ctx=None) -> str:
    """Compose the request envelope's message field — trace context,
    absolute deadline and tenant id as dot-separated version-tolerant
    tokens (``t1.*``/``d1.*``/``u1.*``), all from the calling context.
    ONE encoder for every client-side transport (socket start_call, the
    USRBIO ring transport), so the wire form can never fork."""
    return _tenant_id.append_wire(
        _deadline.encode_envelope(
            rpc_ctx.to_wire() if rpc_ctx is not None else "",
            _deadline.current_deadline()),
        _tenant_id.current_tenant())


def _error_reply(pkt: MessagePacket, code: Code, msg: str) -> MessagePacket:
    return MessagePacket(
        uuid=pkt.uuid, service_id=pkt.service_id, method_id=pkt.method_id,
        flags=0, status=int(code), payload=b"", message=msg,
        timestamps=pkt.timestamps,
    )


def _trace_dispatch(sctx, service, mdef, ts: Timestamps, status: int,
                    tclass, tenant: str = "") -> None:
    """Emit the server-side spans of one dispatch: the admission-wait
    stage (receive -> handler start: queueing + admission + request
    decode) and the dispatch op span — tagged with the envelope's
    tenant so trace-top can group by owner — then flush-or-drop
    (slow-op capture applies even to unsampled traces)."""
    dur = ts.server_run_end - ts.server_receive
    wall_end = time.time()
    _spans.add_span(
        sctx, "rpc.server", "admission_wait",
        wall_end - dur, ts.server_run_start - ts.server_receive)
    _spans.tracer().finish_op(
        sctx, f"rpc.{service.name}.{mdef.name}", wall_end - dur, dur,
        code=status if status != int(Code.OK) else 0,
        tclass=tclass.name.lower() if tclass is not None else "",
        tenant=tenant)


def dispatch_packet(server, pkt: MessagePacket, bulk=None):
    """THE local dispatch + admission entry: fault plane, deadline shed,
    tenant quota charge, QoS class admission, request decode, context
    scoping (class/deadline/tenant/trace) around the handler, reply
    build — for any transport that delivers MessagePackets into this
    process. ``server`` is anything exposing ``_services``, ``_admission``
    and ``_admission_exempt`` (RpcServer, NativeRpcServer, and the USRBIO
    ring agent hand in the server they serve for).

    -> (reply packet, reply bulk iovs | None)."""
    ts = pkt.timestamps
    ts.server_dequeue = time.monotonic()
    service = server._services.get(pkt.service_id)
    if service is None:
        return _error_reply(pkt, Code.RPC_SERVICE_NOT_FOUND,
                            str(pkt.service_id)), None
    mdef = service.methods.get(pkt.method_id)
    if mdef is None:
        return _error_reply(pkt, Code.RPC_METHOD_NOT_FOUND,
                            f"{service.name}.{pkt.method_id}"), None
    if bulk is not None and not mdef.bulk:
        return _error_reply(
            pkt, Code.RPC_BAD_REQUEST,
            f"{service.name}.{mdef.name} is not bulk-capable"), None
    # cluster fault plane: the server-side dispatch boundary
    # (utils/fault_injection.py). `drop` rules raise ConnectionError,
    # which _serve_conn turns into a torn connection — the realistic
    # shape of a half-dead peer.
    from tpu3fs_torch.utils.fault_injection import plane as _fault_plane

    try:
        _fault_plane().fire(
            f"rpc.dispatch.{service.name}.{mdef.name}")
    except FsError as e:
        return _error_reply(pkt, e.code, e.status.message), None
    # DEADLINE admission shed (before QoS and before request decode —
    # expired work must never reach the engine stage, and shedding it
    # must cost less than anything downstream): an envelope whose
    # absolute deadline passed answers the retryable DEADLINE_EXCEEDED
    dl = _deadline.decode_deadline(pkt.message) if pkt.message else None
    if dl is not None and time.time() > dl:
        _deadline.record_shed("admission")
        return _error_reply(
            pkt, Code.DEADLINE_EXCEEDED,
            f"deadline passed {time.time() - dl:.3f}s before "
            f"{service.name}.{mdef.name} admission"), None
    # native write fast path for frames that arrived OUTSIDE the C socket
    # loop (the USRBIO ring host dispatches SQEs through here): a server
    # exposing fastpath_serve (NativeRpcServer) gets first refusal — the
    # C side runs its own admission/tenant gates and exactly-once table,
    # and returns None for anything it can't prove, which then takes the
    # normal dispatch below exactly as a socket-path fallback would.
    serve = getattr(server, "fastpath_serve", None)
    if serve is not None:
        served = serve(pkt, bulk)
        if served is not None:
            status, payload, message = served
            ts.server_run_start = ts.server_run_end = time.monotonic()
            return MessagePacket(
                uuid=pkt.uuid, service_id=pkt.service_id,
                method_id=pkt.method_id, flags=0, status=status,
                payload=payload, message=message, timestamps=ts,
            ), None
    # TENANT resolution + quota admission (tenant/quota.py): every
    # envelope resolves an owner (explicit u1.* token or "default"),
    # and methods the enforcement table classifies bytes/iops charge
    # the owner's buckets HERE, before request decode — a tenant over
    # its quota answers the retryable TENANT_THROTTLED with a
    # retry-after hint, same shape as an OVERLOADED class shed.
    # Services that run their own internal admission (storage) are
    # exempt at this level exactly like class admission.
    tenant = (_tenant_id.decode_tenant(pkt.message)
              if pkt.message else None)
    tname = tenant or _tenant_id.DEFAULT_TENANT
    if pkt.service_id not in server._admission_exempt:
        from tpu3fs_torch.qos.core import format_retry_after
        from tpu3fs_torch.tenant import enforcement as _tenf
        from tpu3fs_torch.tenant.quota import registry as _treg

        kind = _tenf.enforcement_of(service.name, mdef.name)
        if kind in (_tenf.BYTES, _tenf.IOPS):
            nbytes = 0
            if kind == _tenf.BYTES:
                nbytes = len(pkt.payload) + (
                    sum(len(b) for b in bulk) if bulk else 0)
            t_shed = _treg().try_admit(tname, nbytes=nbytes)
            if t_shed is not None:
                return _error_reply(
                    pkt, Code.TENANT_THROTTLED,
                    format_retry_after(
                        t_shed, f"tenant {tname} over quota at "
                                f"{service.name}.{mdef.name}")), None
    # QoS admission BEFORE deserialization (shedding must stay cheap):
    # token bucket + concurrency cap keyed (service, method, traffic
    # class); sheds answer OVERLOADED with the retry-after hint in the
    # envelope message (qos/core.py)
    lease = None
    tclass = None
    if server._admission is not None \
            and pkt.service_id not in server._admission_exempt:
        from tpu3fs_torch.qos.core import class_from_flags, format_retry_after

        tclass = class_from_flags(pkt.flags)
        lease, shed_ms = server._admission.try_admit(
            service.name, mdef.name, tclass, tenant=tname)
        if lease is None:
            return _error_reply(
                pkt, Code.OVERLOADED,
                format_retry_after(shed_ms,
                                   f"{service.name}.{mdef.name}")), None
    try:
        req = deserialize(pkt.payload, mdef.req_type)
    except Exception as e:  # malformed payload
        if lease is not None:
            lease.release()
        return _error_reply(pkt, Code.RPC_BAD_REQUEST, repr(e)), None
    # distributed tracing: a traced peer stamps its context into the
    # request envelope's message field (version-tolerant: untraced
    # servers — and every pre-tracing decoder — parse and ignore it);
    # with a tracer but no inbound context this server head-samples.
    # Scoped via ContextVar so service internals (update workers,
    # chain forwards, pool fan-outs) inherit and extend the trace.
    sctx = None
    if _spans.tracer().enabled:
        in_ctx = _spans.decode_wire(pkt.message) if pkt.message else None
        sctx = (in_ctx.child() if in_ctx is not None
                else _spans.tracer().start_trace())
    ts.server_run_start = time.monotonic()
    reply_iovs = None
    try:
        # restore the client's traffic class around the handler so
        # service internals (update-worker scheduling, read gates)
        # see the tag the peer carried in the envelope
        import contextlib

        from tpu3fs_torch.qos.core import class_from_flags, tagged

        if tclass is None:
            tclass = class_from_flags(pkt.flags)
        ctx = (tagged(tclass) if tclass is not None
               else contextlib.nullcontext())
        # the peer's deadline scopes the handler: service internals
        # (update-queue submit, nested RPCs) inherit and re-propagate
        dctx = (_deadline.deadline_scope(dl) if dl is not None
                else contextlib.nullcontext())
        # the peer's TENANT scopes the handler the same way: storage
        # internal admission, update-queue lanes and nested RPCs all
        # see the owner the envelope carried (tenant/identity.py)
        tctx = (_tenant_id.tenant_scope(tenant) if tenant is not None
                else contextlib.nullcontext())
        with ctx, dctx, tctx, _spans.trace_scope(sctx) \
                if sctx is not None else contextlib.nullcontext():
            if mdef.bulk:
                rsp, reply_iovs = mdef.handler(req, bulk)
            else:
                rsp = mdef.handler(req)
        payload = serialize(rsp, mdef.rsp_type)
        status, message = int(Code.OK), ""
    except FsError as e:
        payload, status, message = b"", int(e.code), e.status.message
        reply_iovs = None
    except Exception as e:  # handler bug: surface as INTERNAL
        payload, status, message = b"", int(Code.INTERNAL), repr(e)
        reply_iovs = None
    finally:
        if lease is not None:
            lease.release()
    ts.server_run_end = time.monotonic()
    if sctx is not None:
        _trace_dispatch(sctx, service, mdef, ts, status, tclass, tname)
    return MessagePacket(
        uuid=pkt.uuid,
        service_id=pkt.service_id,
        method_id=pkt.method_id,
        flags=0,
        status=status,
        payload=payload,
        message=message,
        timestamps=ts,
    ), reply_iovs


class RpcServer:
    """Threaded TCP server dispatching packets to registered services
    (ref net::Server + ServiceGroup)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._services: Dict[int, ServiceDef] = {}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.host, self.port = self._sock.getsockname()
        self._threads: List[threading.Thread] = []
        self._running = False
        self._conns: List[socket.socket] = []
        self._lock = threading.Lock()
        # QoS admission (qos/core.py): consulted per dispatch, keyed
        # (service, method, traffic class from the envelope flag bits);
        # None = admit everything (legacy)
        self._admission = None
        self._admission_exempt: frozenset = frozenset()

    def set_admission(self, admission, exempt=()) -> None:
        """Install an AdmissionController enforced in _dispatch. Service
        ids in `exempt` skip the RPC-level check (a service that runs its
        own internal admission — storage — must not be charged twice)."""
        self._admission = admission
        self._admission_exempt = frozenset(exempt)

    def add_service(self, service: ServiceDef) -> None:
        if service.service_id in self._services:
            raise ValueError(f"duplicate service id {service.service_id}")
        self._services[service.service_id] = service

    @property
    def address(self) -> Tuple[str, int]:
        return self.host, self.port

    def start(self) -> None:
        self._running = True
        self._sock.listen(64)
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _set_bulk_bufs(conn)
            with self._lock:
                self._conns.append(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        write_lock = threading.Lock()
        try:
            while self._running:
                pkt, bulk = _recv_packet(conn)
                pkt.timestamps.server_receive = time.monotonic()
                reply, reply_iovs = self._dispatch(pkt, bulk)
                try:
                    _send_packet(conn, reply, write_lock, reply_iovs)
                except FsError as e:
                    # oversized reply (MAX_PACKET): the stream is still in
                    # sync (nothing was written) — answer with an error
                    # envelope like the native server does, don't kill the
                    # connection thread
                    err = self._error_reply(reply, e.code, e.status.message)
                    _send_packet(conn, err, write_lock)
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, pkt: MessagePacket, bulk=None):
        """-> (reply packet, reply bulk iovs | None). Thin wrapper over the
        transport-agnostic ``dispatch_packet`` — the SHARED admission entry
        every local transport (socket threads here, the USRBIO shm ring
        agent in tpu3fs/usrbio/server.py) must route through, so no
        transport can grow a path around deadline/tenant/QoS enforcement
        (tools/check_rpc_registry.py check 7 pins this statically)."""
        return dispatch_packet(self, pkt, bulk)

    @staticmethod
    def _error_reply(pkt: MessagePacket, code: Code, msg: str) -> MessagePacket:
        return _error_reply(pkt, code, msg)

    def stop(self) -> None:
        self._running = False
        try:
            # shutdown BEFORE close: close() does not interrupt a thread
            # blocked in accept(2), and the in-kernel syscall then pins
            # the socket — the port stays LISTENing (unbindable) until a
            # connection happens to arrive. shutdown() wakes the accept
            # immediately, so stop() actually releases the port.
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            for conn in self._conns:
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    conn.close()
                except OSError:
                    pass
            self._conns.clear()
            threads, self._threads = self._threads, []
        me = threading.current_thread()
        deadline = time.monotonic() + 5.0
        for t in threads:
            if t is not me:
                t.join(timeout=max(0.0, deadline - time.monotonic()))


class _PooledConn:
    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.lock = threading.Lock()  # one in-flight request per connection
        self.write_lock = threading.Lock()


class RpcClient:
    """Blocking client with a per-address connection pool
    (ref net::Client + TransportPool)."""

    def __init__(self, connect_timeout: float = 5.0, call_timeout: float = 30.0):
        self._pools: Dict[Tuple[str, int], List[_PooledConn]] = {}
        self._lock = threading.Lock()
        self._connect_timeout = connect_timeout
        self._call_timeout = call_timeout

    def _get_conn(self, addr: Tuple[str, int]) -> _PooledConn:
        with self._lock:
            pool = self._pools.setdefault(addr, [])
            for conn in pool:
                if conn.lock.acquire(blocking=False):
                    return conn
        try:
            sock = socket.create_connection(addr, timeout=self._connect_timeout)
        except OSError as e:
            raise FsError(Status(Code.RPC_CONNECT_FAILED, f"{addr}: {e}"))
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _set_bulk_bufs(sock)
        sock.settimeout(self._call_timeout)
        conn = _PooledConn(sock)
        conn.lock.acquire()
        with self._lock:
            self._pools[addr].append(conn)
        return conn

    def _drop_conn(self, addr: Tuple[str, int], conn: _PooledConn) -> None:
        with self._lock:
            pool = self._pools.get(addr, [])
            if conn in pool:
                pool.remove(conn)
        try:
            conn.sock.close()
        except OSError:
            pass

    def call(
        self,
        addr: Tuple[str, int],
        service_id: int,
        method_id: int,
        req: Any,
        rsp_type: Type,
        *,
        req_type: Optional[Type] = None,
        timeout_s: Optional[float] = None,
    ) -> Any:
        """Raises FsError carrying the remote (or transport) status code."""
        rsp, _ = self.call_bulk(addr, service_id, method_id, req, rsp_type,
                                req_type=req_type, timeout_s=timeout_s)
        return rsp

    def call_bulk(
        self,
        addr: Tuple[str, int],
        service_id: int,
        method_id: int,
        req: Any,
        rsp_type: Type,
        *,
        req_type: Optional[Type] = None,
        bulk_iovs=None,
        timeout_s: Optional[float] = None,
    ):
        """call() with bulk riders both ways -> (rsp, reply_segments|None).
        Request `bulk_iovs` buffers are gathered into the socket without
        copies; reply segments are memoryviews over one receive buffer."""
        pending = self.start_call(addr, service_id, method_id, req, rsp_type,
                                  req_type=req_type, bulk_iovs=bulk_iovs,
                                  timeout_s=timeout_s)
        return self.finish_call(pending)

    def start_call(
        self,
        addr: Tuple[str, int],
        service_id: int,
        method_id: int,
        req: Any,
        rsp_type: Type,
        *,
        req_type: Optional[Type] = None,
        bulk_iovs=None,
        timeout_s: Optional[float] = None,
    ):
        """Issue the request NOW on an exclusively-leased pooled connection
        and return a pending handle for finish_call. Starting many calls
        before finishing any is the pipelined multi-connection fan-out of
        the read path: each start takes its OWN connection (the pool grows
        on demand), so the server works on every request concurrently
        while the client is still issuing."""
        from tpu3fs_torch.qos.core import class_to_flags, current_class

        # distributed tracing: the calling context's trace rides the
        # request envelope's message field — a child span id per wire hop
        # so server spans nest under this rpc. Untraced calls pay one
        # ContextVar read and nothing else.
        tctx = _spans.current_trace()
        rpc_ctx = tctx.child() if tctx is not None else None
        pkt = MessagePacket(
            uuid=uuid_mod.uuid4().hex,
            service_id=service_id,
            method_id=method_id,
            # the calling thread's traffic class rides the envelope flag
            # bits so the server's admission + scheduler see it (untagged
            # threads leave the bits 0 — legacy wire form)
            flags=FLAG_IS_REQ | class_to_flags(current_class()),
            status=int(Code.OK),
            payload=serialize(req, req_type or type(req)),
            # trace context + absolute deadline + tenant id compose in
            # the message field (version-tolerant all three ways;
            # rpc/deadline.py, tenant/identity.py)
            message=encode_envelope_message(rpc_ctx),
        )
        # client-side fault plane hook: the send boundary (drop rules
        # surface as the peer-closed transport error retry ladders know)
        from tpu3fs_torch.utils.fault_injection import plane as _fault_plane

        try:
            _fault_plane().fire(f"rpc.send.{service_id}.{method_id}")
        except ConnectionError as e:
            raise FsError(Status(Code.RPC_PEER_CLOSED, f"{addr}: {e}"))
        pkt.timestamps.client_build = time.monotonic()
        conn = self._get_conn(addr)
        if timeout_s is not None:
            # per-call deadline: bounds every socket op of this exchange
            # (a timeout drops the connection — the stream is mid-reply
            # and unrecoverable); finish_call restores the pool default
            conn.sock.settimeout(timeout_s)
        # the connection must not return to the pool until the stream is
        # known to be in sync (uuid validated in finish_call) — releasing
        # earlier would let another thread claim a connection we may still
        # drop/close
        try:
            pkt.timestamps.client_send = time.monotonic()
            _send_packet(conn.sock, pkt, conn.write_lock, bulk_iovs)
        except FsError:
            # sizing error found before any bytes hit the wire: the
            # connection is healthy — return it to the pool
            conn.lock.release()
            raise
        except (ConnectionError, OSError, socket.timeout) as e:
            self._drop_conn(addr, conn)
            conn.lock.release()
            # RPC_PEER_CLOSED (not SEND_FAILED): chain forwarding's
            # RETRIABLE_FORWARD_CODES matches on it, same as before the
            # send/recv split
            code = (Code.RPC_TIMEOUT if isinstance(e, socket.timeout)
                    else Code.RPC_PEER_CLOSED)
            raise FsError(Status(code, f"{addr}: {e}"))
        if rpc_ctx is not None:
            # "issue" = serialize + put-on-wire; for MiB-scale bulk frames
            # the blocking send carries most of the wire transfer time, so
            # issue + server stages partition the client-observed latency
            dur = time.monotonic() - pkt.timestamps.client_build
            _spans.add_span(
                rpc_ctx, "rpc.client", "issue", time.time() - dur, dur,
                nbytes=(sum(len(b) for b in bulk_iovs)
                        if bulk_iovs else len(pkt.payload)))
        return (addr, conn, pkt, rsp_type, rpc_ctx)

    def finish_call(self, pending):
        """Collect the reply of a start_call -> (rsp, reply_segments|None)."""
        addr, conn, pkt, rsp_type, rpc_ctx = pending
        t0 = time.monotonic()
        try:
            try:
                reply, reply_bulk = _recv_packet(conn.sock)
                reply.timestamps.client_receive = time.monotonic()
            except (ConnectionError, OSError, socket.timeout) as e:
                self._drop_conn(addr, conn)
                code = (
                    Code.RPC_TIMEOUT
                    if isinstance(e, socket.timeout)
                    else Code.RPC_PEER_CLOSED
                )
                raise FsError(Status(code, f"{addr}: {e}"))
            if reply.uuid != pkt.uuid:
                self._drop_conn(addr, conn)
                raise FsError(Status(Code.RPC_PEER_CLOSED, "uuid mismatch"))
            # undo any per-call deadline before the conn rejoins the pool
            conn.sock.settimeout(self._call_timeout)
        finally:
            if conn.lock.locked():
                conn.lock.release()
        if rpc_ctx is not None:
            now = time.monotonic()
            total = now - pkt.timestamps.client_build
            _spans.add_span(rpc_ctx, "rpc.client", "collect",
                            time.time() - (now - t0), now - t0)
            rts = reply.timestamps
            if rts.server_run_end >= rts.server_receive > 0:
                # "wire" = the collect wait MINUS the server's
                # receive->run_end window (which the server's own spans
                # attribute): frame receive on the server, reply
                # serialize/send/receive/decode — the residue that would
                # otherwise be invisible in the stage breakdown. The two
                # server stamps share the server's monotonic clock, so
                # their difference is valid cross-process.
                wire = (now - t0) - (rts.server_run_end
                                     - rts.server_receive)
                if wire > 0:
                    _spans.add_span(rpc_ctx, "rpc.client", "wire",
                                    time.time() - (now - t0), wire)
            _spans.tracer().end_op(
                rpc_ctx, f"rpc.client.{pkt.service_id}.{pkt.method_id}",
                time.time() - total, total,
                code=reply.status if reply.status != int(Code.OK) else 0)
        if reply.status != int(Code.OK):
            raise FsError(Status(Code(reply.status), reply.message))
        reply.timestamps.client_done = time.monotonic()
        rsp = deserialize(reply.payload, rsp_type)
        return rsp, reply_bulk

    def close(self) -> None:
        with self._lock:
            for pool in self._pools.values():
                for conn in pool:
                    try:
                        conn.sock.close()
                    except OSError:
                        pass
            self._pools.clear()
