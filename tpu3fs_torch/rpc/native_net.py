"""ctypes binding for the native C++ RPC/net layer (hostsrc/rpc_net.cpp).

The port's own copy of ``tpu3fs/rpc/native_net.py``. The library is the
port's copy of ``native/rpc_net.cpp``, built by ``hostbuild`` with ``g++``
into ``_build/`` under a name that carries its source's digest, so a stale
library is never loaded and nothing under ``native/`` is read or written.
Its wire, like the Python transport's, is the JAX package's byte for byte:
any mix of the two packages' native and Python clients and servers
interoperates.

Drop-in counterparts of RpcServer/RpcClient (rpc/net.py) running the
transport in native code: epoll event loop + worker pool on the server,
blocking pooled connections on the client — the same split as the
reference's native net core (src/common/net/{EventLoop,IOWorker,Server}.cc).
The wire format (length-prefixed MessagePacket envelopes, optional bulk
sections) is bit-compatible with the Python transport; service dispatch
(deserialize request, run handler, serialize reply) stays in Python,
exactly as the reference keeps service logic above its native transport,
except for the storage fast paths (storage/native_fastpath.py), which
the C workers serve end to end.

Bulk framing (the RDMA-batch analogue, ref src/common/net/ib/
IBSocket.h:155-229): chunk payloads ride a raw section after the envelope.
On send the native side writev's the caller's buffers without
concatenation; on receive the bridge takes ONE owned copy of the section
(the handler may retain segments past the native frame's lifetime — e.g.
per-target update queues) and hands out zero-copy memoryview slices of it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Any, Dict, Optional, Tuple, Type

from tpu3fs_torch import hostbuild
from tpu3fs_torch.rpc.net import ServiceDef, pack_bulk_header, split_bulk
from tpu3fs_torch.rpc.serde import deserialize, serialize
from tpu3fs_torch.utils.result import Code, FsError, Status

_ABI_VERSION = 5  # the JAX package's; tpu3fs_rpc_abi_version() in rpc_net.cpp

_HANDLER_T = ctypes.CFUNCTYPE(
    ctypes.c_int64,                      # status
    ctypes.c_int64, ctypes.c_int64,      # service_id, method_id
    ctypes.c_int64,                      # envelope flags (QoS class bits)
    ctypes.c_char_p,                     # request envelope message (trace)
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,   # req
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,   # bulk section
    ctypes.c_int,                                      # has_bulk
    ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),    # out rsp
    ctypes.POINTER(ctypes.c_size_t),                   # out rsp_len
    ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),    # out rsp_bulk
    ctypes.POINTER(ctypes.c_size_t),                   # out rsp_bulk_len
    ctypes.POINTER(ctypes.c_char_p),                   # out msg
)

_lib = None
_lib_lock = threading.Lock()


def _load_lib():
    """The transport library, built on first use (``hostbuild``), with
    every entry's argument and return types set; raises when it cannot be
    built or its ABI version is not ``_ABI_VERSION``."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = hostbuild.load("rpc_net")
        lib.tpu3fs_rpc_abi_version.restype = ctypes.c_int
        abi = lib.tpu3fs_rpc_abi_version()
        if abi != _ABI_VERSION:
            raise RuntimeError(
                f"libtpu3fs_rpc ABI {abi} != expected {_ABI_VERSION}")
        lib.tpu3fs_rpc_alloc.restype = ctypes.c_void_p
        lib.tpu3fs_rpc_alloc.argtypes = [ctypes.c_size_t]
        lib.tpu3fs_rpc_free.argtypes = [ctypes.c_void_p]
        lib.tpu3fs_rpc_server_create.restype = ctypes.c_void_p
        lib.tpu3fs_rpc_server_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int, _HANDLER_T, ctypes.c_int,
        ]
        lib.tpu3fs_rpc_server_port.restype = ctypes.c_int
        lib.tpu3fs_rpc_server_port.argtypes = [ctypes.c_void_p]
        lib.tpu3fs_rpc_server_stop.argtypes = [ctypes.c_void_p]
        lib.tpu3fs_rpc_client_connect.restype = ctypes.c_void_p
        lib.tpu3fs_rpc_client_connect.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        _recv_out_args = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),  # out bulk base
            ctypes.POINTER(ctypes.c_size_t),                 # out bulk off
            ctypes.POINTER(ctypes.c_size_t),                 # out bulk len
            ctypes.POINTER(ctypes.c_int),                    # out has_bulk
            ctypes.POINTER(ctypes.c_char_p),
        ]
        _send_in_args = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64,                        # extra envelope flags
            ctypes.c_char_p,                       # envelope message (trace)
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_void_p),       # iov ptrs
            ctypes.POINTER(ctypes.c_size_t),       # iov lens
            ctypes.c_int64,                        # n_iovs (-1 = no bulk)
        ]
        lib.tpu3fs_rpc_client_call3.restype = ctypes.c_int
        lib.tpu3fs_rpc_client_call3.argtypes = _send_in_args + _recv_out_args
        lib.tpu3fs_rpc_client_send.restype = ctypes.c_int
        lib.tpu3fs_rpc_client_send.argtypes = _send_in_args
        lib.tpu3fs_rpc_client_recv.restype = ctypes.c_int
        lib.tpu3fs_rpc_client_recv.argtypes = (
            [ctypes.c_void_p] + _recv_out_args)
        lib.tpu3fs_rpc_client_close.argtypes = [ctypes.c_void_p]
        lib.tpu3fs_rpc_fastpath_install.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p]
        lib.tpu3fs_rpc_fastpath_set_target.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_uint64]
        lib.tpu3fs_rpc_fastpath_del_target.argtypes = [
            ctypes.c_void_p, ctypes.c_int64]
        lib.tpu3fs_rpc_fastpath_clear.argtypes = [ctypes.c_void_p]
        lib.tpu3fs_rpc_fastpath_install_write.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p]
        lib.tpu3fs_rpc_fastpath_set_write_chain.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64]
        lib.tpu3fs_rpc_fastpath_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.tpu3fs_rpc_qos_set.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
            ctypes.c_double, ctypes.c_int64]
        lib.tpu3fs_rpc_qos_set_class.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, ctypes.c_int64]
        lib.tpu3fs_rpc_qos_clear.argtypes = [ctypes.c_void_p]
        lib.tpu3fs_rpc_qos_shed_count.restype = ctypes.c_uint64
        lib.tpu3fs_rpc_qos_shed_count.argtypes = [ctypes.c_void_p]
        lib.tpu3fs_rpc_tenant_set.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double]
        lib.tpu3fs_rpc_tenant_clear.argtypes = [ctypes.c_void_p]
        lib.tpu3fs_rpc_tenant_exempt_classes.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64]
        lib.tpu3fs_rpc_tenant_shed_count.restype = ctypes.c_uint64
        lib.tpu3fs_rpc_tenant_shed_count.argtypes = [ctypes.c_void_p]
        lib.tpu3fs_rpc_fastpath_install_head.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.tpu3fs_rpc_fastpath_set_head_chain.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.tpu3fs_rpc_fastpath_skip_crc.argtypes = [
            ctypes.c_void_p, ctypes.c_int]
        lib.tpu3fs_rpc_fastpath_write_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.tpu3fs_rpc_chan_check.restype = ctypes.c_int
        lib.tpu3fs_rpc_chan_check.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t)]
        lib.tpu3fs_rpc_chan_store.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_size_t]
        lib.tpu3fs_rpc_chan_prune.restype = ctypes.c_uint64
        lib.tpu3fs_rpc_chan_prune.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p]
        lib.tpu3fs_rpc_chan_len.restype = ctypes.c_uint64
        lib.tpu3fs_rpc_chan_len.argtypes = [ctypes.c_void_p]
        lib.tpu3fs_rpc_chunk_lock.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.tpu3fs_rpc_chunk_unlock.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.tpu3fs_rpc_fastpath_serve.restype = ctypes.c_int
        lib.tpu3fs_rpc_fastpath_serve.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_char_p)]
        _lib = lib
        return lib


def _owned_c_buffer(lib, base_ptr, off: int, length: int):
    """Wrap [off, off+length) of a malloc'd C buffer as a zero-copy
    memoryview, taking OWNERSHIP of the buffer: a finalizer frees it when
    the last view dies (memoryviews keep the ctypes array alive, the
    array keeps the finalizer armed). Empty sections free immediately."""
    import weakref

    addr = ctypes.cast(base_ptr, ctypes.c_void_p).value
    if not length or not addr:
        lib.tpu3fs_rpc_free(base_ptr)
        return b""
    try:
        arr = (ctypes.c_uint8 * (off + length)).from_address(addr)
        weakref.finalize(arr, lib.tpu3fs_rpc_free, ctypes.c_void_p(addr))
    except BaseException:
        lib.tpu3fs_rpc_free(base_ptr)
        raise
    # ctypes arrays export format "<B", which memoryview indexing refuses;
    # cast to plain "B" (still zero-copy, still keeps `arr` alive)
    return memoryview(arr).cast("B")[off:off + length]


def _malloc_bytes(lib, data) -> int:
    """Copy bytes into a malloc'd buffer the C side takes ownership of."""
    buf = lib.tpu3fs_rpc_alloc(len(data) or 1)
    ctypes.memmove(buf, bytes(data), len(data))
    return buf


def _malloc_section(lib, iovs):
    """Assemble a bulk section (header + segments) into one malloc'd
    buffer for the C side to writev after the envelope. The single copy on
    the native server's trampoline reply path (engine buffer views append
    straight into the section — no intermediate bytes objects)."""
    section = bytearray(pack_bulk_header(iovs))
    for iov in iovs:
        section += iov  # bytearray += copies from any buffer, no temps
    total = len(section)
    buf = lib.tpu3fs_rpc_alloc(total or 1)
    if total:
        ctypes.memmove(buf,
                       (ctypes.c_char * total).from_buffer(section), total)
    return buf, total


class NativeRpcServer:
    """RpcServer lookalike on the native epoll transport."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 num_workers: int = 4):
        self._lib = _load_lib()
        self._services: Dict[int, ServiceDef] = {}
        # the callback object must outlive the server: keep a reference
        self._cb = _HANDLER_T(self._handle)
        self._started = False
        self._admission = None
        self._admission_exempt: frozenset = frozenset()
        # bind + run the event loop now so .port is known before start(),
        # matching RpcServer which binds in __init__; dispatch is gated on
        # started so early connections get SHUTTING_DOWN, not half-wired
        # services
        self._srv = self._lib.tpu3fs_rpc_server_create(
            host.encode(), port, self._cb, num_workers
        )
        if not self._srv:
            raise FsError(Status(Code.RPC_CONNECT_FAILED,
                                 f"bind {host}:{port}"))
        self.host = host
        self.port = self._lib.tpu3fs_rpc_server_port(self._srv)

    def add_service(self, service: ServiceDef) -> None:
        if service.service_id in self._services:
            raise ValueError(f"duplicate service id {service.service_id}")
        self._services[service.service_id] = service

    def set_admission(self, admission, exempt=()) -> None:
        """Mirror RpcServer.set_admission. The Python dispatch trampoline
        enforces the full (service, method, class) admission; additionally
        a CHEAP per-service token ceiling runs inside the C++ worker
        (hostsrc/rpc_net.cpp) so extreme overload sheds before frames ever
        cross into Python — including fast-path reads. The ceiling follows
        hot config updates via the controller's reload hook."""
        self._admission = admission
        self._admission_exempt = frozenset(exempt)
        if admission is not None:
            admission.add_reload_hook(lambda _adm: self._sync_native_qos())
        self._sync_native_qos()
        # the per-TENANT fast-path gate mirrors the [tenants] quota table
        # the same way (hot pushes re-sync via the registry's reload
        # hook); weakref so the process-global registry never pins a
        # stopped test server
        import weakref

        from tpu3fs_torch.tenant.quota import registry as _treg

        wself = weakref.ref(self)

        def _tenant_hook(_reg):
            s = wself()
            if s is not None:
                s._sync_native_tenants()

        _treg().add_reload_hook(_tenant_hook)

    def _sync_native_qos(self) -> None:
        if self._srv is None or self._admission is None:
            return
        cfg = self._admission.config
        self._lib.tpu3fs_rpc_qos_clear(self._srv)
        # per-class gates for the storage read fast path: ops it serves
        # never cross into Python, so the per-class rate limits from
        # QosConfig are enforced by C-side buckets keyed on the envelope's
        # class bits (wire code = TrafficClass + 1; qos/core.py
        # class_to_flags). A fast-path fallback refunds its take, so
        # Python-dispatched ops are never charged twice.
        from tpu3fs_torch.qos.core import CLASS_ATTRS
        from tpu3fs_torch.rpc.services import STORAGE_SERVICE_ID

        if STORAGE_SERVICE_ID in self._services:
            for tclass, attr in CLASS_ATTRS.items():
                sect = getattr(cfg, attr)
                if float(sect.rate) > 0:
                    self._lib.tpu3fs_rpc_qos_set_class(
                        self._srv, STORAGE_SERVICE_ID,
                        int(tclass) + 1, float(sect.rate),
                        float(sect.burst),
                        int(cfg.shed_retry_after_ms))
        rate = float(cfg.native_ceiling_rate)
        if rate <= 0:
            return
        for sid in self._services:
            self._lib.tpu3fs_rpc_qos_set(
                self._srv, sid, rate, float(cfg.native_ceiling_burst),
                int(cfg.shed_retry_after_ms))

    def qos_shed_count(self) -> int:
        if self._srv is None:
            return 0
        return int(self._lib.tpu3fs_rpc_qos_shed_count(self._srv))

    def _sync_native_tenants(self) -> None:
        """Install the [tenants] quota table into the C-side per-tenant
        fast-path gate (hostsrc/rpc_net.cpp TenantGate): exact-name rows
        only — unconfigured tenants pass free in C and are charged by
        Python's lazily-minted default-quota buckets on the fallback
        path. Background classes are exempt via a wire-code mask, and a
        fast-path fallback refunds the C iops take (Python charges the
        op again), so no op ever pays a tenant bucket twice."""
        if self._srv is None:
            return
        from tpu3fs_torch.rpc.services import STORAGE_SERVICE_ID

        if STORAGE_SERVICE_ID not in self._services:
            return  # only storage serves reads below Python
        from tpu3fs_torch.qos.core import BACKGROUND_CLASSES
        from tpu3fs_torch.tenant.quota import registry as _treg

        reg = _treg()
        mask = 0
        for tc in BACKGROUND_CLASSES:
            mask |= 1 << (int(tc) + 1)
        self._lib.tpu3fs_rpc_tenant_exempt_classes(self._srv, mask)
        self._lib.tpu3fs_rpc_tenant_clear(self._srv)
        if not reg.enabled:
            return
        for name, q in reg.table_snapshot().items():
            self._lib.tpu3fs_rpc_tenant_set(
                self._srv, name.encode(),
                float(q.iops), max(1.0, q.iops * q.burst_s),
                float(q.bytes_per_s),
                max(1.0, q.bytes_per_s * q.burst_s))

    def tenant_shed_count(self) -> int:
        if self._srv is None:
            return 0
        return int(self._lib.tpu3fs_rpc_tenant_shed_count(self._srv))

    def start(self) -> None:
        self._started = True
        self._sync_native_qos()

    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    def stop(self) -> None:
        self._started = False
        if self._srv is not None:
            self._lib.tpu3fs_rpc_server_stop(self._srv)
            self._srv = None

    # -- storage read fast path (hostsrc/rpc_net.cpp FpState) ----------------
    def fastpath_install(self, batch_read_fn) -> None:
        if self._srv is not None:
            self._lib.tpu3fs_rpc_fastpath_install(self._srv, batch_read_fn)

    def fastpath_sync(self, batch_read_fn, wanted: dict) -> None:
        """Reconcile the registry to exactly `wanted`:
        {target_id: (engine_handle, chain_id, chunk_size)}. The transient
        empty registry during the rebuild only means a momentary fallback
        to the Python dispatch — never a wrong answer."""
        if self._srv is None:
            return
        if batch_read_fn is not None:
            self._lib.tpu3fs_rpc_fastpath_install(self._srv, batch_read_fn)
        self._lib.tpu3fs_rpc_fastpath_clear(self._srv)
        for target_id, (h, chain_id, chunk_size) in wanted.items():
            self._lib.tpu3fs_rpc_fastpath_set_target(
                self._srv, target_id, h, chain_id, chunk_size)

    def fastpath_del_target(self, target_id: int) -> None:
        """Drop one target now (read registry AND any write-chain entry
        whose tail it is); drains in-flight ops before returning."""
        if self._srv is not None:
            self._lib.tpu3fs_rpc_fastpath_del_target(self._srv, target_id)

    def fastpath_sync_write(self, batch_write_fn, wanted: dict) -> None:
        """Install the write-chain registry:
        {chain_id: (engine_handle, target_id, chain_ver, chunk_size)} —
        chains whose LOCAL target is the serving tail. Call AFTER
        fastpath_sync (whose clear() drops both registries)."""
        if self._srv is None:
            return
        if batch_write_fn is not None:
            self._lib.tpu3fs_rpc_fastpath_install_write(
                self._srv, batch_write_fn)
        for chain_id, (h, target_id, chain_ver, chunk_size) in wanted.items():
            self._lib.tpu3fs_rpc_fastpath_set_write_chain(
                self._srv, chain_id, h, target_id, chain_ver, chunk_size)

    def fastpath_stats(self):
        hits = ctypes.c_uint64(0)
        fallbacks = ctypes.c_uint64(0)
        if self._srv is not None:
            self._lib.tpu3fs_rpc_fastpath_stats(
                self._srv, ctypes.byref(hits), ctypes.byref(fallbacks))
        return hits.value, fallbacks.value

    # -- head-side write fast path (ABI v5: native/rpc_net.cpp) --------------
    def fastpath_sync_head(self, stage_fn, commit_fn, wanted: dict) -> None:
        """Install the head-chain registry:
        {chain_id: (engine_handle, target_id, chain_ver, chunk_size,
        reject_create, succ_host, succ_port)} — chains whose LOCAL target
        is the serving head (succ_port 0 = single-member chain, no
        forward). Call AFTER fastpath_sync (whose clear() drops all three
        registries)."""
        if self._srv is None:
            return
        if stage_fn is not None and commit_fn is not None:
            self._lib.tpu3fs_rpc_fastpath_install_head(
                self._srv, stage_fn, commit_fn)
        for chain_id, (h, target_id, chain_ver, chunk_size, reject_create,
                       succ_host, succ_port) in wanted.items():
            self._lib.tpu3fs_rpc_fastpath_set_head_chain(
                self._srv, chain_id, h, target_id, chain_ver, chunk_size,
                1 if reject_create else 0,
                (succ_host or "").encode(), int(succ_port))

    def fastpath_set_skip_crc(self, enable: bool) -> None:
        """Arm/disarm the planted chaos bug native_commit_skip_crc: the
        native head commits + acks without verifying the successor."""
        if self._srv is not None:
            self._lib.tpu3fs_rpc_fastpath_skip_crc(
                self._srv, 1 if enable else 0)

    def fastpath_write_stats(self):
        """-> (write_served, write_fallbacks, forward_us)."""
        served = ctypes.c_uint64(0)
        fallbacks = ctypes.c_uint64(0)
        fwd_us = ctypes.c_uint64(0)
        if self._srv is not None:
            self._lib.tpu3fs_rpc_fastpath_write_stats(
                self._srv, ctypes.byref(served), ctypes.byref(fallbacks),
                ctypes.byref(fwd_us))
        return served.value, fallbacks.value, fwd_us.value

    # -- shared exactly-once channel table (C mirror of _ChannelTable) -------
    def chan_check(self, client_id: str, channel_id: int, seqnum: int):
        """-> (0, None) fresh / (1, reply bytes) cached dup / (2, None)
        stale seqnum."""
        if self._srv is None:
            return 0, None
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t(0)
        rc = self._lib.tpu3fs_rpc_chan_check(
            self._srv, client_id.encode(), channel_id, seqnum,
            ctypes.byref(out), ctypes.byref(out_len))
        reply = None
        if rc == 1:
            reply = ctypes.string_at(out, out_len.value) \
                if out_len.value else b""
            self._lib.tpu3fs_rpc_free(ctypes.cast(out, ctypes.c_void_p))
        return rc, reply

    def chan_store(self, client_id: str, channel_id: int, seqnum: int,
                   reply: bytes) -> None:
        if self._srv is not None:
            self._lib.tpu3fs_rpc_chan_store(
                self._srv, client_id.encode(), channel_id, seqnum,
                reply, len(reply))

    def chan_prune(self, client_id: str) -> int:
        if self._srv is not None:
            return int(self._lib.tpu3fs_rpc_chan_prune(
                self._srv, client_id.encode()))
        return 0

    def chan_len(self) -> int:
        if self._srv is None:
            return 0
        return int(self._lib.tpu3fs_rpc_chan_len(self._srv))

    # -- shared per-chunk write interlock ------------------------------------
    def chunk_lock(self, keys: bytes) -> None:
        """Acquire the C-side chunk locks for len(keys)//12 concatenated
        12-byte keys (all-or-wait; the ctypes call releases the GIL, so
        blocking on a native worker's hold is safe)."""
        if self._srv is not None:
            self._lib.tpu3fs_rpc_chunk_lock(self._srv, keys, len(keys) // 12)

    def chunk_unlock(self, keys: bytes) -> None:
        if self._srv is not None:
            self._lib.tpu3fs_rpc_chunk_unlock(
                self._srv, keys, len(keys) // 12)

    # -- out-of-loop serve (dispatch_packet's native hook) -------------------
    def fastpath_serve(self, pkt, bulk):
        """First-refusal native serve for frames that arrived outside the
        C socket loop (the USRBIO ring host routes SQEs through
        dispatch_packet, which calls this when present). -> None when the
        Python dispatch must run, else (status, payload bytes, message) —
        the whole stage/forward/commit runs with the GIL released."""
        if self._srv is None or not self._started:
            return None
        payload = bytes(pkt.payload)
        buf = (ctypes.c_uint8 * max(len(payload), 1)).from_buffer_copy(
            payload or b"\x00")
        n_iovs = -1
        ptrs = None
        lens = None
        keepalive = []
        if bulk is not None:
            n_iovs = len(bulk)
            ptrs = (ctypes.c_void_p * max(n_iovs, 1))()
            lens = (ctypes.c_size_t * max(n_iovs, 1))()
            for i, iov in enumerate(bulk):
                if isinstance(iov, bytes):
                    ref = ctypes.c_char_p(iov)
                    keepalive.append((iov, ref))
                    ptrs[i] = ctypes.cast(ref, ctypes.c_void_p)
                    lens[i] = len(iov)
                    continue
                try:  # writable buffers (shm ring views) borrow in place
                    arr = (ctypes.c_char * len(iov)).from_buffer(iov)
                    keepalive.append(arr)
                    ptrs[i] = ctypes.addressof(arr)
                    lens[i] = len(iov)
                except (TypeError, ValueError):
                    b = bytes(iov)
                    ref = ctypes.c_char_p(b)
                    keepalive.append((b, ref))
                    ptrs[i] = ctypes.cast(ref, ctypes.c_void_p)
                    lens[i] = len(b)
        status = ctypes.c_int64(0)
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t(0)
        out_msg = ctypes.c_char_p()
        rc = self._lib.tpu3fs_rpc_fastpath_serve(
            self._srv, pkt.service_id, pkt.method_id, pkt.flags,
            (pkt.message or "").encode(), buf, len(payload),
            ptrs, lens, n_iovs,
            ctypes.byref(status), ctypes.byref(out),
            ctypes.byref(out_len), ctypes.byref(out_msg))
        del keepalive
        if rc == 0:
            return None
        reply = ctypes.string_at(out, out_len.value) if out_len.value else b""
        message = (out_msg.value or b"").decode("utf-8", "replace")
        self._lib.tpu3fs_rpc_free(ctypes.cast(out, ctypes.c_void_p))
        self._lib.tpu3fs_rpc_free(ctypes.cast(out_msg, ctypes.c_void_p))
        return int(status.value), reply, message

    # -- dispatch (same semantics as RpcServer._dispatch) -------------------
    def _handle(self, service_id, method_id, flags, req_msg, req_ptr,
                req_len, bulk_ptr, bulk_len, has_bulk,
                out_rsp, out_rsp_len, out_bulk, out_bulk_len,
                out_msg) -> int:
        try:
            if not self._started:
                return self._err(out_msg, Code.SHUTTING_DOWN, "not started")
            payload = ctypes.string_at(req_ptr, req_len) if req_len else b""
            service = self._services.get(service_id)
            if service is None:
                return self._err(out_msg, Code.RPC_SERVICE_NOT_FOUND,
                                 str(service_id))
            mdef = service.methods.get(method_id)
            if mdef is None:
                return self._err(out_msg, Code.RPC_METHOD_NOT_FOUND,
                                 f"{service.name}.{method_id}")
            msg_str = (req_msg or b"").decode("utf-8", "replace")
            # cluster fault plane at the dispatch boundary (mirrors
            # RpcServer._dispatch); drop rules surface as PEER_CLOSED on
            # this transport (the C side owns the socket, so the bridge
            # answers an error instead of tearing the stream)
            from tpu3fs_torch.rpc import deadline as _dl
            from tpu3fs_torch.utils.fault_injection import plane as _fault_plane

            try:
                _fault_plane().fire(
                    f"rpc.dispatch.{service.name}.{mdef.name}")
            except FsError as e:
                return self._err(out_msg, e.code, e.status.message)
            except ConnectionError as e:
                return self._err(out_msg, Code.RPC_PEER_CLOSED, str(e))
            # DEADLINE admission shed before request decode (expired work
            # never reaches the engine; rpc/deadline.py)
            import time as _time

            dl = _dl.decode_deadline(msg_str) if msg_str else None
            if dl is not None and _time.time() > dl:
                _dl.record_shed("admission")
                return self._err(
                    out_msg, Code.DEADLINE_EXCEEDED,
                    f"deadline passed before "
                    f"{service.name}.{mdef.name} admission")
            # TENANT resolution + quota admission (mirrors
            # RpcServer._dispatch): the envelope's u1.* token names the
            # owner; bytes/iops-classified methods charge its buckets
            # before request decode, shedding TENANT_THROTTLED with a
            # retry-after hint
            from tpu3fs_torch.tenant import identity as _tid

            tenant = _tid.decode_tenant(msg_str) if msg_str else None
            tname = tenant or _tid.DEFAULT_TENANT
            if service_id not in self._admission_exempt:
                from tpu3fs_torch.qos.core import format_retry_after
                from tpu3fs_torch.tenant import enforcement as _tenf
                from tpu3fs_torch.tenant.quota import registry as _treg

                kind = _tenf.enforcement_of(service.name, mdef.name)
                if kind in (_tenf.BYTES, _tenf.IOPS):
                    nbytes = 0
                    if kind == _tenf.BYTES:
                        nbytes = int(req_len) + (int(bulk_len)
                                                 if has_bulk else 0)
                    t_shed = _treg().try_admit(tname, nbytes=nbytes)
                    if t_shed is not None:
                        return self._err(
                            out_msg, Code.TENANT_THROTTLED,
                            format_retry_after(
                                t_shed,
                                f"tenant {tname} over quota at "
                                f"{service.name}.{mdef.name}"))
            # QoS admission by the envelope's traffic-class bits (handler
            # ABI v3 threads `flags` through): a tagged peer is admitted
            # as its declared class; untagged ops classify by method name
            # (default_class_for) inside the controller
            from tpu3fs_torch.qos.core import class_from_flags

            tclass = class_from_flags(flags)
            lease = None
            if self._admission is not None \
                    and service_id not in self._admission_exempt:
                from tpu3fs_torch.qos.core import format_retry_after

                lease, shed_ms = self._admission.try_admit(
                    service.name, mdef.name, tclass, tenant=tname)
                if lease is None:
                    return self._err(
                        out_msg, Code.OVERLOADED,
                        format_retry_after(shed_ms,
                                           f"{service.name}.{mdef.name}"))
            bulk = None
            if has_bulk:
                if not mdef.bulk:
                    return self._err(
                        out_msg, Code.RPC_BAD_REQUEST,
                        f"{service.name}.{mdef.name} is not bulk-capable")
                # ONE owned copy of the section — the native frame buffer
                # dies when this callback returns, but handlers may retain
                # segments (per-target update queues)
                section = (ctypes.string_at(bulk_ptr, bulk_len)
                           if bulk_len else b"")
                bulk = split_bulk(section)
            try:
                try:
                    req = deserialize(payload, mdef.req_type)
                except Exception as e:
                    return self._err(out_msg, Code.RPC_BAD_REQUEST, repr(e))
                try:
                    # restore the peer's class around the handler so
                    # service internals (update-queue scheduling, read
                    # gates) see the tag — mirrors RpcServer._dispatch
                    import contextlib
                    import time as _time

                    from tpu3fs_torch.analytics import spans as _spans
                    from tpu3fs_torch.qos.core import tagged

                    # distributed tracing (mirrors RpcServer._dispatch):
                    # the peer's context rides the envelope message,
                    # threaded through the handler ABI (v4) as req_msg
                    sctx = None
                    if _spans.tracer().enabled:
                        in_ctx = _spans.decode_wire(msg_str)
                        sctx = (in_ctx.child() if in_ctx is not None
                                else _spans.tracer().start_trace())
                    t0 = _time.perf_counter()
                    ctx = (tagged(tclass) if tclass is not None
                           else contextlib.nullcontext())
                    dctx = (_dl.deadline_scope(dl) if dl is not None
                            else contextlib.nullcontext())
                    # the peer's tenant scopes the handler (mirrors
                    # RpcServer._dispatch): storage internal admission
                    # and update-queue lanes see the envelope's owner
                    tctx = (_tid.tenant_scope(tenant)
                            if tenant is not None
                            else contextlib.nullcontext())
                    with ctx, dctx, tctx, _spans.trace_scope(sctx) \
                            if sctx is not None \
                            else contextlib.nullcontext():
                        if mdef.bulk:
                            rsp, reply_iovs = mdef.handler(req, bulk)
                        else:
                            rsp = mdef.handler(req)
                            reply_iovs = None
                    raw = serialize(rsp, mdef.rsp_type)
                    if sctx is not None:
                        dur = _time.perf_counter() - t0
                        _spans.tracer().finish_op(
                            sctx, f"rpc.{service.name}.{mdef.name}",
                            _time.time() - dur, dur,
                            tclass=(tclass.name.lower()
                                    if tclass is not None else ""),
                            tenant=tname)
                except FsError as e:
                    return self._err(out_msg, e.code, e.status.message)
                except Exception as e:
                    return self._err(out_msg, Code.INTERNAL, repr(e))
            finally:
                if lease is not None:
                    lease.release()
            out_rsp[0] = ctypes.cast(
                _malloc_bytes(self._lib, raw), ctypes.POINTER(ctypes.c_uint8)
            )
            out_rsp_len[0] = len(raw)
            if reply_iovs is not None:
                buf, total = _malloc_section(self._lib, reply_iovs)
                out_bulk[0] = ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8))
                out_bulk_len[0] = total
            return int(Code.OK)
        except Exception:  # never let an exception cross the FFI boundary
            return int(Code.INTERNAL)

    def _err(self, out_msg, code: Code, msg: str) -> int:
        raw = msg.encode()[:4096] + b"\x00"
        out_msg[0] = ctypes.cast(
            _malloc_bytes(self._lib, raw), ctypes.c_char_p
        )
        return int(code)


class _NativeConn:
    def __init__(self, handle):
        self.handle = handle
        self.lock = threading.Lock()


class NativeRpcClient:
    """RpcClient lookalike over the native blocking client."""

    def __init__(self, connect_timeout: float = 5.0, call_timeout: float = 30.0):
        self._lib = _load_lib()
        self._pools: Dict[Tuple[str, int], list] = {}
        self._lock = threading.Lock()
        self._connect_ms = int(connect_timeout * 1000)
        self._timeout_ms = int(call_timeout * 1000)

    def _get_conn(self, addr: Tuple[str, int]) -> _NativeConn:
        with self._lock:
            pool = self._pools.setdefault(addr, [])
            for conn in pool:
                if conn.lock.acquire(blocking=False):
                    return conn
        handle = self._lib.tpu3fs_rpc_client_connect(
            addr[0].encode(), addr[1], self._connect_ms, self._timeout_ms
        )
        if not handle:
            raise FsError(Status(Code.RPC_CONNECT_FAILED, str(addr)))
        conn = _NativeConn(handle)
        conn.lock.acquire()
        with self._lock:
            self._pools[addr].append(conn)
        return conn

    def _drop_conn(self, addr: Tuple[str, int], conn: _NativeConn) -> None:
        with self._lock:
            pool = self._pools.get(addr, [])
            if conn in pool:
                pool.remove(conn)
        self._lib.tpu3fs_rpc_client_close(conn.handle)
        conn.handle = None

    def call(
        self,
        addr: Tuple[str, int],
        service_id: int,
        method_id: int,
        req: Any,
        rsp_type: Type,
        *,
        req_type: Optional[Type] = None,
    ) -> Any:
        rsp, _ = self.call_bulk(addr, service_id, method_id, req, rsp_type,
                                req_type=req_type)
        return rsp

    @staticmethod
    def _marshal_req(req, req_type, bulk_iovs):
        """-> (raw, c buffer, iov arrays, n_iovs, keepalive list)."""
        raw = serialize(req, req_type or type(req))
        buf = (ctypes.c_uint8 * max(len(raw), 1)).from_buffer_copy(
            raw or b"\x00")
        n_iovs = -1
        iov_ptrs = None
        iov_lens = None
        keepalive = []
        if bulk_iovs is not None:
            n_iovs = len(bulk_iovs)
            arr_p = (ctypes.c_void_p * max(n_iovs, 1))()
            arr_l = (ctypes.c_size_t * max(n_iovs, 1))()
            for i, iov in enumerate(bulk_iovs):
                # c_char_p on a bytes object points at its internal buffer
                # (no copy); writable buffers (memoryview gathers from the
                # write path) borrow their address via from_buffer; only
                # read-only non-bytes buffers take an owned copy
                if isinstance(iov, bytes):
                    ref = ctypes.c_char_p(iov)
                    keepalive.append((iov, ref))
                    arr_p[i] = ctypes.cast(ref, ctypes.c_void_p)
                    arr_l[i] = len(iov)
                    continue
                try:
                    arr = (ctypes.c_char * len(iov)).from_buffer(iov)
                    keepalive.append(arr)
                    arr_p[i] = ctypes.addressof(arr)
                    arr_l[i] = len(iov)
                except (TypeError, ValueError):
                    b = bytes(iov)  # copy-ok: read-only non-bytes buffer
                    ref = ctypes.c_char_p(b)
                    keepalive.append((b, ref))
                    arr_p[i] = ctypes.cast(ref, ctypes.c_void_p)
                    arr_l[i] = len(b)
            iov_ptrs = arr_p
            iov_lens = arr_l
        return raw, buf, iov_ptrs, iov_lens, n_iovs, keepalive

    def _unmarshal_reply(self, status, rsp_ptr, rsp_len, bulk_ptr, bulk_off,
                         bulk_len, has_bulk, msg_ptr, rsp_type):
        section = None
        try:
            if has_bulk.value:
                # ZERO-COPY hand-off: bulk_ptr is the malloc'd FRAME
                # buffer recv'd straight from the kernel, with the raw
                # section at bulk_off. Wrap it in place (ownership passes
                # unconditionally); a finalizer frees the C buffer when
                # the last memoryview dies.
                section = _owned_c_buffer(
                    self._lib, bulk_ptr, bulk_off.value, bulk_len.value)
            payload = ctypes.string_at(rsp_ptr, rsp_len.value) \
                if rsp_len.value else b""
            message = (msg_ptr.value or b"").decode("utf-8", "replace")
        finally:
            self._lib.tpu3fs_rpc_free(rsp_ptr)
            self._lib.tpu3fs_rpc_free(
                ctypes.cast(msg_ptr, ctypes.c_void_p))
        if status.value != int(Code.OK):
            raise FsError(Status(Code(status.value), message))
        segments = split_bulk(section) if section is not None else None
        return deserialize(payload, rsp_type), segments

    @staticmethod
    def _fire_send_fault(addr, service_id: int, method_id: int) -> None:
        """Client-side fault-plane hook at the send boundary (mirrors the
        Python transport's start_call hook)."""
        from tpu3fs_torch.utils.fault_injection import plane as _fault_plane

        try:
            _fault_plane().fire(f"rpc.send.{service_id}.{method_id}")
        except ConnectionError as e:
            raise FsError(Status(Code.RPC_PEER_CLOSED, f"{addr}: {e}"))

    @staticmethod
    def _class_flags() -> int:
        """The calling thread's QoS class as envelope flag bits, so the
        native server's admission (and its read fast path's per-class
        gates) see the tag the Python transport already carries."""
        from tpu3fs_torch.qos.core import class_to_flags, current_class

        return class_to_flags(current_class())

    @staticmethod
    def _trace_hop():
        """-> (rpc child context | None, envelope message bytes | None):
        the trace + deadline + tenant stamping the Python client does in
        start_call, for the native send entry points (all three ride the
        same envelope message field; rpc/deadline.py,
        tenant/identity.py)."""
        from tpu3fs_torch.analytics import spans as _spans
        from tpu3fs_torch.rpc import deadline as _dl
        from tpu3fs_torch.tenant import identity as _tid

        ctx = _spans.current_trace()
        rpc_ctx = ctx.child() if ctx is not None else None
        msg = _tid.append_wire(
            _dl.encode_envelope(
                rpc_ctx.to_wire() if rpc_ctx is not None else "",
                _dl.current_deadline()),
            _tid.current_tenant())
        return rpc_ctx, (msg.encode() if msg else None)

    @staticmethod
    def _trace_finish(rpc_ctx, service_id, method_id, t0, status) -> None:
        if rpc_ctx is None:
            return
        import time as _time

        from tpu3fs_torch.analytics import spans as _spans

        dur = _time.perf_counter() - t0
        _spans.tracer().end_op(
            rpc_ctx, f"rpc.client.{service_id}.{method_id}",
            _time.time() - dur, dur,
            code=status if status != int(Code.OK) else 0)

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
    ):
        """call() with bulk riders both ways -> (rsp, reply_segments|None).
        Request buffers are handed to the native writev as raw pointers —
        zero-copy for bytes; reply segments are memoryviews over one
        python-owned copy of the reply section."""
        raw, buf, iov_ptrs, iov_lens, n_iovs, keepalive = \
            self._marshal_req(req, req_type, bulk_iovs)
        status = ctypes.c_int64(0)
        rsp_ptr = ctypes.POINTER(ctypes.c_uint8)()
        rsp_len = ctypes.c_size_t(0)
        bulk_ptr = ctypes.POINTER(ctypes.c_uint8)()
        bulk_off = ctypes.c_size_t(0)
        bulk_len = ctypes.c_size_t(0)
        has_bulk = ctypes.c_int(0)
        msg_ptr = ctypes.c_char_p()
        rpc_ctx, trace_msg = self._trace_hop()
        self._fire_send_fault(addr, service_id, method_id)
        import time as _time

        t0 = _time.perf_counter()
        conn = self._get_conn(addr)
        try:
            rc = self._lib.tpu3fs_rpc_client_call3(
                conn.handle, service_id, method_id, self._class_flags(),
                trace_msg, buf, len(raw),
                iov_ptrs, iov_lens, n_iovs,
                ctypes.byref(status), ctypes.byref(rsp_ptr),
                ctypes.byref(rsp_len),
                ctypes.byref(bulk_ptr), ctypes.byref(bulk_off),
                ctypes.byref(bulk_len),
                ctypes.byref(has_bulk),
                ctypes.byref(msg_ptr),
            )
            if rc == -5:
                # the caller's sizing error, caught by the C side before
                # any bytes moved: the pooled connection is healthy —
                # don't drop or mislabel it as a peer failure
                raise FsError(Status(
                    Code.RPC_BAD_REQUEST,
                    f"{addr}: request exceeds max packet"))
            if rc != 0:
                self._drop_conn(addr, conn)
                code = Code.RPC_TIMEOUT if rc == -2 else Code.RPC_PEER_CLOSED
                raise FsError(Status(code, f"{addr}: transport rc={rc}"))
        finally:
            del keepalive
            if conn.lock.locked():
                conn.lock.release()
        self._trace_finish(rpc_ctx, service_id, method_id, t0, status.value)
        return self._unmarshal_reply(status, rsp_ptr, rsp_len, bulk_ptr,
                                     bulk_off, bulk_len, has_bulk, msg_ptr,
                                     rsp_type)

    # -- pipelined split (multi-connection striped read fan-out) -------------
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
    ):
        """Issue the request NOW on an exclusively-leased connection and
        return a pending handle; finish_call collects the reply. Callers
        may start many calls (each takes its own pooled connection) before
        finishing any — the pipelined issue of the striped read fan-out."""
        raw, buf, iov_ptrs, iov_lens, n_iovs, keepalive = \
            self._marshal_req(req, req_type, bulk_iovs)
        rpc_ctx, trace_msg = self._trace_hop()
        self._fire_send_fault(addr, service_id, method_id)
        import time as _time

        t0 = _time.perf_counter()
        conn = self._get_conn(addr)
        try:
            rc = self._lib.tpu3fs_rpc_client_send(
                conn.handle, service_id, method_id, self._class_flags(),
                trace_msg, buf, len(raw), iov_ptrs, iov_lens, n_iovs)
        except BaseException:
            if conn.lock.locked():
                conn.lock.release()
            raise
        finally:
            del keepalive
        if rc == -5:
            conn.lock.release()
            raise FsError(Status(Code.RPC_BAD_REQUEST,
                                 f"{addr}: request exceeds max packet"))
        if rc != 0:
            self._drop_conn(addr, conn)
            conn.lock.release()
            # RPC_PEER_CLOSED: the same code the monolithic call maps send
            # failures to, so retry ladders behave identically
            raise FsError(Status(Code.RPC_PEER_CLOSED,
                                 f"{addr}: transport rc={rc}"))
        if rpc_ctx is not None:
            from tpu3fs_torch.analytics import spans as _spans

            dur = _time.perf_counter() - t0
            _spans.add_span(rpc_ctx, "rpc.client", "issue",
                            _time.time() - dur, dur)
        return (addr, conn, rsp_type, service_id, method_id, rpc_ctx, t0)

    def finish_call(self, pending):
        """Collect the reply of a start_call -> (rsp, segments|None)."""
        addr, conn, rsp_type, service_id, method_id, rpc_ctx, t0 = pending
        import time as _time

        t1 = _time.perf_counter()
        status = ctypes.c_int64(0)
        rsp_ptr = ctypes.POINTER(ctypes.c_uint8)()
        rsp_len = ctypes.c_size_t(0)
        bulk_ptr = ctypes.POINTER(ctypes.c_uint8)()
        bulk_off = ctypes.c_size_t(0)
        bulk_len = ctypes.c_size_t(0)
        has_bulk = ctypes.c_int(0)
        msg_ptr = ctypes.c_char_p()
        try:
            rc = self._lib.tpu3fs_rpc_client_recv(
                conn.handle,
                ctypes.byref(status), ctypes.byref(rsp_ptr),
                ctypes.byref(rsp_len),
                ctypes.byref(bulk_ptr), ctypes.byref(bulk_off),
                ctypes.byref(bulk_len),
                ctypes.byref(has_bulk), ctypes.byref(msg_ptr))
            if rc != 0:
                self._drop_conn(addr, conn)
                code = Code.RPC_TIMEOUT if rc == -2 else Code.RPC_PEER_CLOSED
                raise FsError(Status(code, f"{addr}: transport rc={rc}"))
        finally:
            if conn.lock.locked():
                conn.lock.release()
        if rpc_ctx is not None:
            import time as _time

            from tpu3fs_torch.analytics import spans as _spans

            dur = _time.perf_counter() - t1
            _spans.add_span(rpc_ctx, "rpc.client", "collect",
                            _time.time() - dur, dur)
            self._trace_finish(rpc_ctx, service_id, method_id, t0,
                               status.value)
        return self._unmarshal_reply(status, rsp_ptr, rsp_len, bulk_ptr,
                                     bulk_off, bulk_len, has_bulk, msg_ptr,
                                     rsp_type)

    def close(self) -> None:
        with self._lock:
            for pool in self._pools.values():
                for conn in pool:
                    if conn.handle:
                        self._lib.tpu3fs_rpc_client_close(conn.handle)
                        conn.handle = None
            self._pools.clear()
