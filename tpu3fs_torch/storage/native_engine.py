"""ctypes wrapper for the native C++ chunk engine (hostsrc/chunk_engine.cpp).

The port's own copy of ``tpu3fs/storage/native_engine.py``. The library is
the port's copy of ``native/chunk_engine.cpp``, built by ``hostbuild`` with
``g++`` into ``_build/`` under a name that carries its source's digest, so
a stale library is never loaded and nothing under ``native/`` is read or
written. The C structs and the ABI tag are the JAX package's: either
package opens a data dir the other wrote.

The chunk CRCs are computed in C++ on the host while staging (slice-by-8
CRC32C, bit-exact with kernel K2), not on the card: the mem engine
checksums through ``crc32c_many`` (K2) on its ``device``, this engine
never. ``device`` is kept only so a target reports the device of the
service it belongs to.

Implements the same ChunkEngine interface as MemChunkEngine, so StorageTarget
swaps engines by config exactly like the reference's only_chunk_engine switch
(src/storage/store/StorageTarget.h:85-162; native engine semantics ported
from src/storage/chunk_engine). Chunks live in size-class data files plus
a write-ahead log under the engine's directory and survive a restart.
"""

from __future__ import annotations

import ctypes
import os
import tempfile
import threading
from typing import List, Optional

from tpu3fs_torch import hostbuild
from tpu3fs_torch.device import resolve_device
from tpu3fs_torch.storage.engine import ChunkEngine, EngineOpResult
from tpu3fs_torch.storage.types import Checksum, ChunkId, ChunkMeta
from tpu3fs_torch.utils.result import Code, FsError, err as _err

_ERR_TO_CODE = {
    -1: Code.CHUNK_NOT_FOUND,
    -2: Code.CHUNK_NOT_COMMIT,
    -3: Code.CHUNK_STALE_UPDATE,
    -4: Code.CHUNK_MISSING_UPDATE,
    -5: Code.CHUNK_ADVANCE_UPDATE,
    -6: Code.ENGINE_ERROR,
    -7: Code.INVALID_ARG,
    -8: Code.NO_SPACE,
    -9: Code.CHUNK_CHECKSUM_MISMATCH,
}

_KEYLEN = 12

# valid (never-read) address for zero-length payloads in iovec-mode batch
# updates: a NULL src with len 0 would still be UB in the C memcpy
_EMPTY_PAYLOAD = ctypes.create_string_buffer(1)


class _CMeta(ctypes.Structure):
    _fields_ = [
        ("committed_ver", ctypes.c_uint64),
        ("pending_ver", ctypes.c_uint64),
        ("chain_ver", ctypes.c_uint64),
        ("length", ctypes.c_uint32),
        ("crc", ctypes.c_uint32),
        ("pending_length", ctypes.c_uint32),
        ("pending_crc", ctypes.c_uint32),
        ("aux", ctypes.c_uint32),
        ("key", ctypes.c_uint8 * _KEYLEN),
    ]


class _CUpOp(ctypes.Structure):
    _fields_ = [
        ("key", ctypes.c_uint8 * _KEYLEN),
        ("flags", ctypes.c_uint8),
        ("pad0", ctypes.c_uint8 * 3),
        ("offset", ctypes.c_uint32),
        ("data_len", ctypes.c_uint32),
        ("chunk_size", ctypes.c_uint32),
        ("aux", ctypes.c_uint32),
        ("data_off", ctypes.c_uint64),
        ("update_ver", ctypes.c_uint64),
        ("expected_crc", ctypes.c_uint32),
        ("pad1", ctypes.c_uint32),
    ]


class _COpResult(ctypes.Structure):
    _fields_ = [
        ("rc", ctypes.c_int32),
        ("len", ctypes.c_uint32),
        ("crc", ctypes.c_uint32),
        ("aux", ctypes.c_uint32),
        ("ver", ctypes.c_uint64),
    ]


class _CReadOp(ctypes.Structure):
    _fields_ = [
        ("key", ctypes.c_uint8 * _KEYLEN),
        ("slot_len", ctypes.c_uint32),
        ("out_off", ctypes.c_uint64),
        ("offset", ctypes.c_uint32),
        ("length", ctypes.c_int32),
    ]


_lib = None
_lib_lock = threading.Lock()

# kAbiTag in hostsrc/chunk_engine.cpp (the JAX package's tag: the two
# packages' engines share one on-disk format); the library's name carries
# the digest of that source, so a loaded library always has it
_ABI_TAG = b"TPU3FS_ENGINE_ABI_6"


def _load_lib():
    """The engine library, built on first use (``hostbuild``), with every
    entry's argument and return types set; raises when it cannot be
    built."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = hostbuild.load("chunk_engine")
        lib.ce_open.restype = ctypes.c_void_p
        lib.ce_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.ce_close.argtypes = [ctypes.c_void_p]
        lib.ce_update.restype = ctypes.c_int
        lib.ce_update.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int, ctypes.c_uint32,
        ]
        lib.ce_commit.restype = ctypes.c_int
        lib.ce_commit.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ]
        lib.ce_read.restype = ctypes.c_int
        lib.ce_read.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_uint32, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ]
        lib.ce_read_pending.restype = ctypes.c_int
        lib.ce_read_pending.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.ce_get_meta.restype = ctypes.c_int
        lib.ce_get_meta.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(_CMeta),
        ]
        lib.ce_remove.restype = ctypes.c_int
        lib.ce_remove.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.ce_truncate.restype = ctypes.c_int
        lib.ce_truncate.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint64,
        ]
        lib.ce_query.restype = ctypes.c_int
        lib.ce_query.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.POINTER(_CMeta), ctypes.c_int,
        ]
        lib.ce_used_size.restype = ctypes.c_int64
        lib.ce_used_size.argtypes = [ctypes.c_void_p]
        lib.ce_chunk_count.restype = ctypes.c_int64
        lib.ce_chunk_count.argtypes = [ctypes.c_void_p]
        lib.ce_query_pending.restype = ctypes.c_int
        lib.ce_query_pending.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_CMeta), ctypes.c_int,
        ]
        lib.ce_pending_count.restype = ctypes.c_int64
        lib.ce_pending_count.argtypes = [ctypes.c_void_p]
        lib.ce_compact.restype = ctypes.c_int
        lib.ce_compact.argtypes = [ctypes.c_void_p]
        lib.ce_crc32c.restype = ctypes.c_uint32
        lib.ce_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.ce_batch_update.restype = ctypes.c_int
        lib.ce_batch_update.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.POINTER(_CUpOp), ctypes.POINTER(_COpResult), ctypes.c_int,
        ]
        lib.ce_batch_commit.restype = ctypes.c_int
        lib.ce_batch_commit.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(_COpResult),
            ctypes.c_int,
        ]
        lib.ce_batch_read.restype = ctypes.c_int
        lib.ce_batch_read.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_CReadOp), ctypes.c_char_p,
            ctypes.c_uint64, ctypes.POINTER(_COpResult), ctypes.c_int,
        ]
        lib.ce_read2.restype = ctypes.c_int
        lib.ce_read2.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ]
        _lib = lib
        return lib


def _check(rc: int, what: str = "") -> int:
    if rc < 0:
        raise _err(_ERR_TO_CODE.get(rc, Code.ENGINE_ERROR), what)
    return rc


def _meta_from_c(m: _CMeta) -> ChunkMeta:
    key = bytes(m.key)
    return ChunkMeta(
        chunk_id=ChunkId.from_bytes(key),
        chain_ver=m.chain_ver,
        committed_ver=m.committed_ver,
        pending_ver=m.pending_ver,
        length=m.length,
        checksum=Checksum(m.crc, m.length),
        pending_length=m.pending_length,
        pending_checksum=Checksum(m.pending_crc, m.pending_length),
        aux=m.aux,
    )


class NativeChunkEngine(ChunkEngine):
    def __init__(self, path: Optional[str] = None, *, fsync_wal: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self._lib = _load_lib()
        self._path = path or tempfile.mkdtemp(prefix="tpu3fs-engine-")
        self._h = self._lib.ce_open(self._path.encode(), int(fsync_wal))
        if not self._h:
            raise _err(Code.ENGINE_ERROR, f"ce_open failed for {self._path}")
        self._scratch_local = threading.local()

    @property
    def path(self) -> str:
        return self._path

    def get_meta(self, chunk_id: ChunkId) -> Optional[ChunkMeta]:
        out = _CMeta()
        rc = self._lib.ce_get_meta(self._h, chunk_id.to_bytes(), ctypes.byref(out))
        if rc == -1:
            return None
        _check(rc, "get_meta")
        return _meta_from_c(out)

    def read(self, chunk_id: ChunkId, offset: int = 0, length: int = -1) -> bytes:
        meta = self.get_meta(chunk_id)
        if meta is None:
            raise _err(Code.CHUNK_NOT_FOUND, str(chunk_id))
        # size from the (possibly stale) meta; the C side clamps to this
        # capacity under its mutex, so a concurrent commit that grows the
        # chunk can shorten the read but never overrun the buffer
        cap = meta.length if length < 0 else min(length, 1 << 27)
        buf = self._scratch(max(cap, 1))
        out_len = ctypes.c_int64()
        rc = self._lib.ce_read(
            self._h, chunk_id.to_bytes(), buf, len(buf), offset, length,
            ctypes.byref(out_len),
        )
        _check(rc, "read")
        return ctypes.string_at(ctypes.addressof(buf), out_len.value)

    def read_verified(
        self, chunk_id: ChunkId, offset: int = 0, length: int = -1
    ) -> tuple:
        meta = self.get_meta(chunk_id)
        if meta is None:
            raise _err(Code.CHUNK_NOT_FOUND, str(chunk_id))
        cap = meta.length if length < 0 else min(length, 1 << 27)
        buf = self._scratch(max(cap, 1))
        out_len = ctypes.c_int64()
        out_ver = ctypes.c_uint64()
        out_crc = ctypes.c_uint32()
        out_aux = ctypes.c_uint32()
        # data + commit_ver + crc read under ONE engine mutex hold: the
        # reply can never pair one version's bytes with another's checksum
        rc = self._lib.ce_read2(
            self._h, chunk_id.to_bytes(), buf, max(cap, 1), offset, length,
            ctypes.byref(out_len), ctypes.byref(out_ver),
            ctypes.byref(out_crc), ctypes.byref(out_aux),
        )
        _check(rc, "read_verified")
        data = ctypes.string_at(ctypes.addressof(buf), out_len.value)
        return data, out_ver.value, out_crc.value, out_aux.value

    def pending_content(self, chunk_id: ChunkId) -> bytes:
        out = _CMeta()
        rc = self._lib.ce_get_meta(self._h, chunk_id.to_bytes(), ctypes.byref(out))
        if rc == -1:
            return b""
        _check(rc, "get_meta")
        cap = max(out.pending_length, out.length, 1)
        buf = self._scratch(cap)
        out_len = ctypes.c_int64()
        rc = self._lib.ce_read_pending(
            self._h, chunk_id.to_bytes(), buf, len(buf), ctypes.byref(out_len)
        )
        _check(rc, "read_pending")
        return ctypes.string_at(ctypes.addressof(buf), out_len.value)

    def update(
        self,
        chunk_id: ChunkId,
        update_ver: int,
        chain_ver: int,
        data: bytes,
        offset: int,
        *,
        full_replace: bool = False,
        stage_replace: bool = False,
        chunk_size: int,
        aux: int = 0,
        expected_crc: Optional[int] = None,
        content_crc=None,  # computed natively during staging; unused here
        adopt: bool = False,  # C owns its block pool; always copies in
    ) -> ChunkMeta:
        mode = 2 if stage_replace else (1 if full_replace else 0)
        rc = self._lib.ce_update(
            self._h, chunk_id.to_bytes(), update_ver, chain_ver,
            bytes(data), len(data), offset, mode, chunk_size,
            aux, int(expected_crc is not None),
            (expected_crc or 0) & 0xFFFFFFFF,
        )
        _check(rc, "update")
        return self.get_meta(chunk_id)

    def commit(self, chunk_id: ChunkId, ver: int, chain_ver: int) -> ChunkMeta:
        rc = self._lib.ce_commit(self._h, chunk_id.to_bytes(), ver, chain_ver)
        _check(rc, "commit")
        return self.get_meta(chunk_id)

    def remove(self, chunk_id: ChunkId) -> bool:
        rc = self._lib.ce_remove(self._h, chunk_id.to_bytes())
        if rc == -1:
            return False
        _check(rc, "remove")
        return True

    def truncate(self, chunk_id: ChunkId, length: int, chain_ver: int) -> ChunkMeta:
        rc = self._lib.ce_truncate(self._h, chunk_id.to_bytes(), length, chain_ver)
        _check(rc, "truncate")
        return self.get_meta(chunk_id)

    def query(self, prefix: bytes) -> List[ChunkMeta]:
        count = int(self._lib.ce_chunk_count(self._h))
        if count == 0:
            return []
        arr = (_CMeta * count)()
        rc = self._lib.ce_query(self._h, prefix, len(prefix), arr, count)
        _check(rc, "query")
        return [_meta_from_c(arr[i]) for i in range(rc)]

    def all_metadata(self) -> List[ChunkMeta]:
        return self.query(b"")

    def pending_metas(self) -> List[ChunkMeta]:
        count = int(self._lib.ce_pending_count(self._h))
        if count == 0:
            return []
        arr = (_CMeta * count)()
        rc = self._lib.ce_query_pending(self._h, arr, count)
        _check(rc, "query_pending")
        return [_meta_from_c(arr[i]) for i in range(rc)]

    def used_size(self) -> int:
        return int(self._lib.ce_used_size(self._h))

    def compact(self) -> None:
        _check(int(self._lib.ce_compact(self._h)), "compact")

    # -- batched ops: ONE ctypes crossing per batch; the loop runs in C++
    # with the GIL released (ctypes drops it for the call duration) ----------
    @staticmethod
    def _payload_addr(data, keepalive) -> int:
        """Raw address of a payload buffer, taken WITHOUT copying where
        the buffer protocol allows: bytes expose their internal pointer
        via c_char_p; writable buffers (the transport's receive-frame
        memoryviews) via from_buffer. Only read-only non-bytes buffers
        (rare) pay a copy. Whatever keeps the address alive is appended
        to `keepalive`, which the caller holds across the C call."""
        if isinstance(data, bytes):
            ref = ctypes.c_char_p(data)  # borrows the bytes' buffer
            keepalive.append((data, ref))
            return ctypes.cast(ref, ctypes.c_void_p).value or 0
        try:
            arr = (ctypes.c_char * len(data)).from_buffer(data)
        except (TypeError, ValueError):
            b = bytes(data)  # copy-ok: read-only non-bytes buffer
            ref = ctypes.c_char_p(b)
            keepalive.append((b, ref))
            return ctypes.cast(ref, ctypes.c_void_p).value or 0
        keepalive.append(arr)
        return ctypes.addressof(arr)

    def batch_update(self, ops, chain_ver: int):
        n = len(ops)
        if n == 0:
            return []
        c_ops = (_CUpOp * n)()
        # iovec mode: data_off carries each payload's ABSOLUTE address and
        # blob is NULL — the engine reads straight from the transport's
        # receive-frame views (or the caller's bytes), no concatenation
        # copy of the batch payloads
        keepalive: list = []
        for i, op in enumerate(ops):
            c = c_ops[i]
            ctypes.memmove(c.key, op.chunk_id.to_bytes(), _KEYLEN)
            c.flags = ((1 if op.full_replace else 0)
                       | (2 if op.expected_crc is not None else 0)
                       | (4 if op.stage_replace else 0))
            c.offset = op.offset
            c.data_len = len(op.data)
            c.chunk_size = op.chunk_size
            c.aux = op.aux
            c.data_off = self._payload_addr(op.data, keepalive) \
                if len(op.data) else ctypes.addressof(_EMPTY_PAYLOAD)
            c.update_ver = op.update_ver
            c.expected_crc = (op.expected_crc or 0) & 0xFFFFFFFF
        res = (_COpResult * n)()
        _check(self._lib.ce_batch_update(
            self._h, chain_ver, None, c_ops, res, n), "batch_update")
        del keepalive
        out = []
        for i in range(n):
            r = res[i]
            code = Code.OK if r.rc == 0 else _ERR_TO_CODE.get(
                r.rc, Code.ENGINE_ERROR)
            out.append(EngineOpResult(code, r.ver, r.len, r.crc))
        return out

    def batch_commit(self, items, chain_ver: int):
        n = len(items)
        if n == 0:
            return []
        keys = b"".join(cid.to_bytes() for cid, _ in items)
        vers = (ctypes.c_uint64 * n)(*[v for _, v in items])
        res = (_COpResult * n)()
        _check(self._lib.ce_batch_commit(
            self._h, chain_ver, keys, vers, res, n), "batch_commit")
        out = []
        for i in range(n):
            r = res[i]
            code = Code.OK if r.rc == 0 else _ERR_TO_CODE.get(
                r.rc, Code.ENGINE_ERROR)
            out.append(EngineOpResult(code, r.ver, r.len, r.crc))
        return out

    def _scratch(self, size: int) -> ctypes.Array:
        """Grow-only per-thread scratch for batch reads: avoids the per-call
        zeroing/page-fault cost of a fresh buffer (the BufferPool role,
        ref src/storage/service/BufferPool.cc)."""
        loc = self._scratch_local
        buf = getattr(loc, "buf", None)
        if buf is None or len(buf) < size:
            buf = ctypes.create_string_buffer(max(size, 1 << 20))
            loc.buf = buf
        return buf

    def batch_read(self, items, cap: int):
        n = len(items)
        if n == 0:
            return []
        c_ops = (_CReadOp * n)()
        total = 0
        offs = []
        for i, (chunk_id, offset, length) in enumerate(items):
            c = c_ops[i]
            ctypes.memmove(c.key, chunk_id.to_bytes(), _KEYLEN)
            c.out_off = total
            c.offset = offset
            c.length = length
            c.slot_len = cap if length < 0 else min(length, cap)
            offs.append(total)
            total += c.slot_len
        buf = self._scratch(total)
        res = (_COpResult * n)()
        _check(self._lib.ce_batch_read(
            self._h, c_ops, buf, len(buf), res, n), "batch_read")
        # Pass 1: copy every rc==0 payload OUT of the shared scratch buffer
        # before any fallback re-read runs — read_verified reuses the same
        # per-thread scratch, so an interleaved E_RANGE re-read would
        # overwrite sibling replies still sitting in `buf` in place.
        # memoryview slicing + .tobytes() beats ctypes.string_at and skips
        # per-op ctypes-struct attribute reads. NOTE the remaining ceiling
        # is MEMORY BANDWIDTH, not API overhead: each payload byte moves
        # mmap->scratch (C) then scratch->bytes (here), ~4x traffic with
        # the write-allocates; on this class of host that bounds batched
        # reads near 1 GiB/s while the mem engine hands out REFERENCES at
        # apparent 17+ GiB/s. Zero-copy views over the per-thread scratch
        # would alias the next batch (the E_RANGE corruption class) —
        # rejected deliberately; real deployments are NVMe-bound anyway.
        mv = memoryview(buf)
        out = []
        refetch = []
        for i in range(n):
            r = res[i]
            if r.rc == -10:
                refetch.append(i)
                out.append(None)
            elif r.rc != 0:
                out.append((_ERR_TO_CODE.get(r.rc, Code.ENGINE_ERROR),
                            b"", 0, 0, 0))
            else:
                off = offs[i]
                data = mv[off:off + r.len].tobytes()
                out.append((Code.OK, data, r.ver, r.crc, r.aux))
        # Pass 2: committed content outgrew the per-op cap — re-read those
        # ops alone with an exact-size buffer (matches mem engine and the
        # per-op path byte-for-byte). Safe now: scratch holds no live data.
        for i in refetch:
            try:
                chunk_id, offset, length = items[i]
                out[i] = (Code.OK,) + self.read_verified(
                    chunk_id, offset, length)
            except FsError as e:
                out[i] = (e.code, b"", 0, 0, 0)
        return out

    def batch_read_views(self, items, cap: int):
        """Zero-copy variant for the served read path: one C crossing into
        a FRESH per-call buffer (not the reused per-thread scratch — views
        over scratch would alias the next batch), data handed out as
        memoryviews over it. The buffer's ownership passes to the views;
        GC reclaims it when the reply is dropped. Costs exactly one copy
        (engine mmap -> buffer); the transport writev's the views straight
        to the socket, so the scratch->bytes copy of batch_read is gone.
        """
        n = len(items)
        if n == 0:
            return []
        c_ops = (_CReadOp * n)()
        total = 0
        offs = []
        for i, (chunk_id, offset, length) in enumerate(items):
            c = c_ops[i]
            ctypes.memmove(c.key, chunk_id.to_bytes(), _KEYLEN)
            c.out_off = total
            c.offset = offset
            c.length = length
            c.slot_len = cap if length < 0 else min(length, cap)
            offs.append(total)
            total += c.slot_len
        buf = bytearray(total or 1)
        cbuf = (ctypes.c_char * len(buf)).from_buffer(buf)
        res = (_COpResult * n)()
        _check(self._lib.ce_batch_read(
            self._h, c_ops, cbuf, len(buf), res, n), "batch_read")
        del cbuf  # release the exported-buffer hold before views escape
        mv = memoryview(buf)
        out = []
        for i in range(n):
            r = res[i]
            if r.rc == -10:
                # committed content outgrew the per-op cap: exact re-read
                # (bytes, not a view — correctness over zero-copy here)
                try:
                    chunk_id, offset, length = items[i]
                    out.append((Code.OK,) + self.read_verified(
                        chunk_id, offset, length))
                except FsError as e:
                    out.append((e.code, b"", 0, 0, 0))
            elif r.rc != 0:
                out.append((_ERR_TO_CODE.get(r.rc, Code.ENGINE_ERROR),
                            b"", 0, 0, 0))
            else:
                off = offs[i]
                out.append((Code.OK, mv[off:off + r.len], r.ver, r.crc,
                            r.aux))
        return out

    def close(self) -> None:
        if self._h:
            self._lib.ce_close(self._h)
            self._h = None


# statfs f_type of the filesystems an engine maps instead of reading
FS_TYPES = {0x01021994: "tmpfs", 0x858458F6: "ramfs", 0xEF53: "ext4",
            0x58465342: "xfs", 0x794C7630: "overlayfs", 0x9123683E: "btrfs"}
_MAPPED_FS = (0x01021994, 0x858458F6)
_SYS_IO_URING_SETUP = 425  # x86_64 and aarch64 alike


def fs_type(path: str) -> int:
    """``statfs(path).f_type`` (Python's ``os.statvfs`` has no type)."""
    libc = ctypes.CDLL(None, use_errno=True)
    buf = ctypes.create_string_buffer(256)  # struct statfs is 120 bytes
    if libc.statfs(str(path).encode(), buf) != 0:
        err = ctypes.get_errno()
        raise OSError(err, f"statfs({path})")
    return ctypes.c_long.from_buffer(buf).value  # f_type leads the struct


def read_path(path: str) -> str:
    """The read path an engine on ``path`` takes, decided as ``ce_open``
    and its first batch read decide it: ``mmap`` on tmpfs or ramfs (or
    with ``TPU3FS_MMAP=1``), else ``pread`` when ``TPU3FS_NO_URING`` is
    set or this process may not set up an io_uring, else ``io_uring``."""
    forced = os.environ.get("TPU3FS_MMAP")
    mapped = (forced[:1] == "1") if forced is not None \
        else fs_type(path) in _MAPPED_FS
    if mapped:
        return "mmap"
    if os.environ.get("TPU3FS_NO_URING") is not None:
        return "pread"
    libc = ctypes.CDLL(None, use_errno=True)
    libc.syscall.restype = ctypes.c_long
    params = ctypes.create_string_buffer(120)  # struct io_uring_params
    fd = libc.syscall(ctypes.c_long(_SYS_IO_URING_SETUP), ctypes.c_uint(8),
                      params)
    if fd < 0:
        return "pread"
    os.close(fd)
    return "io_uring"
