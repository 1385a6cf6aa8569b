"""Chunk engines: the per-target local store with COW updates + atomic commit.

The port's own copy of ``tpu3fs/storage/engine.py``. An engine holds a
``device``: every chunk checksum runs there (``Checksum.of``/``of_many``,
kernel K2 on the card), and the batched stage's pooled checksums are one
``crc32c_many`` call. The C++ engine on disk is ``native_engine``.

Port of the *semantics* of the reference's Rust chunk engine
(src/storage/chunk_engine/src/core/engine.rs:31-685): a chunk has a committed
version and at most one pending version (u = v+1); updates are copy-on-write
against the committed content; commit atomically promotes the pending version;
a full-chunk-replace write abandons any pending state and installs new
committed content directly (the recovery path, design_notes "Data recovery").

Engines are swappable behind StorageTarget (like the reference's
only_chunk_engine switch, src/storage/store/StorageTarget.h:85-162):
  - MemChunkEngine: dict-backed, for tests and the single-process fabric.
  - NativeChunkEngine (tpu3fs_torch.storage.native_engine): C++
    group-allocator store via ctypes.
"""

from __future__ import annotations

import abc
import os
import sys
import threading
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpu3fs_torch.device import resolve_device
from tpu3fs_torch.storage.types import Checksum, ChunkId, ChunkMeta
from tpu3fs_torch.utils.result import Code, FsError
from tpu3fs_torch.utils.result import err as _err


def _owned_bytes(data) -> bytes:
    """Own an incoming payload as immutable bytes with ONE memcpy.

    The write hot path hands the engine memoryviews over the bulk
    receive frame (or the client's user buffer on the fabric);
    ``memoryview.tobytes()`` is a straight contiguous memcpy, measurably
    ~2x ``bytes(mv)`` (which walks the buffer per-segment) at 1 MiB
    chunks. ``bytes`` input passes through without a copy.
    """
    return data.tobytes() if isinstance(data, memoryview) else bytes(data)


@dataclass
class EngineUpdateOp:
    """One op of a batched stage (the UpdateJob payload of UpdateWorker.h:44)."""

    chunk_id: ChunkId
    data: bytes
    offset: int = 0
    update_ver: int = 0          # 0 = assign committed+1
    full_replace: bool = False
    stage_replace: bool = False  # EC two-phase stage (pending only)
    chunk_size: int = 0
    aux: int = 0                 # opaque tag stored with the staged content
    expected_crc: Optional[int] = None  # validated install (EC shard path)
    # content CRC an in-process predecessor already computed over this
    # very buffer (trusted forward) — skips the staging recompute
    content_crc: Optional[Checksum] = None
    # the buffer is the predecessor replica's OWN immutable content
    # (in-process chain forward): install it by reference, no copy
    adopt: bool = False


@dataclass
class EngineOpResult:
    """Outcome of one batched op: staged/committed version + block crc/len."""

    code: Code
    ver: int = 0
    length: int = 0
    crc: int = 0

    @property
    def ok(self) -> bool:
        return self.code == Code.OK

    @property
    def checksum(self) -> Checksum:
        return Checksum(self.crc, self.length)


class ChunkEngine(abc.ABC):
    """Engine interface (semantics of chunk_engine's public API). An
    engine's ``device`` is where its chunk checksums run."""

    device = None

    @abc.abstractmethod
    def get_meta(self, chunk_id: ChunkId) -> Optional[ChunkMeta]: ...

    @abc.abstractmethod
    def read(self, chunk_id: ChunkId, offset: int = 0, length: int = -1) -> bytes:
        """Read committed content. Raises CHUNK_NOT_FOUND / CHUNK_NOT_COMMIT."""

    @abc.abstractmethod
    def read_verified(
        self, chunk_id: ChunkId, offset: int = 0, length: int = -1
    ) -> tuple:
        """-> (data, commit_ver, crc, aux), mutually consistent: all are
        taken under one engine lock hold, so a concurrent commit can never
        pair one version's bytes with another version's checksum."""

    @abc.abstractmethod
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
        content_crc: Optional[Checksum] = None,
        adopt: bool = False,
    ) -> ChunkMeta:
        """Stage pending version `update_ver` (COW write of [offset,
        offset+len)); `aux` is an opaque tag promoted with the content at
        commit (EC stripes store the logical pre-padding length there).
        expected_crc (when given) makes the install VALIDATED: the engine
        compares its own content CRC (computed during staging anyway) and
        refuses with CHUNK_CHECKSUM_MISMATCH before mutating anything —
        the one-pass verified write the EC shard path uses.

        Modes: full_replace installs data as COMMITTED at update_ver in
        one step (recovery writes — design_notes "Data recovery" step 2).
        stage_replace stages data as the full PENDING content at
        update_ver, allowing version gaps and replacing any older pending
        — phase one of the EC two-phase stripe write; the committed
        version is untouched until commit() promotes it, so a failed
        overwrite can never destroy the last readable stripe version.

        content_crc (when given) is the caller-precomputed Checksum OF
        `data` (the batched staging path computes them all in one pooled
        native crossing); engines may use it wherever the staged content
        is exactly `data`, and must ignore it otherwise (merged COW
        content)."""

    @abc.abstractmethod
    def commit(self, chunk_id: ChunkId, ver: int, chain_ver: int) -> ChunkMeta:
        """Atomically promote pending `ver` to committed."""

    @abc.abstractmethod
    def remove(self, chunk_id: ChunkId) -> bool: ...

    @abc.abstractmethod
    def truncate(self, chunk_id: ChunkId, length: int, chain_ver: int) -> ChunkMeta: ...

    @abc.abstractmethod
    def query(self, prefix: bytes) -> List[ChunkMeta]:
        """All chunk metas whose id bytes start with prefix, ordered."""

    @abc.abstractmethod
    def all_metadata(self) -> List[ChunkMeta]: ...

    def pending_metas(self) -> List[ChunkMeta]:
        """Metas with a staged (uncommitted) pending version. Engines that
        can afford it keep an index so this is O(pendings), not O(chunks)
        — it is the steady-state probe of the healthy-chain EC repair
        sweep, called once per resync interval per target."""
        return [m for m in self.all_metadata() if m.pending_ver > 0]

    @abc.abstractmethod
    def used_size(self) -> int: ...

    @abc.abstractmethod
    def pending_content(self, chunk_id: ChunkId) -> bytes:
        """Full content of the staged pending version (committed if none;
        b"" if the chunk is unknown). Feeds the chain checksum cross-check."""

    def close(self) -> None:  # pragma: no cover - engines may override
        pass

    # -- batched ops (default: per-op loop; NativeChunkEngine overrides with
    # one C-ABI crossing per batch, running the loop outside the GIL — the
    # role of the reference's per-disk UpdateWorker queues) -------------------
    def batch_update(
        self, ops: List[EngineUpdateOp], chain_ver: int
    ) -> List[EngineOpResult]:
        # one K2 launch checksums every whole-content payload up front
        # (per-op scalar CRC was the dominant term of the batched write
        # pipeline); ops that merge into existing content checksum
        # inline as before. expected_crc ops skip precompute: validation
        # recomputes (and reuses) the checksum anyway.
        pre: List[Optional[Checksum]] = [op.content_crc for op in ops]
        whole = [i for i, op in enumerate(ops)
                 if op.offset == 0 and op.expected_crc is None and op.data
                 and pre[i] is None]
        if len(whole) > 1:
            for i, cs in zip(whole,
                             Checksum.of_many([ops[i].data for i in whole],
                                              self.device)):
                pre[i] = cs
        out: List[EngineOpResult] = []
        for op, content_crc in zip(ops, pre):
            try:
                ver = op.update_ver
                if ver == 0:
                    m = self.get_meta(op.chunk_id)
                    ver = (m.committed_ver if m else 0) + 1
                meta = self.update(
                    op.chunk_id, ver, chain_ver, op.data, op.offset,
                    full_replace=op.full_replace,
                    stage_replace=op.stage_replace,
                    chunk_size=op.chunk_size,
                    aux=op.aux, expected_crc=op.expected_crc,
                    content_crc=content_crc, adopt=op.adopt,
                )
                if op.full_replace:
                    out.append(EngineOpResult(
                        Code.OK, ver, meta.length, meta.checksum.value))
                else:
                    out.append(EngineOpResult(
                        Code.OK, ver, meta.pending_length,
                        meta.pending_checksum.value))
            except FsError as e:
                if e.code == Code.CHUNK_STALE_UPDATE:
                    cur = self.get_meta(op.chunk_id)
                    out.append(EngineOpResult(
                        Code.CHUNK_STALE_UPDATE,
                        cur.committed_ver if cur else 0,
                        cur.length if cur else 0,
                        cur.checksum.value if cur else 0,
                    ))
                else:
                    out.append(EngineOpResult(e.code))
        return out

    def batch_commit(
        self, items: List[Tuple[ChunkId, int]], chain_ver: int
    ) -> List[EngineOpResult]:
        out: List[EngineOpResult] = []
        for chunk_id, ver in items:
            try:
                meta = self.commit(chunk_id, ver, chain_ver)
                out.append(EngineOpResult(
                    Code.OK, meta.committed_ver, meta.length,
                    meta.checksum.value))
            except FsError as e:
                out.append(EngineOpResult(e.code))
        return out

    def batch_read(
        self, items: List[Tuple[ChunkId, int, int]], cap: int
    ) -> List[Tuple[Code, bytes, int, int]]:
        """items: (chunk_id, offset, length); cap: per-op buffer bound
        (the target chunk size). -> (code, data, commit_ver, crc, aux)."""
        out = []
        for chunk_id, offset, length in items:
            try:
                data, ver, crc, aux = self.read_verified(
                    chunk_id, offset, length)
                out.append((Code.OK, data, ver, crc, aux))
            except FsError as e:
                out.append((e.code, b"", 0, 0, 0))
        return out

    def batch_read_views(
        self, items: List[Tuple[ChunkId, int, int]], cap: int
    ) -> List[Tuple[Code, object, int, int, int]]:
        """batch_read whose data entries may be OWNED buffer views
        (memoryview/bytes) instead of fresh bytes — the zero-copy read
        path: the RPC reply gathers these straight into the socket without
        a serde-payload copy. The buffers must stay valid for as long as
        the caller holds the views (engines return views only over
        immutable or per-call-owned memory, NEVER over reused scratch).
        Default: plain batch_read (bytes are views of themselves)."""
        return self.batch_read(items, cap)


@dataclass
class _Slot:
    meta: ChunkMeta
    # committed/pending content: immutable bytes OR a read-only arena
    # view — every consumer goes through memoryview()/len()/slicing,
    # which both support
    committed: object = b""
    pending: Optional[object] = None
    aux_pending: int = 0


class _Arena:
    """Warm content arena for MemChunkEngine installs — the role of the
    native engine's preallocated physical block pools, in Python.

    Fresh heap memory on this class of host takes first-touch page steals
    on every install (measured ~1.5 GiB/s vs ~4.8 GiB/s into long-lived
    buffers), and glibc returns freed MiB-sized blocks to the OS so the
    penalty recurs forever. The arena keeps LONG-LIVED numpy extents and
    bump-allocates content slices out of them:

    - an install memcpys into warm extent memory and stores a READ-ONLY
      memoryview of the slice (content immutability is preserved —
      nothing can write through the stored view);
    - an extent is recycled only when NOTHING references it anymore —
      live content views (including zero-copy read replies and buffers
      adopted by a successor replica) hold buffer exports on the extent,
      so ``sys.getrefcount`` gates reuse exactly;
    - ``prefault_bytes`` touches extents once at construction so the
      first install burst (e.g. a checkpoint save right after bringup)
      does not pay the first-touch cost either; set via
      TPU3FS_MEM_PREALLOC_MB (benchmarks/daemons — tests default to 0).

    The trade: one live content slice pins its whole extent. For the mem
    engine's workloads (serving + simulation) that bounded slack is
    cheaper than re-faulting every write.

    Extents are drawn from (and on close returned to) a PROCESS-GLOBAL
    warm pool shared by every engine instance: a closed fabric's extents
    re-warm the next one instead of going back to the OS cold, and total
    arena RSS stays bounded by the pool cap."""

    _EXTENT_BYTES = 8 << 20
    _pool: List = []          # process-global warm extents
    _pool_lock = threading.Lock()
    _pool_prefaulted = False
    # process-wide arena accounting for the memory-observability gauges
    # (mem.arena_* via monitor/memory.py): extents ever materialized and
    # extent draws satisfied by recycling instead of fresh allocation
    _created_extents = 0
    _recycled_extents = 0

    @classmethod
    def _pool_cap_bytes(cls) -> int:
        return int(os.environ.get("TPU3FS_MEM_PREALLOC_MB", "0")) << 20

    @classmethod
    def _prefault_pool(cls, prefault_bytes: int) -> None:
        """Touch the warm pool into existence ONCE per process (engine
        preallocation happens at bringup, never inside a timed install)."""
        with cls._pool_lock:
            if cls._pool_prefaulted:
                return
            cls._pool_prefaulted = True
            for _ in range(max(0, prefault_bytes) // cls._EXTENT_BYTES):
                ext = np.empty(cls._EXTENT_BYTES, dtype=np.uint8)
                ext[:] = 0  # touch every page now
                cls._pool.append(ext)

    def __init__(self, prefault_bytes: int = 0):
        self._extent_bytes = self._EXTENT_BYTES
        self._retired: List = []  # fully-bumped extents (maybe pinned)
        self._cur = None
        self._off = 0
        if prefault_bytes:
            self._prefault_pool(prefault_bytes)

    def _next_extent(self):
        cls = type(self)
        with self._pool_lock:
            pool = cls._pool
            for i in range(len(pool)):
                # list slot + getrefcount argument == 2: no content view
                # (buffer export) pins this extent anymore. NOTE: indexed
                # access on purpose — a `for ... in enumerate(...)` loop
                # binding holds a third reference and defeats the gate.
                if sys.getrefcount(pool[i]) == 2:
                    cls._recycled_extents += 1
                    return pool.pop(i)
        for i in range(len(self._retired)):
            if sys.getrefcount(self._retired[i]) == 2:
                with self._pool_lock:
                    cls._recycled_extents += 1
                return self._retired.pop(i)
        with self._pool_lock:
            cls._created_extents += 1
        return np.empty(self._extent_bytes, dtype=np.uint8)

    def close(self) -> None:
        """Hand this arena's extents back to the process-global warm pool
        (up to the cap) — the next engine starts warm instead of paying
        first-touch again. Pinned extents are handed back too: the draw
        path refcount-gates them, so they become usable the moment their
        last content view dies."""
        exts = self._retired
        self._retired = []
        if self._cur is not None:
            exts.append(self._cur)
            self._cur = None
        with self._pool_lock:
            budget = self._pool_cap_bytes() - len(
                type(self)._pool) * self._extent_bytes
            for ext in exts:
                if budget < self._extent_bytes:
                    break
                type(self)._pool.append(ext)
                budget -= self._extent_bytes

    @classmethod
    def stats(cls) -> dict:
        """Process-wide arena accounting for the mem.arena_* gauges:
        resident = extents ever materialized (they live in arenas or the
        warm pool until their last content view dies), recycled =
        cumulative draws served warm instead of via fresh allocation."""
        with cls._pool_lock:
            return {
                "resident_bytes": cls._created_extents * cls._EXTENT_BYTES,
                "recycled_bytes": cls._recycled_extents * cls._EXTENT_BYTES,
                "pool_extents": len(cls._pool),
            }

    def alloc(self, n: int) -> Optional[memoryview]:
        """A writable n-byte view of warm arena memory, or None when n
        doesn't fit an extent (caller falls back to a plain bytes copy)."""
        if n == 0 or n > self._extent_bytes:
            return None
        if self._cur is None or self._off + n > self._extent_bytes:
            if self._cur is not None:
                self._retired.append(self._cur)
            self._cur = self._next_extent()
            self._off = 0
        off = self._off
        self._off = off + n
        return memoryview(self._cur)[off:off + n]


def arena_stats() -> dict:
    """Public accessor for the content-arena gauges (monitor/memory.py)."""
    return _Arena.stats()


class MemChunkEngine(ChunkEngine):
    """In-memory engine with exact version/commit semantics."""

    def __init__(self, prealloc_bytes: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        self._chunks: Dict[bytes, _Slot] = {}
        self._lock = threading.RLock()
        # chunk keys with a staged pending version: keeps pending_metas()
        # O(pendings) — the healthy-chain repair probe must not scan the
        # whole index at steady state
        self._pending_keys: set = set()
        if prealloc_bytes is None:
            prealloc_bytes = int(os.environ.get(
                "TPU3FS_MEM_PREALLOC_MB", "0")) << 20
        self._arena = _Arena(prefault_bytes=prealloc_bytes)

    def close(self) -> None:
        # return arena extents to the process-global warm pool
        self._arena.close()

    def _own_content(self, data) -> object:
        """Own `data` as immutable content with ONE memcpy into warm
        arena memory (read-only view); falls back to a bytes copy for
        oversized or non-contiguous payloads."""
        if isinstance(data, memoryview) and not data.contiguous:
            return _owned_bytes(data)
        buf = self._arena.alloc(len(data))
        if buf is None:
            return _owned_bytes(data)
        np.copyto(np.frombuffer(buf, dtype=np.uint8),
                  np.frombuffer(data, dtype=np.uint8))
        return buf.toreadonly()

    # -- helpers -----------------------------------------------------------
    def _slot(self, chunk_id: ChunkId) -> Optional[_Slot]:
        return self._chunks.get(chunk_id.to_bytes())

    # -- reads -------------------------------------------------------------
    def get_meta(self, chunk_id: ChunkId) -> Optional[ChunkMeta]:
        with self._lock:
            slot = self._slot(chunk_id)
            return replace(slot.meta) if slot else None

    def read(self, chunk_id: ChunkId, offset: int = 0, length: int = -1) -> bytes:
        with self._lock:
            slot = self._slot(chunk_id)
            if slot is None:
                raise _err(Code.CHUNK_NOT_FOUND, str(chunk_id))
            if slot.meta.committed_ver == 0:
                # only a pending write exists; reader must retry after commit
                # (ref ChunkReplica.cc:62-67 kChunkNotCommit)
                raise _err(Code.CHUNK_NOT_COMMIT, str(chunk_id))
            # read() keeps the OWNED-BYTES contract (arena content is a
            # memoryview — materialize, same one copy a bytes slice always
            # was); the zero-copy serving path is batch_read_views
            mv = memoryview(slot.committed)
            return bytes(mv[offset:] if length < 0
                         else mv[offset : offset + length])

    def read_verified(
        self, chunk_id: ChunkId, offset: int = 0, length: int = -1
    ) -> tuple:
        with self._lock:
            data = self.read(chunk_id, offset, length)
            meta = self._slot(chunk_id).meta
            if offset == 0 and len(data) == meta.length:
                crc = meta.checksum.value       # checksum reuse
            else:
                crc = Checksum.of(data, self.device).value
            return data, meta.committed_ver, crc, meta.aux

    def batch_read_views(self, items, cap: int):
        """Zero-copy batch read: data entries are memoryviews over the
        slots' committed bytes. Safe because committed content is
        IMMUTABLE — an overwrite installs a NEW bytes object (the old one
        stays alive as long as any view does), it never mutates in place.
        """
        out = []
        with self._lock:
            for chunk_id, offset, length in items:
                slot = self._slot(chunk_id)
                if slot is None:
                    out.append((Code.CHUNK_NOT_FOUND, b"", 0, 0, 0))
                    continue
                meta = slot.meta
                if meta.committed_ver == 0:
                    out.append((Code.CHUNK_NOT_COMMIT, b"", 0, 0, 0))
                    continue
                mv = memoryview(slot.committed)
                data = mv[offset:] if length < 0 \
                    else mv[offset:offset + length]
                if offset == 0 and len(data) == meta.length:
                    crc = meta.checksum.value   # checksum reuse
                else:
                    crc = Checksum.of(data, self.device).value
                out.append((Code.OK, data, meta.committed_ver, crc,
                            meta.aux))
        return out

    # -- updates (COW + version algebra) -------------------------------------
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
        content_crc: Optional[Checksum] = None,
        adopt: bool = False,
    ) -> ChunkMeta:
        if offset + len(data) > chunk_size:
            raise _err(Code.INVALID_ARG, "write exceeds chunk size")
        if offset != 0:
            content_crc = None  # staged content can never be exactly data
        if adopt and isinstance(data, memoryview) and not data.readonly:
            adopt = False  # only immutable buffers install by reference
        assert not (full_replace and stage_replace)
        with self._lock:
            key = chunk_id.to_bytes()
            slot = self._chunks.get(key)
            # validate BEFORE inserting, so a rejected update leaves no
            # phantom committed_ver=0 chunk behind (which would turn
            # CHUNK_NOT_FOUND holes into spurious CHUNK_NOT_COMMIT retries)
            if stage_replace:
                # EC stage: any version newer than committed may stage,
                # replacing an OLDER pending (stripe versions can jump) —
                # but never a NEWER one: clobbering a fully-staged newer
                # version could strand its partial commit with no
                # completable quorum
                cv = slot.meta.committed_ver if slot else 0
                pv = slot.meta.pending_ver if slot else 0
                if update_ver <= cv:
                    raise _err(
                        Code.CHUNK_STALE_UPDATE,
                        f"stage {update_ver} <= committed {cv}",
                    )
                if pv and update_ver < pv:
                    raise _err(
                        Code.CHUNK_ADVANCE_UPDATE,
                        f"stage {update_ver} < pending {pv}",
                    )
            if not full_replace and not stage_replace:
                cv = slot.meta.committed_ver if slot else 0
                pv = slot.meta.pending_ver if slot else 0
                if update_ver <= cv:
                    raise _err(
                        Code.CHUNK_STALE_UPDATE,
                        f"update {update_ver} <= committed {cv}",
                    )
                if pv and pv != update_ver:
                    # a retry racing past a staged pending update
                    raise _err(
                        Code.CHUNK_ADVANCE_UPDATE,
                        f"pending {pv} != update {update_ver}",
                    )
                if update_ver > cv + 1:
                    raise _err(
                        Code.CHUNK_MISSING_UPDATE,
                        f"update {update_ver} > committed {cv}+1",
                    )
            checked: Optional[Checksum] = None
            if expected_crc is not None:
                if (full_replace or stage_replace or slot is None
                        or not slot.committed):
                    content = data if (offset == 0 and isinstance(
                        data, bytes)) else (
                        b"\x00" * offset + bytes(data))
                else:
                    merged = bytearray(slot.committed)
                    if offset + len(data) > len(merged):
                        merged.extend(
                            b"\x00" * (offset + len(data) - len(merged)))
                    merged[offset:offset + len(data)] = data
                    content = bytes(merged)
                checked = Checksum.of(content, self.device)
                if checked.value != (expected_crc & 0xFFFFFFFF):
                    raise _err(
                        Code.CHUNK_CHECKSUM_MISMATCH,
                        "validated install: content crc mismatch")
            if slot is None:
                slot = _Slot(ChunkMeta(chunk_id, chain_ver))
                self._chunks[key] = slot
            meta = slot.meta
            if full_replace:
                # recovery write: abandon pending, install as committed
                # directly (design_notes "Data recovery" step 2)
                slot.committed = data if adopt else self._own_content(data)
                slot.pending = None
                self._pending_keys.discard(key)
                meta.committed_ver = update_ver
                meta.pending_ver = 0
                meta.chain_ver = chain_ver
                meta.length = len(data)
                # reuse the validation checksum when offset==0 covered it
                # (or the caller's precomputed content CRC)
                meta.checksum = (
                    checked if checked is not None and offset == 0
                    else content_crc if content_crc is not None
                    else Checksum.of(slot.committed, self.device))
                meta.pending_length = 0
                meta.pending_checksum = Checksum()
                meta.aux = aux
                slot.aux_pending = 0
                return replace(meta)
            if stage_replace:
                slot.pending = data if adopt else self._own_content(data)
                self._pending_keys.add(key)
                meta.pending_ver = update_ver
                meta.chain_ver = chain_ver
                meta.pending_length = len(slot.pending)
                meta.pending_checksum = (
                    checked if checked is not None
                    else content_crc if content_crc is not None
                    else Checksum.of(slot.pending, self.device))
                slot.aux_pending = aux
                return replace(meta)
            # COW: base is committed content (re-applying the same pending
            # update is idempotent)
            if offset == 0 and len(data) >= len(slot.committed):
                # whole-content write (the common chunk-append/overwrite
                # form): one copy, no bytearray round trip — or ZERO
                # copies when adopting a predecessor's owned buffer
                slot.pending = data if adopt else self._own_content(data)
            else:
                base = bytearray(slot.committed)
                if offset + len(data) > len(base):
                    base.extend(b"\x00" * (offset + len(data) - len(base)))
                base[offset : offset + len(data)] = data
                slot.pending = self._own_content(base)
                content_crc = None  # merged content != data
            self._pending_keys.add(key)
            meta.pending_ver = update_ver
            meta.chain_ver = chain_ver
            meta.pending_length = len(slot.pending)
            meta.pending_checksum = (
                content_crc if content_crc is not None
                else Checksum.of(slot.pending, self.device))
            slot.aux_pending = aux
            return replace(meta)

    def content_for_ver(self, chunk_id: ChunkId, ver: int):
        """The engine's OWNED immutable bytes for version ``ver`` (staged
        pending or already committed), or None. In-process chain forwards
        hand this buffer to the successor so both replicas share ONE
        immutable bytes object instead of re-copying the payload; safe
        because installed content is never mutated in place (overwrites
        install fresh objects)."""
        with self._lock:
            slot = self._slot(chunk_id)
            if slot is None:
                return None
            meta = slot.meta
            if meta.pending_ver == ver and slot.pending is not None:
                return slot.pending
            if meta.committed_ver == ver:
                return slot.committed
            return None

    def commit(self, chunk_id: ChunkId, ver: int, chain_ver: int) -> ChunkMeta:
        with self._lock:
            slot = self._slot(chunk_id)
            if slot is None:
                raise _err(Code.CHUNK_NOT_FOUND, str(chunk_id))
            meta = slot.meta
            if meta.committed_ver >= ver:
                # duplicate commit: fine (ref COMMITTED update code)
                return replace(meta)
            if meta.pending_ver != ver or slot.pending is None:
                raise _err(
                    Code.CHUNK_MISSING_UPDATE,
                    f"no pending {ver} (pending={meta.pending_ver})",
                )
            slot.committed = slot.pending
            slot.pending = None
            self._pending_keys.discard(chunk_id.to_bytes())
            meta.committed_ver = ver
            meta.pending_ver = 0
            meta.chain_ver = chain_ver
            meta.length = len(slot.committed)
            # the pending checksum covers exactly the content being promoted
            meta.checksum = meta.pending_checksum
            meta.pending_length = 0
            meta.pending_checksum = Checksum()
            meta.aux = slot.aux_pending
            slot.aux_pending = 0
            return replace(meta)

    # -- maintenance ---------------------------------------------------------
    def remove(self, chunk_id: ChunkId) -> bool:
        with self._lock:
            self._pending_keys.discard(chunk_id.to_bytes())
            return self._chunks.pop(chunk_id.to_bytes(), None) is not None

    def truncate(self, chunk_id: ChunkId, length: int, chain_ver: int) -> ChunkMeta:
        with self._lock:
            slot = self._slot(chunk_id)
            if slot is None:
                raise _err(Code.CHUNK_NOT_FOUND, str(chunk_id))
            slot.committed = bytes(
                memoryview(slot.committed)[:length]).ljust(length, b"\x00")
            meta = slot.meta
            meta.length = length
            meta.chain_ver = chain_ver
            meta.committed_ver += 1
            meta.pending_ver = 0
            slot.pending = None
            self._pending_keys.discard(chunk_id.to_bytes())
            meta.checksum = Checksum.of(slot.committed, self.device)
            meta.pending_length = 0
            meta.pending_checksum = Checksum()
            meta.aux = 0
            slot.aux_pending = 0
            return replace(meta)

    def query(self, prefix: bytes) -> List[ChunkMeta]:
        with self._lock:
            keys = sorted(k for k in self._chunks if k.startswith(prefix))
            return [replace(self._chunks[k].meta) for k in keys]

    def all_metadata(self) -> List[ChunkMeta]:
        return self.query(b"")

    def pending_metas(self) -> List[ChunkMeta]:
        with self._lock:
            return [replace(self._chunks[k].meta)
                    for k in sorted(self._pending_keys)
                    if k in self._chunks]

    def used_size(self) -> int:
        with self._lock:
            return sum(len(s.committed) for s in self._chunks.values())

    def pending_content(self, chunk_id: ChunkId) -> bytes:
        with self._lock:
            slot = self._slot(chunk_id)
            if slot is None:
                return b""
            return slot.pending if slot.pending is not None else slot.committed
