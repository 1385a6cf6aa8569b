"""Sharded checkpoint save: per-host shard writes, async commit, KV lock.

Each host writes only the shards it holds an addressable replica-0 copy
of (one writer per DISTINCT shard, chosen deterministically by replica
id — the mesh-position dedupe the tentpole spec asks for), through the
striped ``FileIoClient`` write path, so the batch fan-out amortizes the
chunk round trips exactly like the training data loaders.

Commit is the manifest module's atomic-rename protocol: data files +
``MANIFEST`` land under ``<root>/<step>.tmp/`` and one meta ``rename``
publishes the step. ``save_async`` snapshots device arrays to host
memory (the only device-blocking part) and hands the file IO + commit to
a background worker, so the training step resumes immediately; the
returned handle's ``wait()`` is the commit barrier.

Double-save protection: a per-root save session record in the KV
(create-exclusive inside one transaction, ``with_transaction``) — two
concurrent saves to one root cannot interleave their ``.tmp`` writes or
commit each other's half-written steps; a crashed saver's session
expires after ``session_ttl_s``.

All IO runs under the ``ckpt`` QoS traffic class: background-weighted in
the stride scheduler, and self-throttling — an ``OVERLOADED`` shed that
survives the storage client's own ladder pauses the saver for the
server's retry-after hint instead of failing the checkpoint.

The port's own copy of ``tpu3fs/ckpt/saver.py``. A leaf is a numpy array
(or scalar), a ``torch.Tensor`` on any device, or a DTensor on a mesh of
one rank; a tensor is snapshotted by one blocking copy to the host, the
only device work ``save_async`` does before it returns. A DTensor on a
mesh of more than one rank has shards this process cannot address, and a
save of it would need a manifest gathered across ranks, which the JAX
package does not have: it raises ``NotImplementedError``. Shard CRCs come
from the write path's checksum pass (``crc32c_many`` on the client's
device); the OVERLOADED fallback takes them from one ``crc32c_pieces``
call. A bfloat16 leaf fails where the JAX package's save fails (numpy
has no buffer format for it).
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from tpu3fs_torch.ckpt.manifest import (
    BF16_STR,
    MANIFEST_NAME,
    Manifest,
    LeafSpec,
    ShardSpec,
    dtype_str,
    flatten_tree,
    leaf_keypaths,
    mesh_axes,
    shard_file_name,
    step_dir,
    tmp_dir,
)
from tpu3fs_torch.client.file_io import FileIoClient
from tpu3fs_torch.kv.kv import IKVEngine, ITransaction, with_transaction
from tpu3fs_torch.meta.store import MetaStore, OpenFlags
from tpu3fs_torch.meta.types import Layout
from tpu3fs_torch.monitor.recorder import CounterRecorder, DistributionRecorder
from tpu3fs_torch.ops.crc32c import crc32c_pieces
from tpu3fs_torch.qos.core import TrafficClass, retry_after_ms_of, tagged
from tpu3fs_torch.rpc.serde import deserialize, serialize
from tpu3fs_torch.utils.result import Code, FsError
from tpu3fs_torch.utils.result import err as _err

_SESSION_PREFIX = b"CKPS"  # KV keyspace: CKPS + root path


def _session_key(root: str) -> bytes:
    return _SESSION_PREFIX + root.encode()


@dataclass
class SaveSessionRec:
    """The KV record guarding one checkpoint root."""

    session_id: str = ""
    step: int = 0
    owner: str = ""
    started: float = 0.0


def _host_snapshot(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes in host memory: one blocking copy (a tensor on
    the CPU is copied too, so a training step may overwrite it at once).
    bfloat16 travels as its raw 16-bit words."""
    host = t.detach().to("cpu", copy=True).contiguous()
    if host.dtype == torch.bfloat16:
        host = host.view(torch.int16)
    return host.numpy()


class SaveSession:
    """Create-exclusive per-root session; release on commit/abort.

    With a KV engine the session record is cluster-wide (any saver
    process contends on the same key). Without one (e.g. a saver over
    the RPC meta client, which exposes no engine) the guard degrades to
    a PROCESS-LOCAL registry — still correct for the common one-trainer-
    process-per-host deployment, just not cross-process."""

    _local_lock = threading.Lock()
    _local: Dict[str, "SaveSessionRec"] = {}

    def __init__(self, kv: Optional[IKVEngine], root: str, step: int,
                 owner: str, ttl_s: float,
                 clock: Callable[[], float] = time.time):
        self._kv = kv
        self._root = root
        self._key = _session_key(root)
        self._clock = clock
        self._ttl = ttl_s
        self.rec = SaveSessionRec(uuid.uuid4().hex, step, owner, clock())

    def _busy(self, cur: SaveSessionRec):
        return _err(
            Code.CKPT_BUSY,
            f"save session {cur.session_id[:8]} (step {cur.step},"
            f" owner {cur.owner}) holds this root")

    def acquire(self) -> None:
        if self._kv is None:
            with self._local_lock:
                cur = self._local.get(self._root)
                if cur is not None and \
                        self._clock() - cur.started < self._ttl:
                    raise self._busy(cur)
                self._local[self._root] = self.rec
            return

        def op(txn: ITransaction) -> None:
            raw = txn.get(self._key)
            if raw is not None:
                cur = deserialize(raw, SaveSessionRec)
                if self._clock() - cur.started < self._ttl:
                    raise self._busy(cur)
                # expired session of a crashed saver: take over
            txn.set(self._key, serialize(self.rec))

        with_transaction(self._kv, op)

    def release(self) -> None:
        if self._kv is None:
            with self._local_lock:
                cur = self._local.get(self._root)
                if cur is not None and \
                        cur.session_id == self.rec.session_id:
                    del self._local[self._root]
            return

        def op(txn: ITransaction) -> None:
            raw = txn.get(self._key)
            if raw is None:
                return
            if deserialize(raw, SaveSessionRec).session_id \
                    == self.rec.session_id:
                txn.clear(self._key)

        with_transaction(self._kv, op)


@dataclass
class _PlannedShard:
    leaf: int
    offset: List[int]
    shape: List[int]
    data: np.ndarray  # host snapshot, row-major


class AsyncCheckpoint:
    """Handle for an in-flight async save; ``wait()`` is the commit
    barrier, ``result()`` re-raises the background failure if any."""

    def __init__(self, step: int):
        self.step = step
        self._done = threading.Event()
        self._error: Optional[BaseException] = None

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> int:
        if not self._done.wait(timeout):
            raise _err(Code.TIMEOUT, f"async save of step {self.step}")
        if self._error is not None:
            raise self._error
        return self.step

    def _finish(self, error: Optional[BaseException]) -> None:
        self._error = error
        self._done.set()


class CheckpointSaver:
    """Save half of the checkpoint manager (see ckpt/__init__)."""

    def __init__(
        self,
        meta: MetaStore,
        fio: FileIoClient,
        *,
        root: str = "/ckpt",
        kv: Optional[IKVEngine] = None,
        client_id: str = "ckpt",
        layout: Optional[Layout] = None,
        session_ttl_s: float = 600.0,
        max_overload_waits: int = 64,
        clock: Callable[[], float] = time.time,
    ):
        self._meta = meta
        self._fio = fio
        self.root = root.rstrip("/") or "/ckpt"
        # in-process MetaStore exposes its engine; the RPC meta client
        # does not — SaveSession then falls back to the local registry
        self._kv = kv if kv is not None else getattr(meta, "engine", None)
        self._client_id = client_id
        # optional layout override for every data file (EC archival saves
        # route here too); None = the meta allocator's default striping
        self._layout = layout
        self._ttl = session_ttl_s
        self._max_overload_waits = max_overload_waits
        self._clock = clock
        self._save_ms = DistributionRecorder("ckpt.save_ms")
        self._stall_ms = DistributionRecorder("ckpt.save_stall_ms")
        self._save_bytes = CounterRecorder("ckpt.save_bytes")

    # -- planning ---------------------------------------------------------
    @staticmethod
    def _leaf_arrays(leaf) -> Tuple[str, Tuple[int, ...], List[str],
                                    List[Tuple[List[int], List[int],
                                               Callable[[], np.ndarray]]]]:
        """-> (dtype string, global shape, axis spec, [(offset, shape,
        fetch)]) for the DISTINCT shards this process must write. A
        tensor's fetch returns the host snapshot taken here."""
        if isinstance(leaf, DTensor):
            mesh = leaf.device_mesh
            if mesh.size() > 1:
                raise NotImplementedError(
                    f"saving a DTensor on a mesh of {mesh.size()} ranks "
                    "needs a manifest gathered across ranks, which the JAX "
                    "package does not have (ROADMAP M10c); restore onto "
                    "DTensor templates works on any number of ranks")
            gshape = tuple(leaf.shape)
            names = list(mesh_axes(mesh))
            spec = [",".join(names[i] for i, p in enumerate(leaf.placements)
                             if p.is_shard() and p.dim % len(gshape) == d)
                    for d in range(len(gshape))]
            host = _host_snapshot(leaf.to_local())
            return (dtype_str(leaf.dtype), gshape, spec,
                    [([0] * len(gshape), list(gshape), lambda: host)])
        if isinstance(leaf, torch.Tensor):
            host = _host_snapshot(leaf)
            return (dtype_str(leaf.dtype), tuple(leaf.shape),
                    [""] * leaf.ndim,
                    [([0] * leaf.ndim, list(leaf.shape), lambda: host)])
        arr = np.asarray(leaf)
        return (arr.dtype.str, tuple(arr.shape), [""] * arr.ndim,
                [([0] * arr.ndim, list(arr.shape), lambda a=arr: a)])

    def _plan(self, tree, step: int) -> Tuple[Manifest, List[_PlannedShard]]:
        """Snapshot addressable shards to host memory and build the
        manifest. This is the only part that touches devices — async mode
        runs it synchronously so the training step can overwrite the
        arrays the moment save_async() returns."""
        skeleton, leaves = flatten_tree(tree)
        keys = leaf_keypaths(skeleton)
        manifest = Manifest(step=step, created=self._clock(), tree=skeleton)
        planned: List[_PlannedShard] = []
        for i, leaf in enumerate(leaves):
            dtype, gshape, spec, shards = self._leaf_arrays(leaf)
            manifest.leaves.append(LeafSpec(
                key=keys[i], dtype=dtype, shape=list(gshape), spec=spec))
            for off, shape, fetch in shards:
                data = np.ascontiguousarray(fetch())
                j = len([s for s in manifest.shards if s.leaf == i])
                # crc filled by _write_and_commit from the write path's
                # single checksum pass (per-chunk CRCs combined per shard
                # by batch_write_files) — planning never re-reads content
                manifest.shards.append(ShardSpec(
                    leaf=i, offset=off, shape=shape,
                    file=shard_file_name(i, j), length=data.nbytes,
                    crc=0))
                planned.append(_PlannedShard(i, off, shape, data))
        for leaf in leaves:
            if isinstance(leaf, DTensor):
                manifest.mesh.update(mesh_axes(leaf.device_mesh))
        return manifest, planned

    # -- IO ---------------------------------------------------------------
    def _write_file(self, path: str, data: bytes) -> None:
        """One whole file through the striped write path, pausing on
        OVERLOADED sheds that out-lasted the client's retry ladder (the
        ckpt class self-throttles rather than failing the save)."""
        # layout only when overridden: the RPC meta client's CreateReq has
        # no layout field (allocator striping is the remote default)
        extra = {} if self._layout is None else {"layout": self._layout}
        for attempt in range(self._max_overload_waits):
            res = self._meta.create(
                path, flags=OpenFlags.WRITE | OpenFlags.CREATE
                | OpenFlags.TRUNC,
                client_id=self._client_id, **extra)
            try:
                n = self._fio.write(res.inode, 0, data)
            except FsError as e:
                try:
                    self._meta.close(res.inode.id, res.session_id)
                except FsError:
                    pass
                if e.code == Code.OVERLOADED:
                    hint = retry_after_ms_of(e.status.message) or 50
                    time.sleep(hint / 1000.0)
                    continue
                raise
            except BaseException:
                try:
                    self._meta.close(res.inode.id, res.session_id)
                except FsError:
                    pass
                raise
            self._meta.close(res.inode.id, res.session_id,
                             length_hint=n, wrote=True)
            self._save_bytes.add(n)
            return
        raise _err(Code.CLIENT_RETRIES_EXHAUSTED,
                   f"ckpt write of {path} shed {self._max_overload_waits}x")

    def _write_files_batched(self, items: List[Tuple[str, object]]):
        """Write MANY whole files as ONE node-grouped striped batch
        (FileIoClient.batch_write_files — the write-side twin of the
        loader's batched reads): every shard's chunk ops go out in one
        pipelined fan-out instead of one file at a time, and the write
        sessions settle in one batch_close. Returns per-file CRC32C
        checksums from the write path's single pooled checksum pass (the
        manifest shard CRCs — content is never read twice). Falls back to
        the per-file self-throttle ladder when the batch sheds
        OVERLOADED."""
        from tpu3fs_torch.meta.store import BatchCloseItem

        extra = {} if self._layout is None else {"layout": self._layout}
        opened: List[Tuple[str, object]] = []  # (path, OpenResult)
        try:
            for path, _ in items:
                opened.append((path, self._meta.create(
                    path, flags=OpenFlags.WRITE | OpenFlags.CREATE
                    | OpenFlags.TRUNC,
                    client_id=self._client_id, **extra)))
            counts, sums = self._fio.batch_write_files(
                [(res.inode, 0, data)
                 for (_, res), (_, data) in zip(opened, items)],
                with_checksums=True)
        except FsError:
            for _, res in opened:
                try:
                    self._meta.close(res.inode.id, res.session_id)
                except FsError:
                    pass
            raise
        closes = [BatchCloseItem(
            inode_id=res.inode.id, session_id=res.session_id,
            length_hint=n, client_id=self._client_id, wrote=1)
            for (_, res), n in zip(opened, counts)]
        batch_close = getattr(self._meta, "batch_close", None)
        settled = (batch_close(closes) if batch_close is not None else
                   [self._meta.close(c.inode_id, c.session_id,
                                     length_hint=c.length_hint, wrote=True)
                    for c in closes])
        for res in settled:
            if isinstance(res, FsError):
                raise res
        for n in counts:
            self._save_bytes.add(n)
        return sums

    def _write_and_commit(self, manifest: Manifest,
                          planned: List[_PlannedShard]) -> None:
        t0 = time.perf_counter()
        step = manifest.step
        tpath = tmp_dir(self.root, step)
        with tagged(TrafficClass.CKPT):
            try:
                self._meta.mkdirs(tpath, recursive=True)
            except FsError as e:
                if e.code != Code.META_EXISTS:
                    raise
                # leftovers of a crashed save of the SAME step: restart
                self._meta.remove(tpath, recursive=True)
                self._meta.mkdirs(tpath, recursive=True)
            # shard arrays go out as BYTE VIEWS of the host snapshot (no
            # tobytes() copy per shard) in one batched striped write;
            # OVERLOADED sheds that outlast the client ladder fall back
            # to the per-file self-throttle path. The manifest commits
            # AFTER the shards: its per-shard CRCs come from the write
            # path's own checksum pass (ONE pooled content pass per save)
            for spec, shard in zip(manifest.shards, planned):
                if manifest.leaves[spec.leaf].dtype == BF16_STR:
                    raise ValueError(
                        f"leaf {manifest.leaves[spec.leaf].key}: a bfloat16 "
                        "leaf has no numpy buffer format, and the JAX "
                        "package's save fails here too (ROADMAP queue 3)")
            items: List[Tuple[str, object]] = [
                (f"{tpath}/{spec.file}",
                 memoryview(np.ascontiguousarray(shard.data)).cast("B"))
                for spec, shard in zip(manifest.shards, planned)]
            mpath = f"{tpath}/{MANIFEST_NAME}"
            try:
                sums = self._write_files_batched(items)
                for spec, cs in zip(manifest.shards, sums):
                    spec.crc = cs.value
                self._write_files_batched([(mpath, manifest.encode())])
            except FsError as e:
                if e.code != Code.OVERLOADED:
                    raise
                crcs = crc32c_pieces([data for _, data in items],
                                     device=self._fio.storage.device)
                for (path, data), spec, crc in zip(
                        items, manifest.shards, crcs):
                    spec.crc = crc
                    self._write_file(path, data)
                self._write_file(mpath, manifest.encode())
            # THE commit: one atomic rename makes the step visible
            self._meta.rename(tpath, step_dir(self.root, step))
        self._save_ms.record((time.perf_counter() - t0) * 1e3)

    # -- public API -------------------------------------------------------
    def save(self, tree, step: int) -> Manifest:
        """Synchronous sharded save; returns the committed manifest."""
        if self._exists(step):
            raise _err(Code.META_EXISTS, step_dir(self.root, step))
        session = SaveSession(self._kv, self.root, step, self._client_id,
                              self._ttl, self._clock)
        session.acquire()
        try:
            manifest, planned = self._plan(tree, step)
            self._write_and_commit(manifest, planned)
            return manifest
        finally:
            session.release()

    def save_async(self, tree, step: int) -> AsyncCheckpoint:
        """Snapshot to host memory, then return immediately; a background
        worker writes + commits. The KV session is taken BEFORE returning,
        so a second save to this root fails fast with CKPT_BUSY until the
        in-flight commit releases it."""
        if self._exists(step):
            raise _err(Code.META_EXISTS, step_dir(self.root, step))
        t0 = time.perf_counter()
        session = SaveSession(self._kv, self.root, step, self._client_id,
                              self._ttl, self._clock)
        session.acquire()
        try:
            manifest, planned = self._plan(tree, step)
        except BaseException:
            session.release()
            raise
        handle = AsyncCheckpoint(step)

        def work() -> None:
            err: Optional[BaseException] = None
            try:
                self._write_and_commit(manifest, planned)
            except BaseException as e:  # surfaced via handle.result()
                err = e
            finally:
                session.release()
                handle._finish(err)

        threading.Thread(target=work, daemon=True,
                         name=f"ckpt-save-{step}").start()
        self._stall_ms.record((time.perf_counter() - t0) * 1e3)
        return handle

    def _exists(self, step: int) -> bool:
        try:
            self._meta.stat(step_dir(self.root, step))
            return True
        except FsError:
            return False
