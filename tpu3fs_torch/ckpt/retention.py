"""Checkpoint retention: keep-last-N / keep-every-K, trash deletes, EC
archival of cold steps.

Retention runs against the committed step directories only; ``.tmp``
leftovers of crashed saves are swept separately once they are older than
``tmp_ttl_s`` (a live save's ``.tmp`` must never be reaped under it —
the KV save session already serializes savers per root, the TTL covers
a crashed one whose session expired).

Deletes route through the trash subsystem (utils/trash.py): an evicted
step is RECOVERABLE until its trash keep-time elapses, exactly like the
reference's user-facing rm. ``gc_removed`` counts evictions for the
monitor.

Archival (RapidRAID direction, PAPERS.md arxiv 1207.6744): cold steps
re-encode onto an erasure-coded layout — every data file is copied onto
an EC chain layout (the ops/rs.py striped write path underneath),
CRC-checked against the manifest, and the replicated original goes to
trash; the swap publishes through the same rename protocol as save, so
readers only ever see a fully-replicated or a fully-EC step.

The port's own copy of ``tpu3fs/ckpt/retention.py`` (host code): the
archive's re-encode and its CRCs run through the client's write path on
its device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional

from tpu3fs_torch.ckpt.manifest import (
    MANIFEST_NAME,
    Manifest,
    arc_dir,
    parse_staging,
    parse_step,
    step_dir,
)
from tpu3fs_torch.client.file_io import FileIoClient
from tpu3fs_torch.meta.store import MetaStore, OpenFlags
from tpu3fs_torch.meta.types import Layout
from tpu3fs_torch.monitor.recorder import CounterRecorder
from tpu3fs_torch.qos.core import TrafficClass, tagged
from tpu3fs_torch.utils import trash as _trash
from tpu3fs_torch.utils.result import Code, FsError
from tpu3fs_torch.utils.result import err as _err


@dataclass
class RetentionPolicy:
    """keep_last newest steps always survive; keep_every keeps milestone
    steps (step % keep_every == 0) beyond that. 0 disables a rule."""

    keep_last: int = 3
    keep_every: int = 0

    def keep(self, steps: List[int]) -> set:
        steps = sorted(steps)
        kept = set(steps[-self.keep_last:] if self.keep_last > 0 else [])
        if self.keep_every > 0:
            kept |= {s for s in steps if s % self.keep_every == 0}
        return kept


class CheckpointGC:
    """Retention sweep + stale-tmp cleanup + optional EC archival."""

    def __init__(
        self,
        meta: MetaStore,
        fio: FileIoClient,
        *,
        root: str = "/ckpt",
        policy: Optional[RetentionPolicy] = None,
        trash_keep_s: int = 86400,
        tmp_ttl_s: float = 3600.0,
        client_id: str = "ckpt-gc",
        clock: Callable[[], float] = time.time,
    ):
        self._meta = meta
        self._fio = fio
        self.root = root.rstrip("/") or "/ckpt"
        self.policy = policy or RetentionPolicy()
        self.trash_keep_s = trash_keep_s
        self._tmp_ttl_s = tmp_ttl_s
        self._client_id = client_id
        self._clock = clock
        self._removed = CounterRecorder("ckpt.gc_removed")

    # -- listing ----------------------------------------------------------
    def _entries(self) -> List[str]:
        try:
            return [e.name for e in self._meta.list_dir(self.root)]
        except FsError as e:
            if e.code == Code.META_NOT_FOUND:
                return []
            raise

    def steps(self) -> List[int]:
        return sorted(s for s in (parse_step(n) for n in self._entries())
                      if s is not None)

    # -- retention --------------------------------------------------------
    def run_once(self) -> int:
        """One sweep: evict steps outside the policy (through trash) and
        reap stale staging dirs. Returns steps evicted."""
        removed = 0
        with tagged(TrafficClass.CKPT):
            steps = self.steps()
            kept = self.policy.keep(steps)
            for s in steps:
                if s in kept:
                    continue
                self._evict(step_dir(self.root, s))
                removed += 1
            self._sweep_staging()
        return removed

    def _evict(self, path: str) -> None:
        _trash.move_to_trash(self._meta, path, keep_s=self.trash_keep_s,
                             clock=self._clock)
        self._removed.add()

    def remove_step(self, step: int) -> None:
        """Explicit eviction (admin_cli ckpt-rm): same trash routing as
        the policy sweep."""
        path = step_dir(self.root, step)
        try:
            self._meta.stat(path)
        except FsError as e:
            if e.code == Code.META_NOT_FOUND:
                raise _err(Code.CKPT_NOT_FOUND, path)
            raise
        with tagged(TrafficClass.CKPT):
            self._evict(path)

    def _sweep_staging(self) -> int:
        """Reap ``.tmp``/``.arc`` leftovers of crashed saves/archives once
        their newest file is older than tmp_ttl_s."""
        now = self._clock()
        reaped = 0
        for name in self._entries():
            parsed = parse_staging(name)
            if parsed is None:
                continue
            path = f"{self.root}/{name}"
            try:
                inode = self._meta.stat(path)
                newest = inode.mtime
                for ent in self._meta.list_dir(path):
                    child = self._meta.stat(f"{path}/{ent.name}")
                    newest = max(newest, child.mtime)
                if now - newest < self._tmp_ttl_s:
                    continue  # plausibly a live save
                self._meta.remove(path, recursive=True)
                reaped += 1
            except FsError:
                continue  # raced a concurrent commit/cleanup
        return reaped

    # -- archival ---------------------------------------------------------
    def step_is_archived(self, step: int) -> bool:
        """True when the step's files already live on EC chains (layout-
        independent: re-pointing the archive layout at different EC
        chains does not re-archive already-cold steps)."""
        try:
            inode = self._meta.stat(
                f"{step_dir(self.root, step)}/{MANIFEST_NAME}")
        except FsError:
            return False
        layout = inode.layout
        if layout is None or not layout.chains:
            return False
        try:
            return all(self._fio.is_ec_chain(c) for c in set(layout.chains))
        except FsError:
            return False  # routing gap: treat as not archived, retry later

    def archive_pass(self, layout: Layout, *,
                     keep_replicated: int) -> int:
        """Auto-archive sweep (the ckpt_gc daemon tick): every committed
        step older than the newest ``keep_replicated`` that is not
        already erasure-coded re-encodes onto ``layout``. Newest steps
        stay replicated — they are the restart-likely ones, and CR
        restores skip the decode path. Returns steps archived."""
        if keep_replicated < 0:
            raise _err(Code.INVALID_ARG,
                       f"keep_replicated {keep_replicated}")
        steps = self.steps()
        cold = steps[:-keep_replicated] if keep_replicated > 0 else steps
        archived = 0
        for s in cold:
            if self.step_is_archived(s):
                continue
            self.archive_step(s, layout)
            archived += 1
        return archived

    def archive_step(self, step: int, layout: Layout) -> Manifest:
        """Re-encode one cold step onto `layout` (an EC-chain layout)
        through the FIRST-CLASS batched EC write path: every data file
        reads back as ONE batch_read_files, the ``<step>.arc/`` files
        create as one batch_create, and the whole step lands as ONE
        encode-fused ``batch_write_files(with_checksums=True)`` — full
        stripes encode once client-side and fan out shard-batched, and
        the returned per-file CRC32Cs verify against the manifest with
        no separate content pass (the old path copied file-by-file and
        CRC-checked in its own read pass). Then swap — old replicas to
        trash, ``.arc`` renamed into place."""
        sdir = step_dir(self.root, step)
        apath = arc_dir(self.root, step)
        with tagged(TrafficClass.CKPT):
            try:
                minode = self._meta.stat(f"{sdir}/{MANIFEST_NAME}")
            except FsError as e:
                if e.code == Code.META_NOT_FOUND:
                    raise _err(Code.CKPT_NOT_FOUND, sdir)
                raise
            manifest = Manifest.decode(
                self._fio.read(minode, 0, minode.length))
            try:
                self._meta.mkdirs(apath, recursive=True)
            except FsError as e:
                if e.code != Code.META_EXISTS:
                    raise
                self._meta.remove(apath, recursive=True)
                self._meta.mkdirs(apath, recursive=True)
            srcs = [self._meta.stat(f"{sdir}/{sh.file}")
                    for sh in manifest.shards]
            blobs = self._fio.batch_read_files(
                [(src, 0, sh.length)
                 for src, sh in zip(srcs, manifest.shards)])
            for sh, raw in zip(manifest.shards, blobs):
                if len(raw) != sh.length:
                    raise _err(Code.CKPT_CORRUPT,
                               f"shard {sh.file}: short read on archive")
            names = [sh.file for sh in manifest.shards] + [MANIFEST_NAME]
            payloads = blobs + [manifest.encode()]
            opened = self._create_all(
                [f"{apath}/{name}" for name in names], layout)
            try:
                counts, sums = self._fio.batch_write_files(
                    [(res.inode, 0, blob)
                     for res, blob in zip(opened, payloads)],
                    with_checksums=True)
            except BaseException:
                for res in opened:
                    try:
                        self._meta.close(res.inode.id, res.session_id)
                    except FsError:
                        pass
                raise
            # the write-side CRCs come from the SAME pooled pass that fed
            # the trusted-CRC install, so comparing them to the manifest
            # verifies source bytes -> EC shards end to end without a
            # re-read
            for sh, crc in zip(manifest.shards, sums):
                if crc.value != sh.crc:
                    raise _err(Code.CKPT_CORRUPT,
                               f"shard {sh.file}: CRC mismatch on archive")
            self._close_all(opened, counts)
            # swap: the step vanishes for at most the gap between the two
            # renames; the .arc dir is complete before the old leaves.
            # (trash routing, but NOT counted as a gc_removed eviction —
            # the step survives, re-encoded)
            _trash.move_to_trash(self._meta, sdir,
                                 keep_s=self.trash_keep_s,
                                 clock=self._clock)
            self._meta.rename(apath, sdir)
        return manifest

    def _create_all(self, paths: List[str], layout: Layout) -> List:
        """Create the archive files in one batch_create when the meta
        surface has one (in-process store or RPC client), else the
        per-file ladder."""
        flags = OpenFlags.WRITE | OpenFlags.CREATE | OpenFlags.TRUNC
        batch_create = getattr(self._meta, "batch_create", None)
        if batch_create is not None:
            from tpu3fs_torch.meta.store import BatchCreateItem

            results = batch_create([
                BatchCreateItem(path=p, flags=flags,
                                client_id=self._client_id, layout=layout)
                for p in paths])
            opened = []
            for res in results:
                if isinstance(res, FsError):
                    for prev in opened:
                        try:
                            self._meta.close(prev.inode.id, prev.session_id)
                        except FsError:
                            pass
                    raise res
                opened.append(res)
            return opened
        return [self._meta.create(p, flags=flags,
                                  client_id=self._client_id, layout=layout)
                for p in paths]

    def _close_all(self, opened: List, counts: List[int]) -> None:
        from tpu3fs_torch.meta.store import BatchCloseItem

        batch_close = getattr(self._meta, "batch_close", None)
        if batch_close is not None:
            results = batch_close([
                BatchCloseItem(inode_id=res.inode.id,
                               session_id=res.session_id,
                               length_hint=n, client_id=self._client_id,
                               wrote=1)
                for res, n in zip(opened, counts)])
            for res in results:
                if isinstance(res, FsError):
                    raise res
            return
        for res, n in zip(opened, counts):
            self._meta.close(res.inode.id, res.session_id, length_hint=n,
                             wrote=True)
