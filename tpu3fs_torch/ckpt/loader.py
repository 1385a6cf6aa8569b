"""Resharding checkpoint restore: exact byte-range reads, any target mesh.

A checkpoint saved on one mesh restores onto a DIFFERENT mesh/sharding
without a full gather: for every target shard (each addressable device's
index box under the target sharding) the loader intersects the box with
the saved shards' boxes (manifest.ShardSpec), converts each overlap into
contiguous byte runs inside the saved shard files (manifest.
contiguous_runs — the row-major stride math), and batch-reads exactly
those ranges through ``FileIoClient.batch_read_files`` — one node-grouped
chunk batch for the whole restore, riding the stripe/EC read paths
unchanged.

Two read modes:

- ``verify=True`` (default): every saved shard the restore touches is
  read IN FULL once, its CRC32C checked against the manifest, and the
  overlaps sliced from the verified bytes. Corruption (bit rot, a
  truncated shard file) fails loudly with ``CKPT_CORRUPT``.
- ``verify=False``: the byte-range-exact fast path — only the runs the
  target sharding needs are fetched (the mode the stripe/EC boundary
  tests exercise), skipping CRC (ranges don't checksum independently).

Restore is ``ckpt``-class traffic like save, so a restore storm schedules
behind foreground IO.

The port's own copy of ``tpu3fs/ckpt/loader.py``. ``verify=True`` checks
every shard it reads with one ``crc32c_pieces`` call on the client's
device (one K2 launch over 1 MiB pieces, combined per shard). Templates:
a ``torch.Tensor`` gives a tensor on that tensor's device; a DTensor gives
``DTensor.from_local`` of the box this rank's placements hold (any number
of ranks: each rank fetches only its own box); anything else with a
``shape`` (a numpy array) gives a numpy array, as ``like=None`` does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from tpu3fs_torch.ckpt.manifest import (
    MANIFEST_NAME,
    Manifest,
    contiguous_runs,
    numpy_dtype,
    overlap_box,
    placement_box,
    step_dir,
    unflatten_tree,
)
from tpu3fs_torch.client.file_io import FileIoClient
from tpu3fs_torch.meta.store import MetaStore
from tpu3fs_torch.monitor.recorder import CounterRecorder, DistributionRecorder
from tpu3fs_torch.ops.crc32c import crc32c_pieces
from tpu3fs_torch.qos.core import TrafficClass, tagged
from tpu3fs_torch.utils.result import Code, FsError
from tpu3fs_torch.utils.result import err as _err


class CheckpointLoader:
    """Restore half of the checkpoint manager (see ckpt/__init__)."""

    def __init__(self, meta: MetaStore, fio: FileIoClient, *,
                 root: str = "/ckpt"):
        self._meta = meta
        self._fio = fio
        self.root = root.rstrip("/") or "/ckpt"
        self._restore_ms = DistributionRecorder("ckpt.restore_ms")
        self._restore_bytes = CounterRecorder("ckpt.restore_bytes")

    # -- manifest ---------------------------------------------------------
    def manifest(self, step: int) -> Manifest:
        path = f"{step_dir(self.root, step)}/{MANIFEST_NAME}"
        try:
            inode = self._meta.stat(path)
        except FsError as e:
            if e.code == Code.META_NOT_FOUND:
                raise _err(Code.CKPT_NOT_FOUND,
                           f"step {step} under {self.root}")
            raise
        with tagged(TrafficClass.CKPT):
            raw = self._fio.read(inode, 0, inode.length)
        m = Manifest.decode(raw)
        if m.step != step:
            raise _err(Code.CKPT_CORRUPT,
                       f"manifest step {m.step} != dir {step}")
        return m

    def steps(self) -> List[int]:
        """Committed steps under the root, ascending (``.tmp``/``.arc``
        staging dirs are invisible by construction)."""
        from tpu3fs_torch.ckpt.manifest import parse_step

        try:
            ents = self._meta.list_dir(self.root)
        except FsError as e:
            if e.code == Code.META_NOT_FOUND:
                return []
            raise
        return sorted(s for s in (parse_step(e.name) for e in ents)
                      if s is not None)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    # -- restore ----------------------------------------------------------
    def restore(self, step: int, like=None, *, verify: bool = True):
        """Rebuild the checkpoint's pytree.

        ``like=None`` assembles every leaf as a full numpy array. With a
        template pytree (same structure; leaves are tensors, DTensors,
        numpy arrays or anything with ``.shape``/``.dtype``), a tensor
        leaf lands on its template's device and a DTensor leaf is built
        from this rank's box — each rank's box is fetched independently,
        so the restore reads only what the TARGET placements need.
        """
        import time as _time

        t0 = _time.perf_counter()
        manifest = self.manifest(step)
        saved_leaves = manifest.leaves
        templates = self._match_templates(manifest, like)

        # one box request per (leaf, distinct target box); replicated
        # target shards share the fetched bytes
        boxes: List[Tuple[int, Tuple[int, ...], Tuple[int, ...]]] = []
        box_index: Dict[Tuple, int] = {}
        per_leaf_boxes: List[List[int]] = []
        for li, spec in enumerate(saved_leaves):
            tmpl = templates[li]
            mine: List[int] = []
            for off, shape in self._target_boxes(spec, tmpl):
                key = (li, tuple(off), tuple(shape))
                idx = box_index.get(key)
                if idx is None:
                    idx = len(boxes)
                    box_index[key] = idx
                    boxes.append((li, tuple(off), tuple(shape)))
                mine.append(idx)
            per_leaf_boxes.append(mine)

        box_arrays = self._fetch_boxes(manifest, boxes, verify)
        for (li, _, _), arr in zip(boxes, box_arrays):
            self._restore_bytes.add(arr.nbytes)

        leaves_out = [
            self._build_leaf(spec, templates[li],
                             [(boxes[b][1], box_arrays[b])
                              for b in per_leaf_boxes[li]])
            for li, spec in enumerate(saved_leaves)
        ]
        tree = unflatten_tree(manifest.tree, leaves_out)
        self._restore_ms.record((_time.perf_counter() - t0) * 1e3)
        return tree

    # -- internals --------------------------------------------------------
    @staticmethod
    def _match_templates(manifest: Manifest, like) -> List[Optional[object]]:
        if like is None:
            return [None] * len(manifest.leaves)
        from tpu3fs_torch.ckpt.manifest import flatten_tree

        skeleton, tleaves = flatten_tree(like)
        if skeleton != manifest.tree:
            raise _err(Code.INVALID_ARG,
                       "template pytree structure differs from checkpoint")
        for spec, tmpl in zip(manifest.leaves, tleaves):
            tshape = tuple(getattr(tmpl, "shape", ()))
            if tuple(spec.shape) != tshape:
                raise _err(Code.INVALID_ARG,
                           f"leaf {spec.key}: template shape {tshape} != "
                           f"saved {tuple(spec.shape)}")
            tdtype = getattr(tmpl, "dtype", None)
            if tdtype is not None and \
                    numpy_dtype(tdtype) != np.dtype(spec.dtype):
                raise _err(Code.INVALID_ARG,
                           f"leaf {spec.key}: template dtype {tdtype} != "
                           f"saved {spec.dtype}")
        return list(tleaves)

    @staticmethod
    def _target_boxes(spec, tmpl) -> List[Tuple[List[int], List[int]]]:
        """Distinct index boxes the target needs for one leaf: this rank's
        box of a DTensor template, else the whole array."""
        gshape = tuple(spec.shape)
        if isinstance(tmpl, DTensor):
            return [_rank_box(gshape, tmpl)]
        return [([0] * len(gshape), list(gshape))]

    def _fetch_boxes(self, manifest: Manifest, boxes, verify: bool
                     ) -> List[np.ndarray]:
        """Fetch every requested global box, one node-grouped batch."""
        sdir = step_dir(self.root, manifest.step)
        # overlap plan: per box -> [(shard idx, overlap off, overlap shape,
        # [runs])]; verify mode instead loads whole shards once
        needed_shards: Dict[int, object] = {}
        plans = []
        for li, off, shape in boxes:
            parts = []
            for si, sh in enumerate(manifest.shards):
                if sh.leaf != li:
                    continue
                ov = overlap_box(sh.offset, sh.shape, list(off), list(shape))
                if ov is None:
                    continue
                needed_shards[si] = None
                parts.append((si, ov[0], ov[1]))
            covered = sum(int(np.prod(p[2])) for p in parts)
            want = int(np.prod(shape)) if shape else 1
            if covered != want:
                # saved shards of one array tile the global index space
                # disjointly, so a gap (or double cover) means a
                # corrupt/foreign manifest
                raise _err(Code.CKPT_CORRUPT,
                           f"leaf {li}: saved shards cover {covered} of "
                           f"{want} elements of box {off}+{shape}")
            plans.append(parts)

        inodes: Dict[int, object] = {}
        with tagged(TrafficClass.CKPT):
            paths = {si: f"{sdir}/{manifest.shards[si].file}"
                     for si in needed_shards}
            stats = self._meta.batch_stat_by_path(list(paths.values()))
            for si, inode in zip(paths, stats):
                if inode is None:
                    raise _err(Code.CKPT_CORRUPT,
                               f"missing shard file {paths[si]}")
                inodes[si] = inode

            # runs of every overlap, keyed (box idx, part idx), computed
            # once and shared by both read modes and the assembly below
            part_runs: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
            for bi, parts in enumerate(plans):
                for pi, (si, ooff, oshape) in enumerate(parts):
                    sh = manifest.shards[si]
                    itemsize = np.dtype(
                        manifest.leaves[sh.leaf].dtype).itemsize
                    part_runs[(bi, pi)] = contiguous_runs(
                        ooff, oshape, sh.offset, sh.shape, itemsize)

            if verify:
                blobs = self._fio.batch_read_files(
                    [(inodes[si], 0, manifest.shards[si].length)
                     for si in needed_shards])
                shard_bytes = dict(zip(needed_shards, blobs))
                # one K2 launch for every shard of the restore
                crcs = crc32c_pieces(list(shard_bytes.values()),
                                     device=self._fio.storage.device)
                for (si, raw), crc in zip(shard_bytes.items(), crcs):
                    sh = manifest.shards[si]
                    if len(raw) != sh.length or crc != sh.crc:
                        raise _err(Code.CKPT_CORRUPT,
                                   f"shard {sh.file}: CRC/length mismatch")

                def part_bytes(bi: int, pi: int) -> bytes:
                    si = plans[bi][pi][0]
                    raw = shard_bytes[si]
                    return b"".join(raw[o:o + n]
                                    for o, n in part_runs[(bi, pi)])
            else:
                # byte-range-exact: EVERY run of every box rides one
                # node-grouped batch_read_files call
                reqs: List[Tuple[object, int, int]] = []
                owners: List[Tuple[int, int]] = []
                for (bi, pi), runs in part_runs.items():
                    si = plans[bi][pi][0]
                    for o, n in runs:
                        reqs.append((inodes[si], o, n))
                        owners.append((bi, pi))
                blobs = self._fio.batch_read_files(reqs)
                gathered: Dict[Tuple[int, int], List[bytes]] = {}
                for key, blob in zip(owners, blobs):
                    gathered.setdefault(key, []).append(blob)

                def part_bytes(bi: int, pi: int) -> bytes:
                    return b"".join(gathered[(bi, pi)])

        out: List[np.ndarray] = []
        for bi, ((li, off, shape), parts) in enumerate(zip(boxes, plans)):
            dtype = np.dtype(manifest.leaves[li].dtype)
            buf = np.empty(shape, dtype=dtype)
            for pi, (si, ooff, oshape) in enumerate(parts):
                piece = np.frombuffer(
                    part_bytes(bi, pi), dtype=dtype).reshape(oshape)
                dst = tuple(slice(ooff[d] - off[d],
                                  ooff[d] - off[d] + oshape[d])
                            for d in range(len(shape)))
                buf[dst] = piece
            out.append(buf)
        return out

    @staticmethod
    def _build_leaf(spec, tmpl, box_arrays):
        """Assemble one output leaf from its fetched box (one box a leaf:
        this rank's, or the whole array)."""
        (_off, arr), = box_arrays
        if isinstance(tmpl, DTensor):
            local = _to_device(arr, tmpl.device)
            return DTensor.from_local(
                local, tmpl.device_mesh, tmpl.placements, run_check=False,
                shape=tmpl.shape, stride=tmpl.stride())
        arr = arr.reshape(tuple(spec.shape))
        if isinstance(tmpl, torch.Tensor):
            return _to_device(arr, tmpl.device)
        return arr


def _rank_box(gshape, tmpl) -> Tuple[List[int], List[int]]:
    """The global box this rank holds of a DTensor template's leaf."""
    mesh = tmpl.device_mesh
    coord = mesh.get_coordinate()
    if coord is None:
        raise _err(Code.INVALID_ARG, "this rank is not in the template's "
                   "mesh")
    return placement_box(gshape, tmpl.placements,
                         [mesh.size(i) for i in range(mesh.ndim)], coord)


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    """The device hand-off: a host tensor over the assembled box, copied
    to ``device`` (blocking, so the leaf is there on return)."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device, copy=True)
