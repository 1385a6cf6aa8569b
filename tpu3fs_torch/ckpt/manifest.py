"""Checkpoint manifest: pytree structure + shard map + atomic-commit paths.

The manifest is the checkpoint's single source of truth (the analogue of
the reference positioning 3FS as the checkpoint target, README.md:14): a
serde-encoded record of the pytree skeleton, one ``LeafSpec`` per array
leaf (dtype, global shape, the mesh axes it was sharded over), and one
``ShardSpec`` per DISTINCT saved shard — its global index box, the data
file holding its row-major bytes, and a CRC32C over those bytes.

Commit protocol: a save writes everything under ``<root>/<step>.tmp/``
(data files first, ``MANIFEST`` last) and becomes visible only through a
single meta ``rename`` to ``<root>/<step>/``. Readers therefore never
observe a partial checkpoint: either the step directory exists with a
complete manifest, or it does not exist at all. A crashed save is just a
``.tmp`` directory the retention GC sweeps.

The pytree skeleton is stored as a JSON string whose leaves are integer
indices into ``leaves`` — dict/list/tuple nodes round-trip exactly, so a
restore rebuilds the pytree the training loop handed to save().

The port's own copy of ``tpu3fs/ckpt/manifest.py``. Anything that is not a
dict, list or tuple is a leaf, so tensors and DTensors are leaves. A leaf's
dtype is written as numpy's ``dtype.str`` of its element type, what the
JAX package writes (``dtype_str``); ``numpy_dtype`` maps a torch dtype
back for the restore's template check.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu3fs_torch.rpc.serde import deserialize, serialize
from tpu3fs_torch.utils.result import Code
from tpu3fs_torch.utils.result import err as _err

MANIFEST_NAME = "MANIFEST"
TMP_SUFFIX = ".tmp"
ARC_SUFFIX = ".arc"
FORMAT_VERSION = 1


@dataclass
class LeafSpec:
    """One pytree array leaf."""

    key: str                 # "/"-joined keypath (diagnostics; tree is
    #                          authoritative for structure)
    dtype: str               # numpy dtype .str, e.g. "<f4"
    shape: List[int] = field(default_factory=list)   # global shape
    # mesh axis name per dim ("" = unsharded dim) as saved — informational
    # for inspect; restore computes overlap boxes from ShardSpec directly
    spec: List[str] = field(default_factory=list)


@dataclass
class ShardSpec:
    """One distinct saved shard: a global index box -> one data file."""

    leaf: int                                       # index into leaves
    offset: List[int] = field(default_factory=list)  # global origin per dim
    shape: List[int] = field(default_factory=list)   # box extent per dim
    file: str = ""            # data file name inside the step dir
    length: int = 0           # byte length (= prod(shape) * itemsize)
    crc: int = 0              # crc32c over the shard's row-major bytes


@dataclass
class Manifest:
    format_version: int = FORMAT_VERSION
    step: int = 0
    created: float = 0.0
    # saving mesh (axis name -> size), informational
    mesh: Dict[str, int] = field(default_factory=dict)
    tree: str = ""            # JSON skeleton, leaves are indices
    leaves: List[LeafSpec] = field(default_factory=list)
    shards: List[ShardSpec] = field(default_factory=list)

    def encode(self) -> bytes:
        return serialize(self, Manifest)

    @staticmethod
    def decode(raw: bytes) -> "Manifest":
        try:
            m = deserialize(raw, Manifest)
        except Exception as e:
            raise _err(Code.CKPT_CORRUPT, f"manifest decode: {e!r}")
        if m.format_version > FORMAT_VERSION:
            raise _err(Code.CKPT_CORRUPT,
                       f"manifest format {m.format_version} > {FORMAT_VERSION}")
        return m

    def shards_of_leaf(self, leaf_idx: int) -> List[ShardSpec]:
        return [s for s in self.shards if s.leaf == leaf_idx]

    def total_bytes(self) -> int:
        return sum(s.length for s in self.shards)


# -- element types ----------------------------------------------------------

#: the dtype string of a bfloat16 leaf: numpy's ``dtype.str`` of
#: ``ml_dtypes.bfloat16``, which is what the JAX package records for it
BF16_STR = "<V2"


def numpy_dtype(dtype) -> Optional[np.dtype]:
    """A numpy or torch dtype -> its numpy dtype; None for a torch dtype
    numpy has no type for (bfloat16), which then equals no saved dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return None
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def dtype_str(dtype) -> str:
    """The manifest's dtype string of a numpy or torch dtype."""
    if dtype == torch.bfloat16:
        return BF16_STR
    return numpy_dtype(dtype).str


# -- step-directory naming ---------------------------------------------------

def step_dir(root: str, step: int) -> str:
    return f"{root}/{step}"


def tmp_dir(root: str, step: int) -> str:
    return f"{root}/{step}{TMP_SUFFIX}"


def arc_dir(root: str, step: int) -> str:
    return f"{root}/{step}{ARC_SUFFIX}"


def parse_step(name: str) -> Optional[int]:
    """Committed step-directory name -> step number; None for anything
    else (``.tmp``/``.arc`` staging dirs, foreign files)."""
    if not name.isdigit():
        return None
    return int(name)


def parse_staging(name: str) -> Optional[Tuple[int, str]]:
    """``<step>.tmp`` / ``<step>.arc`` -> (step, suffix); else None."""
    for suffix in (TMP_SUFFIX, ARC_SUFFIX):
        if name.endswith(suffix) and name[: -len(suffix)].isdigit():
            return int(name[: -len(suffix)]), suffix
    return None


def shard_file_name(leaf_idx: int, shard_idx: int) -> str:
    return f"l{leaf_idx}.s{shard_idx}"


# -- pytree skeleton <-> JSON ------------------------------------------------
#
# Only dict / list / tuple containers are treated as structure; anything
# else is a leaf. Dict keys must be strings (JSON round-trip exactness);
# insertion order is preserved, so the rebuilt tree is identical.

def flatten_tree(tree) -> Tuple[str, List[object]]:
    """-> (JSON skeleton, leaves in skeleton order)."""
    leaves: List[object] = []

    def walk(node):
        if isinstance(node, dict):
            for k in node:
                if not isinstance(k, str):
                    raise _err(Code.INVALID_ARG,
                               f"checkpoint dict keys must be str, got {k!r}")
            return {"t": "d", "k": list(node.keys()),
                    "v": [walk(v) for v in node.values()]}
        if isinstance(node, (list, tuple)):
            return {"t": "l" if isinstance(node, list) else "u",
                    "v": [walk(v) for v in node]}
        leaves.append(node)
        return {"t": "x", "i": len(leaves) - 1}

    return json.dumps(walk(tree)), leaves


def unflatten_tree(skeleton: str, leaves: List[object]):
    """Rebuild the pytree from its JSON skeleton + leaf values."""
    def walk(node):
        t = node["t"]
        if t == "d":
            return {k: walk(v) for k, v in zip(node["k"], node["v"])}
        if t == "l":
            return [walk(v) for v in node["v"]]
        if t == "u":
            return tuple(walk(v) for v in node["v"])
        return leaves[node["i"]]

    return walk(json.loads(skeleton))


def leaf_keypaths(skeleton: str) -> List[str]:
    """Human-readable "/"-joined keypath per leaf, in leaf order."""
    out: List[str] = []

    def walk(node, path):
        t = node["t"]
        if t == "d":
            for k, v in zip(node["k"], node["v"]):
                walk(v, path + [k])
        elif t in ("l", "u"):
            for i, v in enumerate(node["v"]):
                walk(v, path + [str(i)])
        else:
            out.append("/".join(path))

    walk(json.loads(skeleton), [])
    return out


# -- resharding math ---------------------------------------------------------

def overlap_box(src_off, src_shape, dst_off, dst_shape
                ) -> Optional[Tuple[List[int], List[int]]]:
    """Intersection of two global index boxes -> (origin, shape) or None."""
    lo, shape = [], []
    for so, ss, do, ds in zip(src_off, src_shape, dst_off, dst_shape):
        a = max(so, do)
        b = min(so + ss, do + ds)
        if b <= a:
            return None
        lo.append(a)
        shape.append(b - a)
    return lo, shape


def contiguous_runs(box_off: List[int], box_shape: List[int],
                    src_off: List[int], src_shape: List[int],
                    itemsize: int) -> List[Tuple[int, int]]:
    """Byte ranges of a global box inside a row-major saved shard.

    The box (``box_off``/``box_shape``, global coordinates) must lie
    within the source shard (``src_off``/``src_shape``). Returns
    ``[(byte_offset_in_shard, byte_length)]`` runs, emitted in C order of
    the box — so concatenating the fetched runs yields exactly the box's
    row-major bytes. Trailing dims where the box spans the full source
    extent fold into each run (one run per remaining outer index), which
    is what makes same-sharding restores single-run per shard.
    """
    nd = len(src_shape)
    if nd == 0:
        return [(0, itemsize)]
    # source strides in elements
    strides = [1] * nd
    for d in range(nd - 2, -1, -1):
        strides[d] = strides[d + 1] * src_shape[d + 1]
    rel = [box_off[d] - src_off[d] for d in range(nd)]
    # j = first dim (from the left) such that dims j..nd-1 are full-source
    j = nd
    while j > 0 and box_shape[j - 1] == src_shape[j - 1]:
        j -= 1
    # the run covers dims j-1..nd-1 (partial dim j-1 + full trailing);
    # j == 0 means the whole box is one contiguous run
    run_dim = max(0, j - 1)
    run_elems = 1
    for d in range(run_dim, nd):
        run_elems *= box_shape[d]
    outer = box_shape[:run_dim]
    runs: List[Tuple[int, int]] = []

    def emit(idx: List[int]) -> None:
        off = 0
        for d in range(nd):
            off += (rel[d] + (idx[d] if d < run_dim else 0)) * strides[d]
        runs.append((off * itemsize, run_elems * itemsize))

    idx = [0] * run_dim
    while True:
        emit(idx)
        d = run_dim - 1
        while d >= 0:
            idx[d] += 1
            if idx[d] < outer[d]:
                break
            idx[d] = 0
            d -= 1
        if d < 0:
            break
    return runs


# -- DTensor placements ------------------------------------------------------

def mesh_axes(mesh) -> Dict[str, int]:
    """A DeviceMesh's axis name -> size, in mesh order (an unnamed axis is
    named by its index)."""
    names = mesh.mesh_dim_names or tuple(str(i) for i in range(mesh.ndim))
    return {str(n): int(mesh.size(i)) for i, n in enumerate(names)}


def placement_box(gshape, placements, sizes, coord
                  ) -> Tuple[List[int], List[int]]:
    """The global index box (origin, shape) a mesh position holds of an
    array of ``gshape`` under DTensor ``placements``: each ``Shard(d)``
    over mesh axis i (of ``sizes[i]`` positions, this one at ``coord[i]``)
    cuts the extent left on dim d into ``torch.chunk`` pieces, in mesh
    axis order; ``Replicate`` keeps it. The counterpart of a
    ``NamedSharding``'s device index map."""
    off, shape = [0] * len(gshape), list(gshape)
    for p, n, c in zip(placements, sizes, coord):
        if p.is_replicate():
            continue
        if not p.is_shard():
            raise _err(Code.INVALID_ARG,
                       f"placement {p} of a checkpoint template: only "
                       "Shard and Replicate describe stored values")
        d = p.dim % len(gshape)
        step = -(-shape[d] // n)
        lo = min(c * step, shape[d])
        hi = min(lo + step, shape[d])
        off[d] += lo
        shape[d] = hi - lo
    return off, shape
