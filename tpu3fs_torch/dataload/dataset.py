"""Multi-file packed dataset: global sample index, Feistel shuffle, dp
sharding.

A ``PackedDataset`` is an ordered list of record files (recordio.py)
presented as one global sample space ``[0, num_samples)``. Per-epoch
shuffling is a seeded FEISTEL PERMUTATION over that space — a pseudo-
random bijection evaluated point-wise, so no O(N) permutation array is
ever materialized (a 10B-sample corpus shuffles in O(1) memory) and any
position of any epoch is addressable directly, which is what makes
mid-epoch resume exact: the iterator's state is just (seed, epoch,
cursor).

Data-parallel sharding follows the process mesh (parallel/mesh.py): a
global batch of ``global_batch`` consecutive permuted positions splits
into ``dp_size`` contiguous microbatches, replica r taking rows
``[r*b, (r+1)*b)``. Across replicas every epoch covers each (retained)
sample exactly once — the no-dup/no-loss contract the coverage test pins.
The trailing ``num_samples % global_batch`` samples of an epoch are
dropped (the standard drop-last contract), so every epoch has the same
step count on every replica.

The port's own copy of ``tpu3fs/dataload/dataset.py``. ``dp_info`` takes
a ``DeviceMesh``, on which one process is one rank on one device.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from tpu3fs_torch.dataload.recordio import RecordFile
from tpu3fs_torch.utils.result import Code
from tpu3fs_torch.utils.result import err as _err

_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def _mix(x: int) -> int:
    """64-bit finalizer (splitmix64): the Feistel round function core."""
    x &= _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


class FeistelPermutation:
    """Seeded pseudo-random permutation of ``[0, n)``, O(1) memory.

    A balanced Feistel network over the smallest even-bit-width domain
    covering ``n``, with cycle walking to land back inside ``[0, n)``
    (re-encrypting an out-of-range value stays within the power-of-two
    domain, and a permutation of that domain restricted to ``[0, n)`` is
    a permutation of ``[0, n)`` — the standard format-preserving
    construction). Four rounds of a splitmix64-derived round function are
    plenty for shuffling; this is a shuffle, not a cipher.
    """

    ROUNDS = 4

    def __init__(self, n: int, seed: int, epoch: int = 0):
        if n < 0:
            raise _err(Code.INVALID_ARG, f"domain size {n}")
        self.n = n
        half = max(1, ((max(1, n - 1).bit_length()) + 1) // 2)
        self._half_bits = half
        self._mask = (1 << half) - 1
        # per-(seed, epoch, round) subkeys: epochs get unrelated
        # permutations from one seed
        base = _mix((seed & _M64) ^ ((epoch & _M64) * _GOLDEN))
        self._keys = [_mix(base + r * _GOLDEN) for r in range(self.ROUNDS)]

    def _encrypt(self, x: int) -> int:
        hb, mask = self._half_bits, self._mask
        left, right = x >> hb, x & mask
        for key in self._keys:
            left, right = right, left ^ (_mix(right ^ key) & mask)
        return (left << hb) | right

    def __call__(self, i: int) -> int:
        if not 0 <= i < self.n:
            raise _err(Code.INVALID_ARG, f"index {i} outside [0, {self.n})")
        x = self._encrypt(i)
        while x >= self.n:  # cycle walk (expected <2 iterations)
            x = self._encrypt(x)
        return x


class IdentityPermutation:
    """Shuffle-off stand-in with the FeistelPermutation surface."""

    def __init__(self, n: int):
        self.n = n

    def __call__(self, i: int) -> int:
        if not 0 <= i < self.n:
            raise _err(Code.INVALID_ARG, f"index {i} outside [0, {self.n})")
        return i


def dp_info(mesh, axis: str = "dp") -> Tuple[int, Dict[int, list]]:
    """-> (dp_size, {dp index -> local devices of that replica row}).

    The counterpart of the JAX package's ``dp_info`` on a ``DeviceMesh``:
    one process is one rank, so the map holds this rank's coordinate
    along ``axis`` and its one device; all other mesh axes replicate the
    batch (data parallelism shards only the batch dimension).
    """
    names = [str(n) for n in (mesh.mesh_dim_names or ())]
    if axis not in names:
        raise _err(Code.INVALID_ARG,
                   f"mesh has no {axis!r} axis (axes: {names})")
    dim = names.index(axis)
    dp_size = int(mesh.size(dim))
    coord = mesh.get_coordinate()
    if coord is None:
        return dp_size, {}
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    return dp_size, {int(coord[dim]): [device]}


class PackedDataset:
    """Ordered record files as one global, shuffle-addressable index."""

    def __init__(self, meta, fio, paths: Sequence[str]):
        if not paths:
            raise _err(Code.INVALID_ARG, "dataset needs at least one file")
        self._meta = meta
        self._fio = fio
        self.files: List[RecordFile] = [
            RecordFile.open(meta, fio, p) for p in paths
        ]
        self._cum: List[int] = []
        total = 0
        for rf in self.files:
            total += rf.num_records
            self._cum.append(total)

    @property
    def num_samples(self) -> int:
        return self._cum[-1] if self._cum else 0

    def __len__(self) -> int:
        return self.num_samples

    def total_payload_bytes(self) -> int:
        return sum(rf.total_payload_bytes() for rf in self.files)

    def locate(self, gid: int) -> Tuple[int, int]:
        """Global sample id -> (file index, record index in file)."""
        if not 0 <= gid < self.num_samples:
            raise _err(Code.INVALID_ARG,
                       f"sample {gid} outside [0, {self.num_samples})")
        fi = bisect.bisect_right(self._cum, gid)
        base = self._cum[fi - 1] if fi else 0
        return fi, gid - base

    # -- epoch geometry ---------------------------------------------------
    def permutation(self, seed: int, epoch: int, *, shuffle: bool = True):
        if not shuffle:
            return IdentityPermutation(self.num_samples)
        return FeistelPermutation(self.num_samples, seed, epoch)

    def steps_per_epoch(self, global_batch: int) -> int:
        if global_batch <= 0:
            raise _err(Code.INVALID_ARG, f"global_batch {global_batch}")
        return self.num_samples // global_batch

    def batch_ids(self, perm, step: int, global_batch: int,
                  *, dp_rank: Optional[int] = None,
                  dp_size: int = 1) -> List[int]:
        """Sample ids of global step ``step`` under permutation ``perm``
        (a whole global batch, or one replica's contiguous microbatch
        when ``dp_rank`` is given). ``global_batch`` must divide by
        ``dp_size``."""
        if global_batch % max(1, dp_size) != 0:
            raise _err(Code.INVALID_ARG,
                       f"global_batch {global_batch} not divisible by "
                       f"dp_size {dp_size}")
        lo = step * global_batch
        hi = lo + global_batch
        if dp_rank is not None:
            b = global_batch // dp_size
            lo, hi = lo + dp_rank * b, lo + (dp_rank + 1) * b
        return [perm(i) for i in range(lo, hi)]

    def read_samples(self, gids: Sequence[int], *, verify: bool = True,
                     coalesce_gap: int = 64 << 10,
                     max_span_bytes: int = 8 << 20) -> List[bytes]:
        """Convenience non-pipelined fetch (the loader has the fast
        path): coalesced batch read of arbitrary global ids."""
        by_file: Dict[int, List[Tuple[int, int]]] = {}
        for pos, gid in enumerate(gids):
            fi, ri = self.locate(gid)
            by_file.setdefault(fi, []).append((pos, ri))
        out: List[Optional[bytes]] = [None] * len(gids)
        for fi, items in by_file.items():
            recs = self.files[fi].read_batch(
                [ri for _, ri in items], verify=verify,
                coalesce_gap=coalesce_gap, max_span_bytes=max_span_bytes)
            for (pos, _), rec in zip(items, recs):
                out[pos] = rec
        return out  # type: ignore[return-value]
