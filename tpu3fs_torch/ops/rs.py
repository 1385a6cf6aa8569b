"""Reed-Solomon RS(k, m) erasure coding on one device.

Counterpart of ``tpu3fs/ops/rs.py``: the same systematic generator [I_k ; C]
over GF(2^8), with C the Cauchy matrix column-normalised so that parity
row 0 is all ones. Encode and every decode that is not a single-loss XOR
apply a GF(2) bit matrix through kernel K1 (``ops/gf2_matmul.py``); a single
loss covered by parity row 0 is the byte XOR of the k survivors (kernel K3,
``ops/xor_reduce.py``). The delta-parity and chain-encode hop primitives
(``delta_parity``, ``gf_accumulate``) apply one parity column through K1
with k = 1.

Layouts: data shards are (..., k, S) uint8; parity (..., m, S); a "shard
set" is the concatenation (..., k+m, S). S is the shard size in bytes.
"""

from __future__ import annotations

import threading
from typing import Sequence, Tuple

import numpy as np
import torch

from tpu3fs_torch.analytics import spans as _spans
from tpu3fs_torch.device import as_tensor, resolve_device
from tpu3fs_torch.ops.gf256 import GF
from tpu3fs_torch.ops.gf2_matmul import gf2_matmul, prepare_matrix
from tpu3fs_torch.ops.xor_reduce import xor_reduce


def _gf_apply_np(M: np.ndarray, shards: np.ndarray) -> np.ndarray:
    """Numpy gold: (r, k) GF matrix applied to (..., k, S) by table lookups."""
    shards = np.asarray(shards, dtype=np.uint8)
    *lead, k, s = shards.shape
    flat = shards.reshape(-1, k, s)
    out = np.zeros((flat.shape[0], M.shape[0], s), dtype=np.uint8)
    for i in range(M.shape[0]):
        for j in range(k):
            c = int(M[i, j])
            if c == 1:
                out[:, i, :] ^= flat[:, j, :]
            elif c:
                out[:, i, :] ^= GF.MUL_TABLE[c][flat[:, j, :]]
    return out.reshape(*lead, M.shape[0], s)


def normalized_cauchy(k: int, m: int) -> np.ndarray:
    """(m, k) parity matrix: Cauchy, columns scaled so row 0 is all ones.

    [I ; C D] stays MDS for any invertible diagonal D, and the all-ones row
    makes the dominant rebuild (one lost shard) a plain XOR."""
    cauchy = GF.cauchy_parity_matrix(m, k)
    if m >= 1:
        scale = np.array([GF.inv(int(c)) for c in cauchy[0]], dtype=np.uint8)
        cauchy = np.stack([GF.mul(row, scale) for row in cauchy],
                          axis=0).astype(np.uint8)
    return cauchy


class RSCode:
    """RS(k, m): k data shards, m parity shards, tolerates any m erasures."""

    def __init__(self, k: int, m: int, device=None):
        if k < 1 or m < 0 or k + m > 256:
            raise ValueError(f"bad RS parameters k={k} m={m}")
        pm = normalized_cauchy(k, m)
        self._setup(pm, GF.expand_to_bits(pm).astype(np.int8), device)

    @classmethod
    def from_arrays(cls, parity_matrix: np.ndarray, parity_bits: np.ndarray,
                    device=None) -> "RSCode":
        """Build from a given (m, k) parity matrix and its (8m, 8k) bits."""
        pm = np.asarray(parity_matrix, dtype=np.uint8)
        bits = np.asarray(parity_bits, dtype=np.int8)
        if not np.array_equal(GF.expand_to_bits(pm).astype(np.int8), bits):
            raise ValueError("parity_bits is not the bit matrix of parity_matrix")
        self = cls.__new__(cls)
        self._setup(pm, bits, device)
        return self

    def _setup(self, parity_matrix, parity_bits, device) -> None:
        self.device = resolve_device(device)
        self.m, self.k = parity_matrix.shape
        self.parity_matrix = parity_matrix
        self.generator = np.concatenate(
            [np.eye(self.k, dtype=np.uint8), parity_matrix], axis=0)
        self._parity_bits = parity_bits
        self._parity_cols = prepare_matrix(parity_bits, self.device)
        # per-instance caches keyed on (present, lost), and on j, filled
        # under one lock: the services' forward helpers, update workers and
        # the client's hedged reads share a codec across threads
        self._cache_lock = threading.RLock()
        self._reconstruct_mats: dict = {}
        self._reconstruct_fns: dict = {}
        self._delta_cols: dict = {}

    # -- encode ------------------------------------------------------------
    def encode(self, data) -> torch.Tensor:
        """(..., k, S) uint8 data -> (..., m, S) parity on the codec's device."""
        x = as_tensor(data, self.device)
        if x.shape[-2] != self.k:
            raise ValueError(f"data {tuple(x.shape)} for k={self.k}")
        return gf2_matmul(self._parity_cols, x.contiguous())

    def encode_np(self, data: np.ndarray) -> np.ndarray:
        """Numpy gold encode (table lookups), independent of the kernels."""
        data = np.asarray(data, dtype=np.uint8)
        if data.shape[-2] != self.k:
            raise ValueError(f"data {data.shape} for k={self.k}")
        return _gf_apply_np(self.parity_matrix, data)

    # -- delta parity (sub-stripe RMW) and chain-encode hops ---------------
    def parity_delta_matrix(self, j: int) -> np.ndarray:
        """(m, 1) parity-coefficient column of data shard j, cached: a change
        dD of shard j changes parity i by c_ij * dD."""
        return self._delta_col(j)[0]

    def _delta_col(self, j: int):
        """(column, its (m, 1, 8) K1 operand on the device), cached per j."""
        with self._cache_lock:
            cached = self._delta_cols.get(j)
            if cached is None:
                if not 0 <= j < self.k:
                    raise ValueError(f"data shard index {j} out of range")
                col = np.ascontiguousarray(self.parity_matrix[:, j:j + 1],
                                           dtype=np.uint8)
                cached = (col, prepare_matrix(GF.expand_to_bits(col),
                                              self.device))
                self._delta_cols[j] = cached
            return cached

    def delta_parity(self, j: int, delta) -> torch.Tensor:
        """Parity delta of a change on data shard j: (..., S) uint8 delta
        (D' ^ D, zero-padded to the shard size) -> (..., m, S) rows to XOR
        into the parity shards, on the codec's device. K1 with k = 1."""
        x = as_tensor(delta, self.device)
        return gf2_matmul(self._delta_col(j)[1], x.unsqueeze(-2).contiguous())

    def gf_accumulate(self, j: int, data, acc) -> torch.Tensor:
        """One chain-encode hop: XOR data shard j's contribution
        ``C[:, j] * data`` into the parity accumulator ``acc`` IN PLACE and
        return the contribution (a tensor on the codec's device).

        ``data`` is (..., S) uint8; ``acc`` is (..., m, S) uint8, a numpy
        array (written back into) or a tensor on the codec's device (updated
        there). Accumulating over j = 0..k-1 from zero gives ``encode``."""
        contrib = self.delta_parity(j, data)
        if tuple(acc.shape) != tuple(contrib.shape):
            raise ValueError(f"accumulator {tuple(acc.shape)}, contribution "
                             f"{tuple(contrib.shape)}")
        if isinstance(acc, torch.Tensor):
            as_tensor(acc, self.device).bitwise_xor_(contrib)
        else:
            np.bitwise_xor(acc, contrib.cpu().numpy(), out=acc)
        return contrib

    # -- decode ------------------------------------------------------------
    def _reconstruct_matrix(
        self, present: Tuple[int, ...], lost: Tuple[int, ...]
    ) -> np.ndarray:
        """GF matrix R (len(lost), k) with lost = R @ shards[present]."""
        key = (present, lost)
        with self._cache_lock:
            cached = self._reconstruct_mats.get(key)
            if cached is not None:
                return cached
            if len(present) != self.k:
                raise ValueError(f"{len(present)} survivors given, k={self.k}")
            sub = self.generator[list(present), :]  # (k, k)
            inv = GF.mat_inv(sub)  # data = inv @ present
            rows = [GF.matmul(self.generator[idx : idx + 1, :], inv)[0]
                    for idx in lost]
            R = np.stack(rows, axis=0)
            self._reconstruct_mats[key] = R
            return R

    def reconstruct_fn(self, present_idx: Sequence[int],
                       lost_idx: Sequence[int]):
        """Fn mapping (..., k, S) surviving shards -> (..., lost, S), cached
        per (present, lost)."""
        present = tuple(int(i) for i in present_idx)
        lost = tuple(int(i) for i in lost_idx)
        key = (present, lost)
        with self._cache_lock:
            fn = self._reconstruct_fns.get(key)
            if fn is None:
                if self._xor_rebuild_applies(present, lost):
                    # single loss covered by the all-ones parity row: the
                    # lost shard is the plain XOR of the k survivors
                    fn = xor_reduce
                else:
                    R = self._reconstruct_matrix(present, lost)
                    cols = prepare_matrix(GF.expand_to_bits(R), self.device)

                    def fn(data, _cols=cols):
                        return gf2_matmul(_cols, data.contiguous())
                self._reconstruct_fns[key] = fn
            return fn

    def _xor_rebuild_applies(self, present, lost) -> bool:
        """True when lost is one shard rebuildable from parity row 0: the
        survivors are exactly the other k-1 data shards + parity 0 (lost
        data shard), or all k data shards (lost parity 0)."""
        if len(lost) != 1 or self.m < 1:
            return False
        (x,) = lost
        if x > self.k:
            return False
        return set(present) == set(range(self.k + 1)) - {x}

    def reconstruct(self, present_idx: Sequence[int], lost_idx: Sequence[int],
                    present_shards) -> torch.Tensor:
        """Rebuild lost shards from any k surviving shards.

        present_idx: k shard indices in [0, k+m) matching present_shards rows
        present_shards: (..., k, S) uint8
        returns (..., len(lost_idx), S) uint8 on the codec's device
        """
        fn = self.reconstruct_fn(present_idx, lost_idx)
        # a host array's copy to the card blocks the host (pageable)
        with _spans.span("ec.decode", "h2d"):
            x = as_tensor(present_shards, self.device)
        with _spans.span("ec.decode", "launch"):
            return fn(x)

    def reconstruct_np(self, present_idx: Sequence[int],
                       lost_idx: Sequence[int],
                       present_shards: np.ndarray) -> np.ndarray:
        """Numpy gold reconstruction, independent of the kernels."""
        R = self._reconstruct_matrix(
            tuple(int(i) for i in present_idx), tuple(int(i) for i in lost_idx))
        return _gf_apply_np(R, present_shards)

    def __repr__(self) -> str:  # pragma: no cover
        return f"RSCode(k={self.k}, m={self.m}, device={self.device})"
