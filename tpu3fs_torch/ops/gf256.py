"""GF(2^8) arithmetic and bit-matrix expansion (numpy; set-up time only).

A copy of ``tpu3fs/ops/gf256.py``: the port imports nothing of ``tpu3fs``.
Multiplication by a constant ``c`` is a linear map on the 8 bits of the
operand, so an (m, k) GF(2^8) matrix expands to an (8m, 8k) GF(2) bit matrix;
the CUDA kernel in ``csrc/gf2_matmul.cu`` applies that bit matrix to byte
stripes. This module builds the matrices and the numpy gold paths the
kernels are held against.

Polynomial: x^8+x^4+x^3+x^2+1 (0x11D), the conventional RS-256 field.
"""

from __future__ import annotations

import functools

import numpy as np

_POLY = 0x11D


def _build_tables():
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _POLY
    exp[255:510] = exp[0:255]
    return exp, log


_EXP, _LOG = _build_tables()

# Full 256x256 multiplication table — handy for vectorized gold code.
_a = np.arange(256)
_MUL = np.zeros((256, 256), dtype=np.uint8)
_nz = _a[1:]
_MUL[1:, 1:] = _EXP[(_LOG[_nz][:, None] + _LOG[_nz][None, :]) % 255]


class GF:
    """Namespace of GF(2^8) scalar/array operations over the 0x11D field."""

    POLY = _POLY
    EXP = _EXP
    LOG = _LOG
    MUL_TABLE = _MUL

    @staticmethod
    def mul(a, b):
        """Elementwise GF multiply of uint8 arrays/scalars."""
        return _MUL[np.asarray(a, dtype=np.uint8), np.asarray(b, dtype=np.uint8)]

    @staticmethod
    def inv(a: int) -> int:
        if a == 0:
            raise ZeroDivisionError("GF(2^8) inverse of 0")
        return int(_EXP[255 - _LOG[a]])

    @staticmethod
    def div(a, b):
        b = np.asarray(b)
        if np.any(b == 0):
            raise ZeroDivisionError("GF(2^8) division by 0")
        inv_b = _EXP[255 - _LOG[b]]
        return GF.mul(a, inv_b)

    @staticmethod
    def pow(a: int, n: int) -> int:
        if a == 0:
            return 0 if n else 1
        return int(_EXP[(_LOG[a] * n) % 255])

    # -- matrices ----------------------------------------------------------
    @staticmethod
    def matmul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
        """GF(2^8) matrix product (gold-path; O(n^3) table lookups)."""
        A = np.asarray(A, dtype=np.uint8)
        B = np.asarray(B, dtype=np.uint8)
        prod = _MUL[A[:, :, None], B[None, :, :]]  # (n, k, m)
        return np.bitwise_xor.reduce(prod, axis=1)

    @staticmethod
    def mat_inv(A: np.ndarray) -> np.ndarray:
        """Gauss-Jordan inverse over GF(2^8). Raises if singular."""
        A = np.asarray(A, dtype=np.uint8)
        n = A.shape[0]
        assert A.shape == (n, n)
        aug = np.concatenate([A.copy(), np.eye(n, dtype=np.uint8)], axis=1)
        for col in range(n):
            pivot = None
            for row in range(col, n):
                if aug[row, col]:
                    pivot = row
                    break
            if pivot is None:
                raise np.linalg.LinAlgError("singular GF(2^8) matrix")
            if pivot != col:
                aug[[col, pivot]] = aug[[pivot, col]]
            inv_p = GF.inv(int(aug[col, col]))
            aug[col] = GF.mul(aug[col], inv_p)
            for row in range(n):
                if row != col and aug[row, col]:
                    aug[row] ^= GF.mul(aug[row, col], aug[col])
        return aug[:, n:]

    # -- code constructions ------------------------------------------------
    @staticmethod
    def cauchy_parity_matrix(m: int, k: int) -> np.ndarray:
        """m x k Cauchy matrix C[i,j] = 1/(x_i ^ y_j), x_i=i, y_j=m+j.

        The systematic generator [I_k; C] has the MDS property: any k rows are
        invertible, so any m erasures among k+m shards are recoverable.
        """
        if k + m > 256:
            raise ValueError("k+m must be <= 256 for GF(2^8)")
        xs = np.arange(m, dtype=np.uint8)[:, None]
        ys = (m + np.arange(k, dtype=np.uint8))[None, :]
        diff = xs ^ ys
        return _EXP[255 - _LOG[diff]].astype(np.uint8)

    # -- bit-plane expansion ----------------------------------------------
    @staticmethod
    @functools.lru_cache(maxsize=4096)
    def _const_bit_matrix(c: int) -> bytes:
        # M[u, t] = bit u of (c * 2^t); mul-by-c is GF(2)-linear on bits.
        M = np.zeros((8, 8), dtype=np.uint8)
        for t in range(8):
            prod = int(GF.mul(c, 1 << t))
            for u in range(8):
                M[u, t] = (prod >> u) & 1
        return M.tobytes()

    @staticmethod
    def const_bit_matrix(c: int) -> np.ndarray:
        return np.frombuffer(GF._const_bit_matrix(int(c)), dtype=np.uint8).reshape(8, 8)

    @staticmethod
    def expand_to_bits(A: np.ndarray) -> np.ndarray:
        """Expand an (m, k) GF(2^8) matrix into its (8m, 8k) GF(2) bit matrix.

        Bit index convention: row 8*i+u is output bit u of symbol i; column
        8*j+t is input bit t of symbol j (t = significance, LSB first).
        """
        A = np.asarray(A, dtype=np.uint8)
        m, k = A.shape
        out = np.zeros((8 * m, 8 * k), dtype=np.uint8)
        for i in range(m):
            for j in range(k):
                out[8 * i : 8 * i + 8, 8 * j : 8 * j + 8] = GF.const_bit_matrix(
                    int(A[i, j])
                )
        return out
