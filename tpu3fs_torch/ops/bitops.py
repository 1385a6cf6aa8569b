"""Bit-plane pack/unpack helpers for the plain versions of the kernels, and
numpy GF(2) linear algebra for building the CRC matrices.

Counterpart of ``tpu3fs/ops/bitops.py``. The torch helpers unpack to float32
planes rather than int8: torch's ``int8 @ int8`` returns int8 (it overflows)
and CUDA has no integer matmul in torch, while a float32 product of 0/1
planes is exact as long as every sum stays below 2**24.
"""

from __future__ import annotations

import numpy as np
import torch


def _shifts(n: int, x: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=x.device)


def unpack_bits(x: torch.Tensor) -> torch.Tensor:
    """uint8 (..., k, S) -> float32 0/1 planes (..., 8k, S), LSB first per
    symbol.

    Row 8*j+t of the result is bit t of symbol row j, matching the
    GF.expand_to_bits column convention."""
    bits = (x.to(torch.int64).unsqueeze(-2) >> _shifts(8, x)[:, None]) & 1
    shape = x.shape[:-2] + (x.shape[-2] * 8, x.shape[-1])
    return bits.to(torch.float32).reshape(shape)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """0/1 (..., 8m, S) -> uint8 (..., m, S), inverse of unpack_bits."""
    shape = bits.shape[:-2] + (bits.shape[-2] // 8, 8, bits.shape[-1])
    b = bits.to(torch.int64).reshape(shape)
    weights = (1 << _shifts(8, b))[:, None]
    return (b * weights).sum(dim=-2).to(torch.uint8)


def unpack_bits_last(x: torch.Tensor) -> torch.Tensor:
    """uint8 (..., S) -> float32 0/1 (..., 8S), bit index 8*p+t (LSB first)."""
    bits = (x.to(torch.int64).unsqueeze(-1) >> _shifts(8, x)) & 1
    return bits.to(torch.float32).reshape(x.shape[:-1] + (x.shape[-1] * 8,))


def pack_u32(bits: torch.Tensor) -> torch.Tensor:
    """0/1 (..., 32) -> int64 (...) register values, LSB first.

    int64, not uint32: ``torch.uint32`` has no shifts on the CPU."""
    b = bits.to(torch.int64)
    return (b << _shifts(32, b)).sum(dim=-1)


def u32_tensor(values: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> torch.uint32 (through int32, whose cast
    from int64 wraps) so ``.numpy()`` gives the dtype the JAX codec returns."""
    return values.to(torch.int32).view(torch.uint32)


# -- numpy-side GF(2) linear algebra (set-up and gold) ----------------------

def np_mat2_mul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """GF(2) matrix product of {0,1} uint8 matrices."""
    return (A.astype(np.int64) @ B.astype(np.int64) & 1).astype(np.uint8)


def np_mat2_pow(A: np.ndarray, n: int) -> np.ndarray:
    """GF(2) matrix power by binary exponentiation."""
    result = np.eye(A.shape[0], dtype=np.uint8)
    base = A.copy()
    while n:
        if n & 1:
            result = np_mat2_mul(result, base)
        base = np_mat2_mul(base, base)
        n >>= 1
    return result


def np_u32_to_bits(v: int) -> np.ndarray:
    return ((int(v) >> np.arange(32)) & 1).astype(np.uint8)


def np_bits_to_u32(bits: np.ndarray) -> int:
    return int((bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum())
