"""Kernel K3: the XOR of k shard rows, (..., k, S) uint8 -> (..., 1, S).

Counterpart of ``tpu3fs/ops/rs.py:_xor_reduce_shards``: the single-loss
rebuild, when parity row 0 (all ones) covers the lost shard. ``xor_reduce``
launches ``csrc/xor_reduce.cu`` for a CUDA tensor (one pass: each input
byte read once, each output byte written once; the kernel picks its
16-byte or byte variant by shape and alignment) and runs
``xor_reduce_plain`` only for a tensor on the CPU.
"""

from __future__ import annotations

import math

import torch

from tpu3fs_torch import kernels


def xor_reduce_plain(shards: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: k - 1 in-place XOR passes over the first row.
    ``xor_reduce_plain.calls`` counts its calls."""
    out = shards[..., 0:1, :].clone()
    for j in range(1, shards.shape[-2]):
        out.bitwise_xor_(shards[..., j:j + 1, :])
    xor_reduce_plain.calls += 1
    return out


xor_reduce_plain.calls = 0


def xor_reduce(shards: torch.Tensor) -> torch.Tensor:
    """XOR of the shard rows: uint8 (..., k, S) -> (..., 1, S), 1 <= k <= 256.

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel (a
    failed launch raises). ``xor_reduce.launches`` counts kernel launches;
    zero-size work returns without one."""
    if shards.dtype != torch.uint8:
        raise TypeError("xor_reduce takes uint8 shards")
    if shards.ndim < 2 or not 1 <= shards.shape[-2] <= 256:
        raise ValueError(f"shards {tuple(shards.shape)}: want (..., k, S), "
                         "1 <= k <= 256")
    if shards.device.type == "cpu":
        return xor_reduce_plain(shards)
    x = shards.contiguous()
    *lead, k, S = x.shape
    out = torch.empty((*lead, 1, S), dtype=torch.uint8, device=x.device)
    if out.numel():
        kernels.launch("tpu3fs_xor_reduce", x.device, x, out, math.prod(lead),
                       k, S)
        xor_reduce.launches += 1
    return out


xor_reduce.launches = 0
