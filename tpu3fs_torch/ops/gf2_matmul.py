"""Kernel K1: a GF(2^8) matrix applied to byte stripes, (..., k, S) -> (..., o, S).

Counterpart of ``tpu3fs/ops/pallas_rs.py`` (the Pallas kernel
``_gf2_kernel``). The matrix is the (8o, 8k) GF(2) bit matrix of
``GF.expand_to_bits`` (symbol-major; the plane-major order of the Pallas
kernel was a Mosaic layout and is not needed here), packed by
``prepare_matrix`` into (o, k, 8) bytes: byte (i, j, t) holds column 8j+t of
rows 8i..8i+7, which is the GF(2^8) product c_ij * 2^t.

``gf2_matmul`` launches a CUDA kernel of ``csrc/gf2_matmul.cu`` for a CUDA
tensor, the tensor-core one (1-bit ``mma``) where ``tensor_core_takes``
says so and the bit-sliced one otherwise, and runs ``gf2_matmul_plain``
only for a tensor on the CPU.
"""

from __future__ import annotations

import math

import torch

from tpu3fs_torch import kernels
from tpu3fs_torch.ops.bitops import pack_bits, unpack_bits

# bytes of float32 bit-planes the plain version materialises per S chunk
_PLAIN_CHUNK_BYTES = 1 << 28


def prepare_matrix(A_bits, device) -> torch.Tensor:
    """Symbol-major (8o, 8k) 0/1 bit matrix -> (o, k, 8) uint8 on device."""
    A = torch.as_tensor(A_bits).to(torch.int64)
    eight_o, eight_k = A.shape
    o, k = eight_o // 8, eight_k // 8
    blocks = A.reshape(o, 8, k, 8).permute(0, 2, 3, 1)  # (i, j, t, u)
    weights = 1 << torch.arange(8, dtype=torch.int64)
    cols = ((blocks & 1) * weights).sum(dim=-1).to(torch.uint8)
    return cols.contiguous().to(device)


def _bit_matrix(cols: torch.Tensor) -> torch.Tensor:
    """(o, k, 8) packed columns -> (8o, 8k) float32 0/1 bit matrix."""
    o, k, _ = cols.shape
    u = torch.arange(8, dtype=torch.int64, device=cols.device)
    bits = (cols.to(torch.int64)[..., None] >> u) & 1  # (i, j, t, u)
    return bits.permute(0, 3, 1, 2).reshape(8 * o, 8 * k).to(torch.float32)


def gf2_matmul_plain(cols: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: unpack to float32 bit-planes, one matmul with
    the bit matrix, mod 2, pack. Exact: each sum is at most 8k <= 2048.
    Chunked along S so the 32x float expansion stays bounded.
    ``gf2_matmul_plain.calls`` counts its calls."""
    gf2_matmul_plain.calls += 1
    o, k, _ = cols.shape
    *lead, kk, S = data.shape
    x = data.reshape(math.prod(lead), k, S)
    A = _bit_matrix(cols)
    out = torch.empty((x.shape[0], o, S), dtype=torch.uint8, device=data.device)
    step = max(1, _PLAIN_CHUNK_BYTES // max(1, x.shape[0] * 8 * k * 4))
    for s0 in range(0, S, step):
        bits = unpack_bits(x[..., s0:s0 + step])  # (B, 8k, c) float32
        acc = torch.matmul(A, bits)
        out[..., s0:s0 + step] = pack_bits(acc.to(torch.int64) & 1)
    return out.reshape(*lead, o, S)


gf2_matmul_plain.calls = 0


def tensor_core_takes(S: int, data_ptr: int) -> bool:
    """True when the tensor-core kernel takes the shape: S % 16 == 0 and a
    16-byte-aligned data base (the output is a fresh, aligned allocation).
    Every shard size ``shard_size_of`` makes is a multiple of 64; a ragged
    S or an unaligned base goes to the bit-sliced kernel."""
    return S % 16 == 0 and data_ptr % 16 == 0


def _checked(cols: torch.Tensor, data: torch.Tensor):
    o, k, eight = cols.shape
    *lead, kk, S = data.shape
    if kk != k or eight != 8:
        raise ValueError(f"matrix {tuple(cols.shape)} vs data {tuple(data.shape)}")
    if data.dtype != torch.uint8 or cols.dtype != torch.uint8:
        raise TypeError("gf2_matmul takes uint8 data and columns")
    return o, k, lead, S


def _launch(entry: str, cols: torch.Tensor, data: torch.Tensor):
    """Checks, output allocation and one launch of C entry ``entry``.
    Returns (output, launched): no launch when o, B or S is 0 (a zero grid
    is a launch error). The C entry checks the shape it takes and returns
    an error for any other."""
    o, k, lead, S = _checked(cols, data)
    if data.device.type != "cuda" or cols.device != data.device:
        raise ValueError(f"data on {data.device}, matrix on {cols.device}")
    if not (data.is_contiguous() and cols.is_contiguous()):
        raise ValueError("gf2_matmul takes contiguous tensors")
    out = torch.empty((*lead, o, S), dtype=torch.uint8, device=data.device)
    if out.numel() == 0:
        return out, False
    kernels.launch(entry, data.device, cols, data, out, math.prod(lead), k, o,
                   S)
    return out, True


def gf2_matmul(cols: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Apply prepared (o, k, 8) columns to uint8 (..., k, S) -> (..., o, S).

    A CPU tensor goes to the plain version. A CUDA tensor goes to the
    tensor-core kernel where ``tensor_core_takes`` says so, else to
    ``gf2_matmul_bitslice``; a failed launch raises.
    ``gf2_matmul.launches`` counts tensor-core launches."""
    _checked(cols, data)
    if data.device.type == "cpu":
        return gf2_matmul_plain(cols, data)
    if not tensor_core_takes(data.shape[-1], data.data_ptr()):
        return gf2_matmul_bitslice(cols, data)
    out, launched = _launch("tpu3fs_gf2_mma", cols, data)
    gf2_matmul.launches += launched
    return out


gf2_matmul.launches = 0


def gf2_matmul_bitslice(cols: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """The bit-sliced integer kernel on a CUDA tensor, any S and alignment.
    ``gf2_matmul_bitslice.launches`` counts its launches."""
    out, launched = _launch("tpu3fs_gf2_matmul", cols, data)
    gf2_matmul_bitslice.launches += launched
    return out


gf2_matmul_bitslice.launches = 0
