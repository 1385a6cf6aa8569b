"""Kernel K4: the chain ring's stand-in checksum, (B, S) uint8 -> (B,) uint32.

Counterpart of ``tpu3fs/parallel/chain.py:_xor_fold_crc``: each row's
little-endian 32-bit words XOR-folded together, the row zero-padded to a
multiple of 4 bytes. ``xor_fold_crc`` launches ``csrc/xor_fold.cu`` for a
CUDA tensor (one launch, no memset: ``fold_plan`` sizes the grid to the
card and hands out the bytes, see the source) and runs
``xor_fold_crc_plain`` only for a tensor on the CPU.
``xor_fold_crc_atomic`` launches the earlier form of the kernel (a memset,
then blocks folding into the output with atomics); it is the yardstick
the card's checks and timings hold the new kernel against, and no caller
of the port reaches it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tpu3fs_torch import kernels

THREADS = 256        # threads a block (csrc/xor_fold.cu kThreads)
WARPS = THREADS // 32
LOADS = 8            # 16-byte loads in flight a warp's thread (16 block-wide)
# a block's least share: one round of LOADS loads per thread (32 KiB); a
# call of at most this many bytes in rows of at most CHUNK_MIN / WARPS
# bytes is one block (the small-shape route)
CHUNK_MIN = THREADS * LOADS * 16
CTAS_PER_SM = 2      # the grid the plan aims at: 2 blocks per SM
MAX_CLUSTER = 16     # the largest thread-block cluster (non-portable)
# route grid only for rows whose 16 cluster blocks would each read more
GRID_MIN_SHARE = 128 * 1024
MAX_GRID_Y = 65535
ROUTES = {"rows": 0, "cluster": 1, "grid": 2}


class FoldPlan(NamedTuple):
    """How one call is cut: ``route`` (rows, cluster or grid), ``grid``
    blocks in all, ``cluster`` blocks a row (route cluster, else 1),
    ``rows_per_cta`` whole rows a block (route rows, else 0)."""
    route: str
    grid: int
    cluster: int = 1
    rows_per_cta: int = 0


@functools.lru_cache(maxsize=1024)
def fold_plan(batch: int, size: int, sms: int) -> FoldPlan:
    """The launch of one ``xor_fold_crc`` call on (batch, size) bytes on a
    card of ``sms`` SMs (the base address moves only the byte ranges'
    cuts, ``fold_pieces``). A block's share is the call's bytes over 2
    blocks per SM, and at least CHUNK_MIN. Rows of at most share / WARPS
    bytes go whole to warps, share // size rows a block (route rows);
    longer rows are cut into ceil(size / share) parts, at most 16, one
    cluster a row (route cluster). Where 16 blocks a row would still leave over half the
    SMs idle and read over GRID_MIN_SHARE each, a cooperative grid of 2
    blocks per SM cuts the flat input by bytes instead (route grid): its
    barrier costs more than a cluster loses below that."""
    total = batch * size
    if total == 0:
        return FoldPlan("rows", 0)
    share = max(-(-total // (CTAS_PER_SM * sms)), CHUNK_MIN)
    if size * WARPS <= share:
        rows = min(batch, share // size)
        return FoldPlan("rows", -(-batch // rows), 1, rows)
    if (batch * MAX_CLUSTER >= sms // 2
            or size <= MAX_CLUSTER * GRID_MIN_SHARE):
        c = min(-(-size // share), MAX_CLUSTER)
        return FoldPlan("cluster", c * min(batch, MAX_GRID_Y), c)
    return FoldPlan("grid", CTAS_PER_SM * sms)


def _part_range(start: int, length: int, r: int, n: int):
    """Part r of n of a span of ``length`` bytes at address ``start``:
    [lo, hi) offsets into the span, cut between 16-byte vectors of its
    aligned body; part 0 takes the head, part n - 1 the tail
    (csrc/xor_fold.cu part_range)."""
    head = min((16 - start % 16) % 16, length)
    nvec = (length - head) // 16
    per = -(-nvec // n)
    lo = 0 if r == 0 else head + 16 * min(r * per, nvec)
    hi = length if r == n - 1 else head + 16 * min((r + 1) * per, nvec)
    return lo, hi


def fold_pieces(plan: FoldPlan, batch: int, size: int, base: int):
    """The byte ranges the kernel of ``plan`` reads: (block, row, lo, hi)
    for each piece of a row that one block folds, lo and hi offsets into
    the row; ``base`` is the address of byte 0 (mod 16 is enough)."""
    out = []
    if plan.grid == 0:
        return out
    if plan.route == "rows":
        for b in range(batch):
            out.append((b // plan.rows_per_cta, b, 0, size))
    elif plan.route == "cluster":
        c, gy = plan.cluster, plan.grid // plan.cluster
        for b in range(batch):
            for r in range(c):
                lo, hi = _part_range(base + b * size, size, r, c)
                out.append(((b % gy) * c + r, b, lo, hi))
    else:
        total = batch * size
        for i in range(plan.grid):
            lo, hi = _part_range(base, total, i, plan.grid)
            while lo < hi:  # cut at row ends
                b = lo // size
                end = min(hi, (b + 1) * size)
                out.append((i, b, lo - b * size, end - b * size))
                lo = end
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def xor_fold_crc_plain(chunks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a halving tree of in-place int32 XORs (torch
    has no uint32 arithmetic). ``xor_fold_crc_plain.calls`` counts its
    calls."""
    kernels.count(xor_fold_crc_plain, "calls")
    batch, size = chunks.shape
    if size == 0:  # an empty row folds to 0 (and cannot be viewed as words)
        return torch.zeros(batch, dtype=torch.int32,
                           device=chunks.device).view(torch.uint32)
    pad = (-size) % 4
    if pad:
        chunks = F.pad(chunks, (0, pad))
    words = chunks.contiguous().clone().view(torch.int32)  # offset 0: any base
    w = words.shape[1]
    while w > 1:  # fold the top half onto the bottom; an odd middle stays
        h = w // 2
        words[:, :h].bitwise_xor_(words[:, w - h:w])
        w -= h
    return words[:, 0].contiguous().view(torch.uint32)


xor_fold_crc_plain.calls = 0


def _check(chunks: torch.Tensor, name: str) -> None:
    if chunks.dtype != torch.uint8 or chunks.ndim != 2:
        raise TypeError(f"{name} takes uint8 (B, S), got "
                        f"{chunks.dtype} {tuple(chunks.shape)}")


def xor_fold_crc(chunks: torch.Tensor) -> torch.Tensor:
    """XOR fold of each row's 32-bit words: uint8 (B, S) -> uint32 (B,).

    A CPU tensor goes to the plain version; a CUDA tensor to the kernel:
    one launch and no other device operation (a failed launch raises).
    ``xor_fold_crc.launches`` counts kernel launches; zero-size work
    returns without one."""
    _check(chunks, "xor_fold_crc")
    if chunks.device.type == "cpu":
        return xor_fold_crc_plain(chunks)
    x = chunks.contiguous()
    batch, size = x.shape
    if batch == 0 or size == 0:
        return torch.zeros(batch, dtype=torch.int32,
                           device=x.device).view(torch.uint32)
    plan = fold_plan(batch, size, _sm_count(x.device.index))
    out = torch.empty(batch, dtype=torch.int32, device=x.device)
    ws = (torch.empty(2 * plan.grid, dtype=torch.int32, device=x.device)
          if plan.route == "grid" else None)
    kernels.launch("tpu3fs_xor_fold", x.device, x, out, ws, batch, size,
                   ROUTES[plan.route], plan.grid, plan.cluster,
                   plan.rows_per_cta)
    kernels.count(xor_fold_crc)
    return out.view(torch.uint32)


xor_fold_crc.launches = 0


def xor_fold_crc_atomic(chunks: torch.Tensor) -> torch.Tensor:
    """The earlier form of the kernel on a CUDA tensor (a memset, then
    atomics); the same function. Only the card's checks and timings call
    it. ``xor_fold_crc_atomic.launches`` counts its launches."""
    _check(chunks, "xor_fold_crc_atomic")
    if chunks.device.type == "cpu":
        raise RuntimeError("xor_fold_crc_atomic runs on a CUDA card only")
    x = chunks.contiguous()
    batch, size = x.shape
    out = torch.empty(batch, dtype=torch.int32, device=x.device)
    if batch:
        kernels.launch("tpu3fs_xor_fold_atomic", x.device, x, out, batch,
                       size)
        kernels.count(xor_fold_crc_atomic)
    return out.view(torch.uint32)


xor_fold_crc_atomic.launches = 0
