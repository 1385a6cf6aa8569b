"""Kernel K4's plain version (tpu3fs_torch.ops.xor_fold) and its launch
plan's byte hand-out, emulated in numpy, against
tpu3fs.parallel.chain._xor_fold_crc, on the CPU. Tolerance 0. Kernel K4
itself is held against its plain version by
tests/test_torch_gpu_kernels.py, on a card."""

import numpy as np
import pytest
import torch

from tpu3fs.parallel.chain import _xor_fold_crc as jax_xor_fold_crc
from tpu3fs_torch.ops.xor_fold import (FoldPlan, fold_pieces, fold_plan,
                                      xor_fold_crc, xor_fold_crc_plain)


def _rows(batch, size, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (batch, size)).astype(np.uint8)


@pytest.mark.parametrize("batch", [1, 12])
# 12, 1000 and 4099 fold an odd number of words at some halving
@pytest.mark.parametrize("size", [0, 4, 5, 6, 7, 12, 64, 1000, 1021, 4096,
                                  4099])
def test_xor_fold_crc_plain_matches_jax(batch, size):
    chunks = _rows(batch, size, seed=batch * 10_000 + size)
    got = xor_fold_crc_plain(torch.from_numpy(chunks))
    assert got.dtype == torch.uint32 and got.shape == (batch,)
    want = np.asarray(jax_xor_fold_crc(chunks))
    assert np.array_equal(got.view(torch.int32).numpy().view(np.uint32), want)


def test_xor_fold_crc_on_cpu_takes_the_plain_version():
    x = torch.from_numpy(_rows(3, 100, seed=1))
    calls, launches = xor_fold_crc_plain.calls, xor_fold_crc.launches
    got = xor_fold_crc(x)
    assert xor_fold_crc_plain.calls == calls + 1
    assert xor_fold_crc.launches == launches
    assert torch.equal(got.view(torch.int32),
                       xor_fold_crc_plain(x).view(torch.int32))


def test_xor_fold_crc_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        xor_fold_crc(torch.zeros((2, 8), dtype=torch.int8))
    with pytest.raises(TypeError):
        xor_fold_crc(torch.zeros((2, 3, 8), dtype=torch.uint8))


# -- the kernel's launch plan (ops/xor_fold.py fold_plan, fold_pieces) ------
# The CUDA kernel reads exactly the byte ranges fold_pieces lists, each in
# csrc/xor_fold.cu's fold_span: a head byte by byte up to the first 16-byte
# address, whole 16-byte vectors whose XORed word is rotated by the body's
# row offset mod 4, a tail byte by byte. Here that is emulated in numpy.
SWEEP_B = [0, 1, 2, 12, 1024]
SWEEP_S = [0, 1, 2, 3, 4, 5, 6, 7, 127, 128, 4099, 349_696, (1 << 20) + 3,
           (4 << 20) + 5]  # the last takes the grid route at B of 1 and 2
ALL_ROWS_UP_TO = 4 << 20  # bytes; past this a few rows are folded


def _fold_piece(row: np.ndarray, lo: int, hi: int, row_addr: int) -> int:
    """fold_span of bytes [lo, hi) of a row whose byte 0 lies at
    ``row_addr``, as the kernel computes it (one thread)."""
    length = hi - lo
    head = min((16 - (row_addr + lo) % 16) % 16, length)
    nvec = (length - head) // 16
    body = row[lo + head:lo + head + 16 * nvec]
    acc = int(np.bitwise_xor.reduce(body.view("<u4"))) if nvec else 0
    rot = 8 * ((lo + head) % 4)
    acc = ((acc << rot) | (acc >> (32 - rot))) & 0xFFFFFFFF if rot else acc
    for o in list(range(head)) + list(range(head + 16 * nvec, length)):
        acc ^= int(row[lo + o]) << (8 * ((lo + o) % 4))
    return acc


def _check_plan(plan: FoldPlan, batch: int, size: int, sms: int):
    """What the C entry and the kernels take for granted of a plan."""
    if batch * size == 0:
        assert plan.grid == 0
        return
    assert plan.route in ("rows", "cluster", "grid")
    if plan.route == "rows":
        assert plan.rows_per_cta >= 1 and plan.cluster == 1
        assert plan.grid == -(-batch // plan.rows_per_cta)
    elif plan.route == "cluster":
        assert 1 <= plan.cluster <= 16 and plan.grid % plan.cluster == 0
        assert plan.grid // plan.cluster == min(batch, 65535)
    else:
        assert plan.grid == 2 * sms and plan.cluster == 1 and batch <= 64
    assert plan.grid <= 0x7FFFFFFF


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("size", SWEEP_S)
@pytest.mark.parametrize("batch", SWEEP_B)
def test_fold_plan_covers_every_byte_once_and_folds_to_jax(batch, size, sms):
    """For base offsets 0-15: the plan's byte ranges tile every row exactly
    once, cut inside a row only between 16-byte vectors, a grid-route
    block's ranges lie in at most two neighbouring rows, and folding each
    range as the kernel does, then XOR-ing the pieces per row, equals
    tpu3fs.parallel.chain._xor_fold_crc."""
    if batch * size <= ALL_ROWS_UP_TO:
        rows = list(range(batch))
    else:
        rows = sorted({0, 1, batch // 2, batch - 1} & set(range(batch)))
    rng = np.random.default_rng(batch * 7919 + size)
    data = {b: rng.integers(0, 256, size).astype(np.uint8) for b in rows}
    want = (np.asarray(jax_xor_fold_crc(np.stack([data[b] for b in rows])))
            if rows else np.zeros(0, np.uint32))
    for base in range(16):
        plan = fold_plan(batch, size, sms)
        _check_plan(plan, batch, size, sms)
        pieces = fold_pieces(plan, batch, size, base)
        by_row = {}
        by_block = {}
        for block, b, lo, hi in pieces:
            assert 0 <= block < plan.grid and 0 <= lo <= hi <= size
            # cuts inside a row fall between 16-byte vectors
            row_addr = base + b * size
            assert lo in (0, hi) or (row_addr + lo) % 16 == 0
            assert hi in (size, lo) or (row_addr + hi) % 16 == 0
            if lo < hi:
                by_row.setdefault(b, []).append((lo, hi, block))
                by_block.setdefault(block, set()).add(b)
        for b in range(batch if size else 0):
            spans = sorted(by_row.get(b, []))
            assert spans and spans[0][0] == 0 and spans[-1][1] == size
            assert all(x[1] == y[0] for x, y in zip(spans, spans[1:]))
        assert not size or set(by_row) == set(range(batch))
        for block, touched in by_block.items():
            if plan.route == "grid":
                assert max(touched) - min(touched) <= 1 and len(touched) <= 2
            elif plan.route == "rows":
                assert all(b // plan.rows_per_cta == block for b in touched)
        got = []
        for b in rows:
            acc = 0
            for lo, hi, _ in by_row.get(b, []):
                acc ^= _fold_piece(data[b], lo, hi, base + b * size)
            got.append(acc)
        assert np.array_equal(np.array(got, dtype=np.uint32), want), (
            f"base {base}: plan {plan}")


def test_fold_plan_routes_at_the_chain_writes_shapes():
    """The routes the card takes at the shapes chip_smoke.py times (132
    SMs): the dry run's (2, 128) is one block."""
    H100 = 132
    assert fold_plan(2, 128, H100) == FoldPlan("rows", 1, 1, 2)
    assert fold_plan(12, 1 << 20, H100) == FoldPlan("cluster", 192, 16)
    assert fold_plan(12, 349_696, H100) == FoldPlan("cluster", 132, 11)
    assert fold_plan(1, 64 << 20, H100) == FoldPlan("grid", 264)
    assert fold_plan(1, 1 << 20, H100) == FoldPlan("cluster", 16, 16)
    assert fold_plan(4, 1 << 20, H100) == FoldPlan("cluster", 64, 16)
    assert fold_plan(4, 4 << 20, H100) == FoldPlan("grid", 264)
    assert fold_plan(64, 64 << 10, H100) == FoldPlan("cluster", 128, 2)
    assert fold_plan(1024, 4096, H100) == FoldPlan("rows", 128, 1, 8)
