"""Kernels K4 (xor_fold_crc, eagerly and replayed from a CUDA graph, and
its earlier atomic form xor_fold_crc_atomic) and K5 (the full-Gram score_batch, and the
swap scorer's swap_score and swap_apply) against their plain PyTorch
versions on a CUDA card, the placement solver on the card against the
same solve on the CPU, ``crc32c_many`` (one K2 launch) against
``crc32c_py``, and the storage tier's CR and EC writes served on the card
against the same requests on the CPU. Tolerance 0.

Every test carries the ``gpu`` marker and skips without a card. The file
imports neither JAX nor the JAX package, so it runs on a machine with a
card and no JAX, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu_kernels.py
"""

import numpy as np
import pytest
import torch

from tpu3fs_torch.ops.crc32c import (BatchCrc32c, crc32c_blocks, crc32c_many,
                                     crc32c_py)
from tpu3fs_torch.ops.gf2_matmul import gf2_matmul, gf2_matmul_plain
from tpu3fs_torch.ops.placement_score import score_batch, score_batch_plain
from tpu3fs_torch.ops.stripe import get_codec
from tpu3fs_torch.ops.swap_score import (swap_apply, swap_apply_plain,
                                         swap_score, swap_score_plain,
                                         swap_state)
from tpu3fs_torch.ops.xor_fold import (xor_fold_crc, xor_fold_crc_atomic,
                                       xor_fold_crc_plain)
from tpu3fs_torch.placement import PlacementProblem, solve_placement
from tpu3fs_torch.placement.solver import _propose_moves
from torch_storage_tier import CR_CHAIN, EC_CHAIN, Tier, run_sequence


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels K4 and K5 have no CPU mode")
    return torch.device("cuda")


# K4's timing shapes (chip_smoke.py FOLD_SHAPES): the chain write batch,
# the dry run, a 4 MiB chunk's shards, one long row, ICI buckets of medium
# and small writes, a ragged S
FOLD_SHAPES = [(12, 1 << 20), (2, 128), (12, 349_696), (1, 64 << 20),
               (64, 64 << 10), (1024, 4096), (12, (1 << 20) + 3)]


def _fold_input(batch, size, offset, seed, device):
    flat = np.random.default_rng(seed).integers(
        0, 256, batch * size + offset, dtype=np.uint8)
    return torch.from_numpy(flat).to(device)[offset:].view(batch, size)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,size,offset", [
    (12, 1 << 20, 0), (5, 4096, 1), (3, 1021, 0), (3, 1022, 3), (2, 7, 0),
    (1, 0, 0), (0, 64, 0)] + [(b, s, o) for b, s in FOLD_SHAPES
                              for o in range(16)])
def test_xor_fold_crc_kernel_matches_plain(cuda_device, batch, size, offset):
    x = _fold_input(batch, size, offset, size + offset, cuda_device)
    launches = xor_fold_crc.launches
    got = xor_fold_crc(x)
    assert xor_fold_crc.launches == launches + int(batch * size > 0)
    want = xor_fold_crc_plain(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("batch,size", FOLD_SHAPES)
def test_xor_fold_crc_graph_replays_match_plain(cuda_device, batch, size):
    """One call captured in a CUDA graph, replayed three times on fresh
    inputs copied into the captured buffer."""
    static = _fold_input(batch, size, 0, 1, cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        xor_fold_crc(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = xor_fold_crc(static)
    for rep in range(3):
        static.copy_(_fold_input(batch, size, 0, 10 + rep, cuda_device))
        graph.replay()
        want = xor_fold_crc_plain(static)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("batch,size", [(1, 64 << 20), (2, 8 << 20),
                                        (12, 1 << 20)])
def test_xor_fold_crc_on_two_streams_at_once(cuda_device, batch, size):
    """Calls on two streams run at once; the grid route's workspace is the
    call's own, so neither disturbs the other."""
    xs = [_fold_input(batch, size, o, 20 + o, cuda_device) for o in (0, 5)]
    streams = [torch.cuda.Stream() for _ in xs]
    outs = []
    torch.cuda.synchronize()
    for _ in range(10):
        for x, st in zip(xs, streams):
            with torch.cuda.stream(st):
                outs.append((x, xor_fold_crc(x)))
    torch.cuda.synchronize()
    for x, got in outs:
        want = xor_fold_crc_plain(x)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("batch,size,offset", [
    (b, s, o) for b, s in FOLD_SHAPES for o in (0, 1, 3, 8)])
def test_xor_fold_crc_matches_atomic_kernel(cuda_device, batch, size, offset):
    x = _fold_input(batch, size, offset, 7 * size + offset, cuda_device)
    launches = xor_fold_crc_atomic.launches
    old = xor_fold_crc_atomic(x)
    assert xor_fold_crc_atomic.launches == launches + 1
    assert torch.equal(xor_fold_crc(x).view(torch.int32),
                       old.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("P,b,v,n_dom", [
    (1, 2, 1, None), (3, 37, 7, 3), (3, 37, 13, None), (128, 37, 180, 18),
    (1, 5760, 180, None), (3, 200, 129, 7)])
def test_score_batch_kernel_matches_plain(cuda_device, P, b, v, n_dom):
    rng = np.random.default_rng(b + v)
    Ms = torch.from_numpy((rng.random((P, b, v)) < 0.4).astype(np.int8))
    Ms = Ms.to(cuda_device)
    dom = (torch.from_numpy(rng.integers(0, n_dom, v).astype(np.int32))
           .to(cuda_device) if n_dom else None)
    launches = score_batch.launches
    got = score_batch(Ms, dom, 2)
    assert score_batch.launches == launches + 1
    for g, w in zip(got, score_batch_plain(Ms, dom, 2)):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_solve_placement_on_the_card_matches_the_cpu(cuda_device):
    p = PlacementProblem(num_nodes=20, group_size=5, targets_per_node=4,
                         chain_table_type="EC",
                         domains=[f"rack{i // 4}" for i in range(20)],
                         max_per_domain=2)
    got = solve_placement(p, steps=300, seed=4, device=cuda_device)
    want = solve_placement(p, steps=300, seed=4, device="cpu")
    assert got.tobytes() == want.tobytes()


def _table(b, v, k, seed):
    """(b, v) int8: each row k distinct nodes drawn from a seed."""
    rng = np.random.default_rng(seed)
    M = np.zeros((b, v), dtype=np.int8)
    M[np.arange(b)[:, None], rng.random((b, v)).argsort(axis=1)[:, :k]] = 1
    return M


def _racks(v, n_dom):
    return None if n_dom is None else (np.arange(v) * n_dom // v).astype(np.int32)


def _moves_on(M, rng, P, device):
    moves = _propose_moves(M, rng, P)
    return moves, torch.from_numpy(np.stack(moves).astype(np.int32)).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("b,v,k,n_dom,cap,P", [
    (5760, 180, 3, None, 0, 128), (5760, 180, 3, 18, 1, 128),
    (180, 180, 16, 18, 4, 128), (180, 180, 16, 180, 1, 3),
    (180, 180, 1, None, 0, 128), (20000, 16, 8, None, 0, 8),
    (8, 10, 4, 5, 1, 64)])
def test_swap_score_kernel_matches_plain(cuda_device, b, v, k, n_dom, cap, P):
    M = _table(b, v, k, seed=b + v + k)
    if b == 8:  # rows in identical pairs: many invalid moves
        M = np.repeat(M[:4], 2, axis=0)
    state = swap_state(M, _racks(v, n_dom), cap, cuda_device)
    _, moves = _moves_on(M, np.random.default_rng(v), P, cuda_device)
    launches = swap_score.launches
    got = swap_score(state, moves)
    assert swap_score.launches == launches + 1
    assert torch.equal(got, swap_score_plain(state, moves))


@pytest.mark.gpu
@pytest.mark.parametrize("n_dom", [None, 18])
def test_swap_apply_kernel_matches_plain(cuda_device, n_dom):
    """200 accepted moves at the EC table's shape, through the kernel and
    through the plain version: both states equal a fresh build after each."""
    M = _table(180, 180, 16, seed=3)
    dom = _racks(180, n_dom)
    kernel_state = swap_state(M, dom, 4, cuda_device)
    plain_state = swap_state(M, dom, 4, cuda_device)
    rng = np.random.default_rng(4)
    launches = swap_apply.launches
    for _ in range(200):
        moves, moves_t = _moves_on(M, rng, 4, cuda_device)
        p = int(np.argmax(moves.valid))
        swap_apply(kernel_state, moves_t, p)
        swap_apply_plain(plain_state, moves_t, p)
        g1, g2, a, c = (int(x[p]) for x in moves[:4])
        M[g1, a], M[g1, c], M[g2, c], M[g2, a] = 0, 1, 0, 1
        fresh = swap_state(M, dom, 4, cuda_device)
        for name in ("M", "G", "hist", "counts", "score"):
            want = getattr(fresh, name)
            if want is not None:
                assert torch.equal(getattr(kernel_state, name), want), name
                assert torch.equal(getattr(plain_state, name), want), name
    assert swap_apply.launches == launches + 200


@pytest.mark.gpu
@pytest.mark.parametrize("length", [0, 1, 511, 512, 513, 349_696,
                                    (1 << 20) + 3])
def test_crc32c_many_on_the_card_matches_crc32c_py(cuda_device, length):
    rng = np.random.default_rng(length)
    bufs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in (length, length // 3, 1)]
    launches = crc32c_blocks.launches
    got = crc32c_many(bufs, device=cuda_device)
    assert crc32c_blocks.launches == launches + 1
    assert got == [crc32c_py(b) for b in bufs]


@pytest.mark.gpu
def test_storage_tier_on_the_card_matches_the_cpu(cuda_device):
    """CR writes and reads, EC client-encoded and chain-encoded writes, a
    degraded read, the EC rebuild and the CR resync served by the tier on
    the card: the same replies and stored bytes as on the CPU, through K1
    and K2 with no plain call."""
    k, m, S = 4, 2, 16384
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        tier = Tier("tpu3fs_torch", k + m,
                    [(CR_CHAIN, [0, 2, 3], 0, 0, 1 << 16),
                     (EC_CHAIN, list(range(k + m)), k, m, S)], device=dev)
        counts = (gf2_matmul.launches, crc32c_blocks.launches,
                  gf2_matmul_plain.calls, BatchCrc32c.compute.calls)
        try:
            rec, _ = run_sequence(tier, get_codec(k, m, S, device=dev),
                                  seed=5, cr_chunks=4, stripes=2)
            out[dev.type] = (rec, tier.stored())
        finally:
            tier.close()
        if dev.type == "cuda":
            assert gf2_matmul.launches > counts[0]
            assert crc32c_blocks.launches > counts[1]
            assert (gf2_matmul_plain.calls, BatchCrc32c.compute.calls) \
                == counts[2:]
    assert out["cuda"] == out["cpu"]
