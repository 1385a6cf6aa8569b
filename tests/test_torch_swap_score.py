"""The swap scorer (tpu3fs_torch.ops.swap_score, kernel K5's plain
version) against the JAX package's scorer on the materialised proposals,
and the split of the solver's proposal step, on the CPU. Tolerance 0: every
score, table and generator state equal. The kernels themselves are held
against these plain versions by tests/test_torch_gpu_kernels.py, on a
card."""

import numpy as np
import pytest
import torch

import tpu3fs_torch.placement.solver as port_solver
from test_torch_placement import _jax_scores
from tpu3fs_torch.ops.placement_score import score_batch_plain
from tpu3fs_torch.ops.swap_score import (gram_np, swap_apply,
                                         swap_apply_plain, swap_score,
                                         swap_score_plain, swap_state)


def _table(b, v, k, seed):
    """(b, v) int8: each row k distinct nodes drawn from a seed."""
    rng = np.random.default_rng(seed)
    M = np.zeros((b, v), dtype=np.int8)
    M[np.arange(b)[:, None], rng.random((b, v)).argsort(axis=1)[:, :k]] = 1
    return M


def _racks(v, n_dom):
    return (np.arange(v) * n_dom // v).astype(np.int32)


def _pinned_pair(b, v, k, seed):
    """A table whose maximum sits on one pair, nodes 0 and 1 together in a
    third of the rows: swaps raise, keep and lower the maximum."""
    M = _table(b, v, k, seed)
    rows = np.arange(0, b, 3)
    M[rows] = 0
    M[rows, 0] = M[rows, 1] = 1
    M[rows[:, None], 2 + (rows[:, None] + np.arange(k - 2)) % (v - 2)] = 1
    return M


def _duplicated(b, v, k, seed):
    """Rows in identical pairs: a draw of both rows of a pair is invalid."""
    return np.repeat(_table(b // 2, v, k, seed), 2, axis=0)


# name -> (table, domain index or None, cap, P)
CASES = {
    "k3": (_table(60, 30, 3, 1), None, 0, 64),
    "k16": (_table(40, 20, 16, 2), None, 0, 64),
    "k3_racks": (_table(60, 30, 3, 3), _racks(30, 6), 1, 64),
    "k16_racks": (_table(30, 36, 16, 4), _racks(36, 9), 2, 64),
    "k16_tight_cap": (_table(30, 36, 16, 5), _racks(36, 9), 1, 64),
    "one_domain_per_node": (_table(40, 12, 4, 6), np.arange(12, dtype=np.int32), 1, 64),
    "invalid": (_duplicated(8, 10, 4, 7), None, 0, 64),
    "invalid_racks": (_duplicated(8, 10, 4, 8), _racks(10, 5), 1, 64),
    "k1": (_table(30, 12, 1, 9), None, 0, 64),
    "k1_racks": (_table(30, 12, 1, 10), _racks(12, 4), 0, 64),
    "max_ties": (port_solver._greedy_incidence(port_solver.PlacementProblem(
        num_nodes=30, group_size=3, targets_per_node=6)), None, 0, 64),
    "max_pinned": (_pinned_pair(30, 9, 3, 11), None, 0, 256),
    "ssq_past_2_31": (_table(20000, 16, 8, 12), None, 0, 8),
}


def _moves(M, seed, P):
    moves = port_solver._propose_moves(M, np.random.default_rng(seed), P)
    return moves, torch.from_numpy(np.stack(moves).astype(np.int32))


@pytest.mark.parametrize("name", sorted(CASES))
def test_swap_score_plain_matches_jax(name):
    M, dom, cap, P = CASES[name]
    state = swap_state(M, dom, cap, "cpu")
    moves, moves_t = _moves(M, seed=len(name), P=P)
    got = swap_score_plain(state, moves_t)
    assert got.dtype == torch.int32 and got.shape == (3, P)
    cand = port_solver._materialise(M, moves)
    want = _jax_scores(cand, dom, cap)
    for row, w in zip(got, want):
        assert np.array_equal(row.numpy(), w)
    full = score_batch_plain(torch.from_numpy(cand),
                             None if dom is None else torch.from_numpy(dom),
                             cap)
    assert torch.equal(got, torch.stack(full))
    # what each case is there to exercise
    over0, mx, ssq0 = (int(x) for x in state.score)
    if name.startswith("invalid"):
        assert 0 < (~moves.valid).sum() < P
    if name == "k16_tight_cap":
        assert over0 > 0 and len(set(want[0].tolist())) > 2
    if name == "max_ties":
        assert int(state.hist[mx]) > 1
    if name == "max_pinned":
        assert int(state.hist[mx]) == 1
        assert set(want[1].tolist()) == {mx - 1, mx, mx + 1}
    if name == "ssq_past_2_31":
        assert ssq0 >= 1 << 31 and (want[2] != ssq0).all()


@pytest.mark.parametrize("b,v,k,P", [(60, 30, 3, 64), (8, 10, 4, 16),
                                     (40, 20, 16, 128), (30, 12, 1, 32)])
def test_materialise_of_propose_moves_is_the_jax_proposal_step(b, v, k, P):
    """The JAX package's inline proposal step (tpu3fs/placement/solver.py
    :232-250) from the same generator state: the same proposals, and the
    generator left in the same state."""
    M = _table(b, v, k, seed=b + v) if b > 8 else _duplicated(b, v, k, 1)
    rng_jax, rng_port = np.random.default_rng(5), np.random.default_rng(5)

    cand = np.repeat(M[None, :, :], P, axis=0)
    g1 = rng_jax.integers(0, b, P)
    g2 = (g1 + rng_jax.integers(1, b, P)) % b
    rows1 = M[g1].astype(bool)
    rows2 = M[g2].astype(bool)
    only1 = rows1 & ~rows2
    only2 = rows2 & ~rows1
    valid = only1.any(axis=1) & only2.any(axis=1)
    noise_a = np.where(only1, rng_jax.random((P, v)), -1.0)
    noise_c = np.where(only2, rng_jax.random((P, v)), -1.0)
    a = noise_a.argmax(axis=1)
    c = noise_c.argmax(axis=1)
    pi = np.nonzero(valid)[0]
    cand[pi, g1[pi], a[pi]] = 0
    cand[pi, g1[pi], c[pi]] = 1
    cand[pi, g2[pi], c[pi]] = 0
    cand[pi, g2[pi], a[pi]] = 1

    got = port_solver._materialise(M, port_solver._propose_moves(M, rng_port, P))
    assert got.dtype == cand.dtype and got.tobytes() == cand.tobytes()
    assert rng_port.bit_generator.state == rng_jax.bit_generator.state
    assert rng_port.random() == rng_jax.random()


def _assert_state_equal(state, fresh):
    for name in ("M", "G", "hist", "counts", "dom", "score"):
        got, want = getattr(state, name), getattr(fresh, name)
        assert (got is None) == (want is None), name
        if got is not None:
            assert torch.equal(got, want), name


APPLY_CASES = {
    "domain_blind": (_table(48, 24, 4, 20), None, 0, 300),
    "racks": (_table(48, 24, 4, 21), _racks(24, 6), 1, 300),
    "ssq_past_2_31": (_table(20000, 16, 8, 22), None, 0, 20),
}


@pytest.mark.parametrize("name", sorted(APPLY_CASES))
def test_swap_apply_plain_keeps_the_state_a_fresh_build(name):
    """Random accepted moves through the plain apply: after each, M, G,
    hist, the counts and the scores equal a fresh build from the table,
    and the scores equal what the scorer gave the move."""
    M, dom, cap, n_moves = APPLY_CASES[name]
    M = M.copy()
    state = swap_state(M, dom, cap, "cpu")
    rng = np.random.default_rng(len(name))
    maxes = set()
    for _ in range(n_moves):
        moves = port_solver._propose_moves(M, rng, 4)
        p = int(np.argmax(moves.valid))
        assert moves.valid[p]
        moves_t = torch.from_numpy(np.stack(moves).astype(np.int32))
        scored = swap_score_plain(state, moves_t)[:, p]
        swap_apply_plain(state, moves_t, p)
        g1, g2, a, c = (int(x[p]) for x in moves[:4])
        M[g1, a], M[g1, c], M[g2, c], M[g2, a] = 0, 1, 0, 1
        fresh = swap_state(M, dom, cap, "cpu")
        _assert_state_equal(state, fresh)
        over, mx, ssq = (int(x) for x in fresh.score)
        assert scored.tolist() == [over, mx, np.int64(ssq).astype(np.int32)]
        maxes.add(mx)
    assert len(maxes) > 1 or name == "ssq_past_2_31"


def test_swap_apply_leaves_the_state_alone_for_a_move_that_does_not_fit():
    M = _duplicated(8, 10, 4, 3)
    state = swap_state(M, _racks(10, 5), 1, "cpu")
    fresh = swap_state(M, _racks(10, 5), 1, "cpu")
    moves, moves_t = _moves(M, seed=1, P=32)
    invalid = int(np.argmin(moves.valid))
    assert not moves.valid[invalid]
    swap_apply(state, moves_t, invalid)
    _assert_state_equal(state, fresh)
    valid = int(np.argmax(moves.valid))
    swap_apply(state, moves_t, valid)
    applied = swap_state(port_solver._materialise(M, moves)[valid],
                         _racks(10, 5), 1, "cpu")
    _assert_state_equal(state, applied)
    swap_apply(state, moves_t, valid)  # a second time: it no longer fits
    _assert_state_equal(state, applied)


def test_swap_kernels_on_cpu_take_the_plain_versions():
    M = _table(20, 10, 3, 4)
    state = swap_state(M, device="cpu")
    moves, moves_t = _moves(M, seed=2, P=8)
    counts = (swap_score_plain.calls, swap_score.launches,
              swap_apply_plain.calls, swap_apply.launches)
    got = swap_score(state, moves_t)
    assert torch.equal(got, swap_score_plain(state, moves_t))
    swap_apply(state, moves_t, int(np.argmax(moves.valid)))
    assert (swap_score_plain.calls, swap_score.launches,
            swap_apply_plain.calls, swap_apply.launches) == (
        counts[0] + 2, counts[1], counts[2] + 1, counts[3])
    empty = swap_score(state, torch.zeros((5, 0), dtype=torch.int32))
    assert empty.shape == (3, 0) and empty.dtype == torch.int32


def test_swap_wrappers_reject_what_the_kernels_do_not_take():
    M = _table(20, 10, 3, 4)
    state = swap_state(M, device="cpu")
    _, moves_t = _moves(M, seed=2, P=8)
    with pytest.raises(TypeError):
        swap_score(state, moves_t.to(torch.int64))
    with pytest.raises(TypeError):
        swap_score(state, moves_t[:4])
    with pytest.raises(ValueError, match="moves on"):
        swap_score(state, torch.empty((5, 8), dtype=torch.int32,
                                      device="meta"))
    with pytest.raises(IndexError):
        swap_apply(state, moves_t, 8)
    with pytest.raises(TypeError):
        swap_state(M.astype(np.int32), device="cpu")
    with pytest.raises(ValueError, match="0/1"):
        swap_state(2 * M, device="cpu")
    with pytest.raises(ValueError, match="domain_of_node"):
        swap_state(M, np.zeros(9, dtype=np.int32), 1, "cpu")
    bad = swap_state(M, device="cpu")
    bad.G = bad.G.to(torch.int64)
    with pytest.raises(TypeError, match="state.G"):
        swap_score(bad, moves_t)


def test_swap_state_is_the_gram_of_the_table():
    M = _table(50, 20, 5, 13)
    dom = _racks(20, 4)
    state = swap_state(M, dom, 1, "cpu")
    C = gram_np(M)
    off = C - np.diag(np.diag(C))
    assert np.array_equal(state.G.numpy(), off)
    pairs = off[np.triu_indices(20, 1)]
    assert state.hist.sum() == pairs.size
    assert np.array_equal(state.hist.numpy()[:pairs.max() + 1],
                          np.bincount(pairs))
    counts = M.astype(np.int64) @ np.eye(4, dtype=np.int64)[dom]
    assert np.array_equal(state.counts.numpy(), counts)
    over = int(np.maximum(counts - 1, 0).sum())
    assert state.score.tolist() == [over, *port_solver._score_np(M)]


def test_swap_state_takes_the_card_unless_told_otherwise():
    """``device=None`` resolves to the card, as every entry point does: with
    no card it raises, and ``device="cpu"`` builds the same state as the
    CPU default of earlier versions did."""
    M = _table(50, 20, 5, 13)
    dom = _racks(20, 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            swap_state(M, dom, 1)
    state = swap_state(M, dom, 1, device="cpu")
    assert state.device == torch.device("cpu")
    C = gram_np(M)
    onehot = np.eye(4)[dom]
    counts = (M.astype(np.float64) @ onehot).astype(np.int32)
    assert np.array_equal(state.M.numpy(), M)
    assert np.array_equal(state.G.numpy(), C - np.diag(np.diag(C)))
    assert np.array_equal(state.counts.numpy(), counts)
    assert state.cap == 1
