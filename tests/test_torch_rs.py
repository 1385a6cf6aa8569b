"""RSCode's port (tpu3fs_torch.ops.rs) against tpu3fs.ops.rs on the CPU:
the same generator, the same parity bytes, the same rebuilt shards, the same
XOR fast-path decisions. Tolerance 0: the outputs are erasure-code bytes."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3fs.ops import rs as jrs
from tpu3fs_torch.ops import rs as trs
from tpu3fs_torch.ops.xor_reduce import xor_reduce, xor_reduce_plain


@pytest.mark.parametrize("k,m", [(1, 1), (3, 1), (3, 2), (4, 0), (8, 2),
                                 (12, 4), (240, 16)])
def test_generator_and_bits_match(k, m):
    j, t = jrs.RSCode(k, m), trs.RSCode(k, m, device="cpu")
    assert np.array_equal(t.parity_matrix, j.parity_matrix)
    assert np.array_equal(t.generator, j.generator)
    assert np.array_equal(t._parity_bits, np.asarray(j._parity_bits))
    assert t._parity_bits.dtype == np.int8


@pytest.mark.parametrize("k,m", [(3, 1), (3, 2), (8, 2), (12, 4)])
def test_encode_matches_gold(k, m):
    rng = np.random.default_rng(42)
    j, t = jrs.RSCode(k, m), trs.RSCode(k, m, device="cpu")
    data = rng.integers(0, 256, (2, k, 256)).astype(np.uint8)
    gold = j.encode_np(data)
    got = t.encode(data)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), gold)
    assert np.array_equal(t.encode(torch.from_numpy(data)).numpy(), gold)
    assert np.array_equal(t.encode_np(data), gold)


def test_zero_data_zero_parity():
    t = trs.RSCode(5, 3, device="cpu")
    assert not t.encode(np.zeros((1, 5, 32), dtype=np.uint8)).any()


def _losses(k, m, rng, n_multi):
    n = k + m
    singles = [(x,) for x in range(n)]
    multi = [c for r in range(2, m + 1) for c in itertools.combinations(range(n), r)]
    rng.shuffle(multi)
    return singles + multi[:n_multi]


@pytest.mark.parametrize("k,m", [(3, 2), (12, 4)])
def test_reconstruct_every_single_and_sampled_multi_loss(k, m):
    rng = np.random.default_rng(7)
    j, t = jrs.RSCode(k, m), trs.RSCode(k, m, device="cpu")
    data = rng.integers(0, 256, (2, k, 200)).astype(np.uint8)
    shards = np.concatenate([data, j.encode_np(data)], axis=1)
    for lost in _losses(k, m, rng, 12):
        present = tuple(i for i in range(k + m) if i not in lost)[:k]
        survivors = shards[:, list(present)]
        want = j.reconstruct_np(present, lost, survivors)
        got = t.reconstruct(present, lost, survivors).numpy()
        assert np.array_equal(got, want), lost
        assert np.array_equal(got, shards[:, list(lost)]), lost
        assert np.array_equal(t.reconstruct_np(present, lost, survivors), want)


def test_xor_path_matches_jax_xor_reduce():
    rng = np.random.default_rng(5)
    j, t = jrs.RSCode(8, 2), trs.RSCode(8, 2, device="cpu")
    data = rng.integers(0, 256, (3, 8, 128), dtype=np.uint8)
    shards = np.concatenate([data, j.encode_np(data)], axis=1)
    for lost in [(3,), (8,)]:
        present = tuple(i for i in range(9) if i not in lost)
        assert t._xor_rebuild_applies(present, lost)
        assert t.reconstruct_fn(present, lost) is xor_reduce
        survivors = shards[:, list(present)]
        want = np.asarray(jrs._xor_reduce_shards(jnp.asarray(survivors)))
        got = t.reconstruct(present, lost, survivors).numpy()
        assert np.array_equal(got, want)
        assert np.array_equal(got, shards[:, list(lost)])


def test_xor_reduce_counts_its_calls():
    """K3's plain version runs once per XOR rebuild of a CPU tensor and not
    on the matrix path; the kernel's counter does not move on the CPU."""
    t = trs.RSCode(6, 3, device="cpu")
    shards = torch.from_numpy(
        np.random.default_rng(9).integers(0, 256, (2, 9, 64), dtype=np.uint8))
    before, launches = xor_reduce_plain.calls, xor_reduce.launches
    t.reconstruct(tuple(i for i in range(7) if i != 2), (2,),
                  shards[:, [0, 1, 3, 4, 5, 6]])
    assert xor_reduce_plain.calls == before + 1
    t.reconstruct((0, 1, 3, 4, 5, 7), (2,), shards[:, [0, 1, 3, 4, 5, 7]])
    assert xor_reduce_plain.calls == before + 1
    assert xor_reduce.launches == launches


@pytest.mark.parametrize("k,m", [(3, 2), (4, 2), (5, 1), (3, 0)])
def test_xor_rebuild_applies_agrees_on_every_pattern(k, m):
    j, t = jrs.RSCode(k, m), trs.RSCode(k, m, device="cpu")
    n = k + m
    for r in range(1, max(m, 1) + 1):
        for lost in itertools.combinations(range(n), r):
            rest = [i for i in range(n) if i not in lost]
            for present in itertools.combinations(rest, k):
                assert (t._xor_rebuild_applies(present, lost)
                        == j._xor_rebuild_applies(present, lost)), (present, lost)


def test_reconstruct_matrix_matches():
    j, t = jrs.RSCode(6, 3), trs.RSCode(6, 3, device="cpu")
    for lost in [(0,), (2, 7), (1, 4, 8)]:
        present = tuple(i for i in range(9) if i not in lost)[:6]
        assert np.array_equal(t._reconstruct_matrix(present, lost),
                              j._reconstruct_matrix(present, lost))


def test_bad_parameters_raise():
    for k, m in [(0, 1), (3, -1), (250, 7)]:
        with pytest.raises(ValueError):
            trs.RSCode(k, m, device="cpu")
    with pytest.raises(ValueError):
        trs.RSCode(4, 2, device="cpu").encode(np.zeros((1, 3, 8), np.uint8))


@pytest.mark.parametrize("lead,k,S", [((3,), 8, 128), ((2, 3), 5, 130),
                                      ((), 12, 64), ((4,), 1, 33)])
def test_xor_reduce_plain_matches_jax(lead, k, S):
    shards = np.random.default_rng(k + S).integers(
        0, 256, (*lead, k, S), dtype=np.uint8)
    want = np.asarray(jrs._xor_reduce_shards(jnp.asarray(shards)))
    got = xor_reduce(torch.from_numpy(shards))
    assert got.shape == (*lead, 1, S)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(xor_reduce_plain(torch.from_numpy(shards)).numpy(),
                          want)


def test_xor_reduce_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        xor_reduce(torch.zeros((2, 3, 8), dtype=torch.int32))
    for shape in [(8,), (2, 0, 8), (1, 257, 8)]:
        with pytest.raises(ValueError):
            xor_reduce(torch.zeros(shape, dtype=torch.uint8))


@pytest.mark.parametrize("k,m", [(12, 4), (6, 2)])
def test_parity_delta_matrix(k, m):
    j, t = jrs.RSCode(k, m), trs.RSCode(k, m, device="cpu")
    for jj in range(k):
        col = t.parity_delta_matrix(jj)
        assert col.shape == (m, 1) and col.dtype == np.uint8
        assert np.array_equal(col, j.parity_delta_matrix(jj))
        assert t.parity_delta_matrix(jj) is col  # cached
    for bad in (-1, k):
        with pytest.raises(ValueError):
            t.parity_delta_matrix(bad)
        with pytest.raises(ValueError):
            j.parity_delta_matrix(bad)


@pytest.mark.parametrize("k,m", [(12, 4), (6, 2)])
@pytest.mark.parametrize("acc_kind", ["numpy", "tensor"])
def test_delta_parity_and_gf_accumulate_match_jax(k, m, acc_kind):
    """Every j: the same delta rows as the JAX host path; acc updated in
    place; accumulating every data shard from zero equals encode."""
    rng = np.random.default_rng(k * 10 + m)
    j, t = jrs.RSCode(k, m), trs.RSCode(k, m, device="cpu")
    data = rng.integers(0, 256, (3, k, 200), dtype=np.uint8)
    start = rng.integers(0, 256, (3, m, 200), dtype=np.uint8)
    acc_j = start.copy()
    acc_t = start.copy() if acc_kind == "numpy" else torch.from_numpy(start.copy())
    zero = (np.zeros_like(start) if acc_kind == "numpy"
            else torch.zeros(start.shape, dtype=torch.uint8))
    for jj in range(k):
        d = data[:, jj]
        want = j.delta_parity_host(jj, d)
        got = t.delta_parity(jj, d)
        assert isinstance(got, torch.Tensor)
        assert np.array_equal(got.numpy(), want)
        before = acc_t
        contrib_j = j.gf_accumulate(jj, d, acc_j)
        contrib_t = t.gf_accumulate(jj, d, acc_t)
        assert acc_t is before  # in place, no rebinding
        assert np.array_equal(contrib_t.numpy(), contrib_j)
        got_acc = acc_t if acc_kind == "numpy" else acc_t.numpy()
        assert np.array_equal(got_acc, acc_j)
        t.gf_accumulate(jj, torch.from_numpy(d), zero)
    encoded = zero if acc_kind == "numpy" else zero.numpy()
    assert np.array_equal(encoded, j.encode_np(data))
    assert np.array_equal(encoded, t.encode(data).numpy())


def test_gf_accumulate_rejects_a_mismatched_accumulator():
    t = trs.RSCode(4, 2, device="cpu")
    with pytest.raises(ValueError):
        t.gf_accumulate(0, np.zeros((2, 64), np.uint8),
                        np.zeros((2, 3, 64), np.uint8))
