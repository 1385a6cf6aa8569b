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
        assert t.reconstruct_fn(present, lost) is trs._xor_reduce_shards
        survivors = shards[:, list(present)]
        want = np.asarray(jrs._xor_reduce_shards(jnp.asarray(survivors)))
        got = t.reconstruct(present, lost, survivors).numpy()
        assert np.array_equal(got, want)
        assert np.array_equal(got, shards[:, list(lost)])


def test_xor_reduce_counts_its_calls():
    """K3's counter moves once per XOR rebuild and not on the matrix path."""
    t = trs.RSCode(6, 3, device="cpu")
    shards = torch.from_numpy(
        np.random.default_rng(9).integers(0, 256, (2, 9, 64), dtype=np.uint8))
    before = trs._xor_reduce_shards.launches
    t.reconstruct(tuple(i for i in range(7) if i != 2), (2,),
                  shards[:, [0, 1, 3, 4, 5, 6]])
    assert trs._xor_reduce_shards.launches == before + 1
    t.reconstruct((0, 1, 3, 4, 5, 7), (2,), shards[:, [0, 1, 3, 4, 5, 7]])
    assert trs._xor_reduce_shards.launches == before + 1


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
