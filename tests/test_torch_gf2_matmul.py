"""Kernel K1's port (tpu3fs_torch.ops.gf2_matmul) against the JAX package:
the Pallas kernel in interpret mode and the einsum form rs._bit_matmul.

On the CPU the port's wrapper runs its plain version; the CUDA kernel is
held against that plain version on the card by chip_smoke.py. Tolerance 0:
the outputs are erasure-code bytes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3fs.ops import pallas_rs
from tpu3fs.ops import rs as jrs
from tpu3fs_torch.ops import gf2_matmul as tgm
from tpu3fs_torch.ops.gf256 import GF as TGF


def _port(A_bits: np.ndarray, data: np.ndarray) -> np.ndarray:
    cols = tgm.prepare_matrix(A_bits, "cpu")
    return tgm.gf2_matmul(cols, torch.from_numpy(data)).numpy()


@pytest.mark.parametrize("S", [128, 1000, 4096])
@pytest.mark.parametrize("k,m", [(3, 1), (4, 2), (6, 3), (12, 4)])
def test_encode_matches_pallas_and_einsum(k, m, S):
    rng = np.random.default_rng(100 * k + m + S)
    code = jrs.RSCode(k, m)
    A = np.asarray(code._parity_bits)
    data = rng.integers(0, 256, (2, k, S), dtype=np.uint8)
    want = np.asarray(pallas_rs.gf2_matmul(
        pallas_rs.prepare_matrix(A), jnp.asarray(data), interpret=True))
    got = _port(A, data)
    assert got.dtype == np.uint8 and got.shape == (2, m, S)
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(jrs._bit_matmul(A, data)))


@pytest.mark.parametrize("lead", [(), (2,), (2, 3)])
def test_leading_dims(lead):
    rng = np.random.default_rng(len(lead))
    code = jrs.RSCode(6, 3)
    A = np.asarray(code._parity_bits)
    data = rng.integers(0, 256, (*lead, 6, 1000), dtype=np.uint8)
    want = np.asarray(jrs._bit_matmul(A, data))
    got = _port(A, data)
    assert got.shape == (*lead, 3, 1000)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k,m", [(3, 1), (4, 2), (6, 3), (12, 4)])
def test_decode_matrices(k, m):
    """Every decode width o = 1..m, against the interpreted Pallas kernel."""
    rng = np.random.default_rng(k * m)
    code = jrs.RSCode(k, m)
    data = rng.integers(0, 256, (2, k, 1000), dtype=np.uint8)
    shards = np.concatenate([data, code.encode_np(data)], axis=1)
    for o in range(1, m + 1):
        lost = tuple(range(1, 2 * o, 2))[:o]
        present = tuple(i for i in range(k + m) if i not in lost)[:k]
        R_bits = TGF.expand_to_bits(code._reconstruct_matrix(present, lost))
        survivors = shards[:, list(present)]
        want = np.asarray(pallas_rs.gf2_matmul(
            pallas_rs.prepare_matrix(R_bits), jnp.asarray(survivors),
            interpret=True))
        got = _port(R_bits, survivors)
        assert np.array_equal(got, want), (k, m, lost)
        assert np.array_equal(got, shards[:, list(lost)])


def test_prepare_matrix_packs_gf_products():
    """Byte (i, j, t) of the prepared matrix is c_ij * 2^t in GF(2^8)."""
    rng = np.random.default_rng(3)
    C = rng.integers(0, 256, (3, 5), dtype=np.uint8)
    cols = tgm.prepare_matrix(TGF.expand_to_bits(C), "cpu").numpy()
    want = TGF.mul(C[:, :, None], (1 << np.arange(8))[None, None, :])
    assert np.array_equal(cols, want)


def test_empty_shapes_return_without_work():
    cols = tgm.prepare_matrix(np.zeros((0, 32), dtype=np.uint8), "cpu")
    out = tgm.gf2_matmul(cols, torch.zeros((2, 4, 64), dtype=torch.uint8))
    assert out.shape == (2, 0, 64)
    cols = tgm.prepare_matrix(TGF.expand_to_bits(np.ones((2, 4), np.uint8)), "cpu")
    assert tgm.gf2_matmul(cols, torch.zeros((0, 4, 64), dtype=torch.uint8)).shape == (0, 2, 64)
    assert tgm.gf2_matmul(cols, torch.zeros((3, 4, 0), dtype=torch.uint8)).shape == (3, 2, 0)


def test_cpu_tensor_never_launches():
    before = tgm.gf2_matmul.launches
    cols = tgm.prepare_matrix(TGF.expand_to_bits(np.ones((1, 3), np.uint8)), "cpu")
    tgm.gf2_matmul(cols, torch.ones((1, 3, 16), dtype=torch.uint8))
    assert tgm.gf2_matmul.launches == before


def test_rejects_bad_inputs():
    cols = tgm.prepare_matrix(TGF.expand_to_bits(np.ones((2, 4), np.uint8)), "cpu")
    with pytest.raises(ValueError):
        tgm.gf2_matmul(cols, torch.zeros((1, 3, 16), dtype=torch.uint8))
    with pytest.raises(TypeError):
        tgm.gf2_matmul(cols, torch.zeros((1, 4, 16), dtype=torch.int32))
