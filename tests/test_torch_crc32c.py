"""BatchCrc32c's port (tpu3fs_torch.ops.crc32c) against tpu3fs.ops.crc32c on
the CPU: the traceable JAX form BatchCrc32c.compute and the scalar
crc32c_py. Tolerance 0: the outputs are checksums."""

import importlib

import numpy as np
import pytest
import torch

from tpu3fs_torch.ops import crc32c as tcrc

# the module, not the function tpu3fs.ops re-exports under the same name
jcrc = importlib.import_module("tpu3fs.ops.crc32c")


def _port(bc, chunks: np.ndarray) -> np.ndarray:
    out = bc(torch.from_numpy(chunks))
    assert out.dtype == torch.uint32
    return out.numpy()


@pytest.mark.parametrize("size,block", [(512, 512), (4096, 512), (8192, 1024),
                                        (192, 192)])
def test_batch_matches_jax_and_scalar(size, block):
    rng = np.random.default_rng(13)
    chunks = rng.integers(0, 256, (4, size)).astype(np.uint8)
    want = np.asarray(jcrc.BatchCrc32c(size, block).compute(chunks))
    got = _port(tcrc.BatchCrc32c(size, block, device="cpu"), chunks)
    assert got.dtype == np.uint32
    assert np.array_equal(got, want)
    scalar = [tcrc.crc32c_py(c.tobytes()) for c in chunks]
    assert got.tolist() == scalar
    assert scalar == [jcrc.crc32c_py(c.tobytes()) for c in chunks]


@pytest.mark.parametrize("size,block", [(1024, 256), (192, 192)])
def test_zero_and_ones_rows(size, block):
    chunks = np.stack([np.zeros(size, dtype=np.uint8),
                       np.full(size, 0xFF, dtype=np.uint8)])
    got = _port(tcrc.BatchCrc32c(size, block, device="cpu"), chunks)
    assert got[0] == jcrc.crc32c_py(b"\x00" * size)
    assert got[1] == jcrc.crc32c_py(b"\xff" * size)
    assert np.array_equal(got, np.asarray(
        jcrc.BatchCrc32c(size, block).compute(chunks)))


def test_known_vectors():
    assert tcrc.crc32c_py(b"") == 0
    assert tcrc.crc32c_py(b"123456789") == 0xE3069283
    assert tcrc.crc32c_py(b"\x00" * 32) == 0x8A9136AA
    assert tcrc.crc32c_py(b"\xff" * 32) == 0x62A8AB43
    data = b"hello world, this is tpu3fs"
    assert tcrc.crc32c_py(data[10:], tcrc.crc32c_py(data[:10])) == tcrc.crc32c_py(data)
    bc = tcrc.BatchCrc32c(9, 9, device="cpu")
    row = np.frombuffer(bytearray(b"123456789"), dtype=np.uint8)[None]
    assert _port(bc, row).tolist() == [0xE3069283]


def test_matrices_match():
    for blk in (192, 512):
        assert np.array_equal(tcrc._block_matrix(blk), jcrc._block_matrix(blk))
    assert np.array_equal(tcrc._byte_shift_matrix(), jcrc._byte_shift_matrix())
    j, t = jcrc.BatchCrc32c(4096, 512), tcrc.BatchCrc32c(4096, 512, device="cpu")
    assert np.array_equal(t._ks, j._ks) and np.array_equal(t._b_t, j._b_t)
    assert t._const == int(j._const)


def test_shift_columns_pack_the_shift_matrices():
    t = tcrc.BatchCrc32c(2048, 512, device="cpu")
    cols = t._ks_cols.numpy().view(np.uint32)
    assert cols.shape == (4, 32)
    for j in range(4):
        for col in range(32):
            bits = (int(cols[j, col]) >> np.arange(32)) & 1
            assert np.array_equal(bits, t._ks[j, :, col])


def test_bad_block_raises():
    with pytest.raises(ValueError):
        tcrc.BatchCrc32c(1000, 512, device="cpu")
    with pytest.raises(ValueError):
        tcrc.BatchCrc32c(512, 512, device="cpu")(torch.zeros((2, 256), dtype=torch.uint8))


def test_scalar_crc_matches_jax():
    rng = np.random.default_rng(21)
    for n in (0, 1, 9, 100, 4096):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tcrc.crc32c(data) == jcrc.crc32c(data)
        assert tcrc.crc32c(data[n // 2:], tcrc.crc32c(data[:n // 2])) == \
            jcrc.crc32c(data)


LENGTHS = [0, 1, 3, 4, 100, 512, 4093, 1 << 20]


@pytest.mark.parametrize("length", LENGTHS)
def test_crc32c_zeros_matches_jax(length):
    assert tcrc.crc32c_zeros(length) == jcrc.crc32c_zeros(length)
    if length <= 4096:
        assert tcrc.crc32c_zeros(length) == tcrc.crc32c_py(b"\x00" * length)


@pytest.mark.parametrize("len_a,len_b", [(0, 0), (0, 7), (7, 0), (13, 100),
                                         (512, 4093)])
def test_crc32c_combine_matches_jax(len_a, len_b):
    rng = np.random.default_rng(len_a * 7 + len_b)
    a = rng.integers(0, 256, len_a, dtype=np.uint8).tobytes()
    b = rng.integers(0, 256, len_b, dtype=np.uint8).tobytes()
    ca, cb = tcrc.crc32c(a), tcrc.crc32c(b)
    got = tcrc.crc32c_combine(ca, cb, len_b)
    assert got == jcrc.crc32c_combine(ca, cb, len_b)
    assert got == tcrc.crc32c_py(a + b)


@pytest.mark.parametrize("length", [0, 1, 5, 256, 1000])
def test_crc32c_xor_matches_jax(length):
    rng = np.random.default_rng(length + 3)
    a = rng.integers(0, 256, length, dtype=np.uint8)
    b = rng.integers(0, 256, length, dtype=np.uint8)
    ca, cb = tcrc.crc32c(a.tobytes()), tcrc.crc32c(b.tobytes())
    got = tcrc.crc32c_xor(ca, cb, length)
    assert got == jcrc.crc32c_xor(ca, cb, length)
    assert got == tcrc.crc32c_py((a ^ b).tobytes())
