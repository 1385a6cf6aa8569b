"""The reference's CRC32C and RS(12,4) against known vectors, an
independent bitwise GF(2^8), and the program's own CPU codec."""

import itertools

import numpy as np
import pytest
import torch

from portbench.reference import crc32c, rs


@pytest.mark.parametrize("data, want", [
    (b"123456789", 0xE3069283),
    (bytes(32), 0x8A9136AA),            # RFC 3720 B.4
    (b"\xff" * 32, 0x62A8AB43),
    (bytes(range(32)), 0x46DD794E),
    (bytes(range(31, -1, -1)), 0x113FDB5C),
    (b"", 0),
])
def test_crc32c_known_vectors(data, want):
    assert crc32c.crc32c_bytes(data) == want
    assert crc32c.crc32c_many([data]) == [want]


@pytest.mark.parametrize("length", [1, 255, 256, 257, 4095, 65536, 100003])
def test_crc32c_rows_equal_the_bytewise_crc(length):
    rng = np.random.default_rng(length)
    rows = rng.integers(0, 256, (3, length), dtype=np.uint8)
    got = crc32c.crc32c_rows(torch.from_numpy(rows)).tolist()
    assert got == [crc32c.crc32c_bytes(r.tobytes()) for r in rows]


def _gf_mul_bitwise(a: int, b: int) -> int:
    """Shift-and-add product over 0x11D, sharing nothing with ``rs``."""
    out = 0
    while b:
        if b & 1:
            out ^= a
        a <<= 1
        if a & 0x100:
            a ^= 0x11D
        b >>= 1
    return out


def _gf_inv_bitwise(a: int) -> int:
    return next(x for x in range(1, 256) if _gf_mul_bitwise(a, x) == 1)


def test_parity_matrix_is_the_normalised_cauchy():
    k, m = 12, 4
    c = [[_gf_inv_bitwise(i ^ (m + j)) for j in range(k)] for i in range(m)]
    for j in range(k):
        s = _gf_inv_bitwise(c[0][j])
        for i in range(m):
            c[i][j] = _gf_mul_bitwise(c[i][j], s)
    assert rs.parity_matrix(k, m).tolist() == c
    assert rs.parity_matrix(k, m)[0].tolist() == [1] * k


def test_rs12_4_known_vector():
    """Data shard j holds bytes j*3 .. j*3+2: parity by the bitwise field."""
    k, m = 12, 4
    data = np.arange(k * 3, dtype=np.uint8).reshape(1, k, 3)
    pm = rs.parity_matrix(k, m)
    want = np.zeros((1, m, 3), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            for s in range(3):
                want[0, i, s] ^= _gf_mul_bitwise(int(pm[i, j]),
                                                 int(data[0, j, s]))
    got = rs.encode(torch.from_numpy(data), k, m).numpy()
    assert (got == want).all()
    assert got[0, 0].tolist() == list(np.bitwise_xor.reduce(data[0], axis=0))


@pytest.mark.parametrize("lost", [(0,), (11,), (12,), (0, 5), (3, 12, 15),
                                  (0, 1, 2, 3), (8, 9, 14, 15)])
def test_rs12_4_rebuilds_any_four_losses(lost):
    k, m = 12, 4
    rng = np.random.default_rng(7)
    data = torch.from_numpy(rng.integers(0, 256, (2, k, 64), dtype=np.uint8))
    shards = torch.cat([data, rs.encode(data, k, m)], dim=1)
    present = [j for j in range(k + m) if j not in lost][:k]
    got = rs.decode(present, list(lost), shards[:, present], k, m)
    assert torch.equal(got, shards[:, list(lost)])


def test_reference_equals_the_programs_cpu_codec():
    from tpu3fs_torch.ops.crc32c import crc32c_py
    from tpu3fs_torch.ops.rs import RSCode

    k, m = 12, 4
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (3, k, 4096), dtype=np.uint8)
    code = RSCode(k, m, device="cpu")
    ref = rs.encode(torch.from_numpy(data), k, m).numpy()
    assert (ref == code.encode_np(data)).all()
    rows = np.concatenate([data, ref], axis=1).reshape(-1, 4096)
    assert crc32c.crc32c_rows(torch.from_numpy(rows)).tolist() == \
        [crc32c_py(r.tobytes()) for r in rows]
    for lost in itertools.islice(itertools.combinations(range(k + m), 2), 0,
                                 120, 17):
        present = [j for j in range(k + m) if j not in lost][:k]
        shards = np.concatenate([data, ref], axis=1)
        assert (rs.decode(present, list(lost),
                          torch.from_numpy(shards[:, present]), k, m).numpy()
                == code.reconstruct_np(present, list(lost),
                                       shards[:, present])).all()
