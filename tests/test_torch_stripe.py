"""StripeCodec's port (tpu3fs_torch.ops.stripe) against tpu3fs.ops.stripe on
the CPU at the same (k, m, S): write, verify, degraded read, one chunk.
Tolerance 0: the outputs are erasure-code bytes and checksums."""

import numpy as np
import pytest
import torch

from tpu3fs.ops import stripe as jst
from tpu3fs_torch.ops import stripe as tst


@pytest.fixture(scope="module", params=[(4, 2, 1024), (12, 4, 4096), (6, 3, 1000)],
                ids=lambda p: "k%d-m%d-S%d" % p)
def codecs(request):
    k, m, S = request.param
    return jst.StripeCodec(k, m, S), tst.StripeCodec(k, m, S, device="cpu")


def _data(codec, b=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, codec.k, codec.shard_size), dtype=np.uint8)


def test_encode_batch(codecs):
    j, t = codecs
    data = _data(t)
    js, jc = j.encode_batch(data)
    ts, tc = t.encode_batch(data)
    assert isinstance(ts, np.ndarray) and tc.dtype == np.uint32
    assert np.array_equal(ts, js) and np.array_equal(tc, jc)
    # a tensor on the codec's device comes back as tensors there
    ts2, tc2 = t.encode_batch(torch.from_numpy(data))
    assert isinstance(ts2, torch.Tensor) and tc2.dtype == torch.uint32
    assert np.array_equal(ts2.numpy(), js) and np.array_equal(tc2.numpy(), jc)


def test_encode_parity(codecs):
    j, t = codecs
    data = _data(t, seed=1)
    jp, jc = j.encode_parity(data)
    tp, tc = t.encode_parity(data)
    assert np.array_equal(tp, jp) and np.array_equal(tc, jc)


def test_reconstruct_batch(codecs):
    j, t = codecs
    shards, _ = j.encode_batch(_data(t, seed=2))
    n = t.k + t.m
    for lost in [(0,), (t.k,), (1, n - 1), tuple(range(t.m))]:
        present = [i for i in range(n) if i not in lost][: t.k]
        want = j.reconstruct_batch(present, lost, shards[:, present])
        got = t.reconstruct_batch(present, lost, shards[:, present])
        assert np.array_equal(got, want) and np.array_equal(got, shards[:, list(lost)])


def test_crc_batch_flags_exactly_the_corrupt_shard(codecs):
    j, t = codecs
    shards, crcs = j.encode_batch(_data(t, seed=3))
    flat = shards.reshape(-1, t.shard_size).copy()
    assert np.array_equal(t.crc_batch(flat), j.crc_batch(flat))
    flat[4, 7] ^= 0x01
    bad = np.flatnonzero(t.crc_batch(flat) != crcs.reshape(-1))
    assert bad.tolist() == [4]


def test_encode_stripe_and_assemble(codecs):
    j, t = codecs
    rng = np.random.default_rng(4)
    chunk = rng.integers(0, 256, t.k * t.shard_size - 77, dtype=np.uint8).tobytes()
    js, jc = j.encode_stripe(chunk)
    ts, tc = t.encode_stripe(chunk)
    assert np.array_equal(ts, js) and np.array_equal(tc, jc)
    lost = (0, t.k)
    present = [i for i in range(t.k + t.m) if i not in lost][: t.k]
    back = t.reconstruct_batch(present, lost, ts[None, present])[0]
    full = ts.copy()
    full[list(lost)] = back
    assert t.assemble([full[i].tobytes() for i in range(t.k)], len(chunk)) == chunk


@pytest.mark.parametrize("k", [1, 3, 6, 12])
def test_shard_sizes_agree(k):
    for n in list(range(0, 2000, 37)) + [4 << 20, (4 << 20) + 1, 349_696 * 12]:
        assert tst.shard_size_of(n, k) == jst.shard_size_of(n, k)
        assert tst.aligned_shard_size(n) == jst.aligned_shard_size(n)
    assert tst.shard_size_of(4 << 20, 12) == 349_696


def test_trim_rebuilt_shard_agrees():
    S, k = 8, 3
    cases = [(b"\x01" * S, 0, {1: S, 2: 3}), (b"ab\x00\x00", 1, {0: S, 2: 0}),
             (b"\x00" * S, 2, {0: 5, 1: 0}), (b"xyz", 4, {0: S})]
    for rebuilt, j, lens in cases:
        assert (tst.trim_rebuilt_shard(rebuilt, j, lens, k, S)
                == jst.trim_rebuilt_shard(rebuilt, j, lens, k, S))


def test_get_codec_caches_per_device():
    a = tst.get_codec(4, 2, 512, device="cpu")
    assert tst.get_codec(4, 2, 512, device="cpu") is a
    assert a.device == torch.device("cpu")


def test_delta_parity(codecs):
    j, t = codecs
    rng = np.random.default_rng(8)
    for jj in (0, t.k - 1):
        delta = rng.integers(0, 256, t.shard_size, dtype=np.uint8)
        want = j.delta_parity(jj, delta)
        got = t.delta_parity(jj, delta)
        assert isinstance(got, np.ndarray) and got.shape == (t.m, t.shard_size)
        assert np.array_equal(got, want)
        assert np.array_equal(t.delta_parity(jj, delta.tobytes()), want)
        got_t = t.delta_parity(jj, torch.from_numpy(delta))
        assert isinstance(got_t, torch.Tensor)
        assert np.array_equal(got_t.numpy(), want)
    with pytest.raises(ValueError):
        t.delta_parity(0, np.zeros(t.shard_size + 1, dtype=np.uint8))


@pytest.mark.parametrize("acc_kind", ["numpy", "tensor"])
def test_hop_accumulate_matches_jax(codecs, acc_kind):
    """Trimmed payloads of ragged lengths; acc updated in place; the CRCs of
    the contribution rows; every hop from zero composes to encode."""
    j, t = codecs
    S, rng = t.shard_size, np.random.default_rng(9)
    stripes = rng.integers(0, 256, (4, t.k, S), dtype=np.uint8)
    lens = [0, 1, S // 3, S]
    acc_j = np.zeros((4, t.m, S), dtype=np.uint8)
    acc_t = acc_j.copy() if acc_kind == "numpy" else torch.from_numpy(acc_j.copy())
    trimmed = stripes.copy()
    for jj in range(t.k):
        for b, n in enumerate(lens):
            trimmed[b, jj, n:] = 0
        payloads = [stripes[b, jj, :n].tobytes() for b, n in enumerate(lens)]
        want = j.hop_accumulate(jj, payloads, acc_j)
        before = acc_t
        got = t.hop_accumulate(jj, payloads, acc_t)
        assert acc_t is before
        if acc_kind == "numpy":
            assert isinstance(got, np.ndarray) and got.dtype == np.uint32
            got_acc = acc_t
        else:
            assert got.dtype == torch.uint32
            got, got_acc = got.numpy(), acc_t.numpy()
        assert np.array_equal(got, want)
        assert np.array_equal(got_acc, acc_j)
    assert np.array_equal(got_acc, j.rs.encode_np(trimmed))


def test_hop_accumulate_rejects_bad_shapes(codecs):
    _, t = codecs
    with pytest.raises(ValueError):
        t.hop_accumulate(0, [b"x"], np.zeros((2, t.m, t.shard_size), np.uint8))
    with pytest.raises(ValueError):
        t.hop_accumulate(0, [b"x" * (t.shard_size + 1)],
                         np.zeros((1, t.m, t.shard_size), np.uint8))


def test_crc_host(codecs):
    j, t = codecs
    for n in (0, 1, 77, t.shard_size):
        shard = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
        assert t.crc_host(shard.tobytes()) == j.crc_host(shard.tobytes())
