"""The port's flagship step (tpu3fs_torch.entry) against
__graft_entry__.entry() jitted on the CPU, and codecs carried across from
the JAX objects' arrays (tpu3fs_torch.convert). Tolerance 0."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from tpu3fs.ops.crc32c import BatchCrc32c as JaxCrc
from tpu3fs.ops.rs import RSCode as JaxRS
from tpu3fs_torch import convert
from tpu3fs_torch.entry import entry


def test_entry_matches_jax_entry():
    jfn, (jex,) = __graft_entry__.entry()
    jparity, jcrcs = jax.jit(jfn)(jex)
    tfn, (tex,) = entry(device="cpu")
    assert tex.device.type == "cpu"
    assert np.array_equal(tex.numpy(), np.asarray(jex))
    tparity, tcrcs = tfn(tex)
    assert tparity.shape == (4, 4, 4096) and tcrcs.shape == (4, 16)
    assert tcrcs.dtype == torch.uint32
    assert np.array_equal(tparity.numpy(), np.asarray(jparity))
    assert np.array_equal(tcrcs.numpy(), np.asarray(jcrcs))


def _arrays(rs, crc):
    return {"parity_matrix": rs.parity_matrix,
            "parity_bits": np.asarray(rs._parity_bits),
            "crc_b_t": np.asarray(crc._b_t), "crc_ks": np.asarray(crc._ks),
            "crc_const": np.uint32(crc._const)}


def test_codec_from_arrays_computes_the_same():
    k, m, S = 6, 3, 2048
    jrs, jcrc = JaxRS(k, m), JaxCrc(S, block=512)
    codec = convert.codec_from_arrays(_arrays(jrs, jcrc), device="cpu")
    assert (codec.k, codec.m, codec.shard_size) == (k, m, S)
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, (2, k, S), dtype=np.uint8)
    shards, crcs = codec.encode_batch(data)
    assert np.array_equal(shards[:, k:], jrs.encode_np(data))
    want = np.asarray(jcrc.compute(shards.reshape(-1, S)))
    assert np.array_equal(crcs.reshape(-1), want)
    present, lost = (0, 2, 3, 5, 6, 8), (1, 4, 7)
    got = codec.reconstruct_batch(present, lost, shards[:, list(present)])
    assert np.array_equal(got, jrs.reconstruct_np(
        present, lost, shards[:, list(present)]))


def test_codec_from_arrays_rejects_mismatched_bits():
    arrays = _arrays(JaxRS(4, 2), JaxCrc(512))
    arrays["parity_bits"] = np.zeros_like(arrays["parity_bits"])
    with pytest.raises(ValueError):
        convert.codec_from_arrays(arrays, device="cpu")
