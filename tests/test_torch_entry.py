"""The port's flagship step (tpu3fs_torch.entry) against
__graft_entry__.entry() jitted on the CPU, codecs carried across from the
JAX objects' arrays (tpu3fs_torch.convert), and step 4 of the dry run (the
fabric EC round trip) against the JAX fabric, in this process and on four
gloo ranks. Tolerance 0."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
import torch_parallel_ranks as ranks
from tpu3fs.fabric import Fabric as JaxFabric
from tpu3fs.fabric import SystemSetupConfig as JaxConfig
from tpu3fs.ops.crc32c import BatchCrc32c as JaxCrc
from tpu3fs.ops.rs import RSCode as JaxRS
from tpu3fs.storage.types import ChunkId as JaxChunkId
from tpu3fs_torch import convert
from tpu3fs_torch.entry import entry, fabric_round_trip


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


def _jax_shard_1(chain_len: int, payload: bytes) -> bytes:
    """Shard 1 of ``payload`` written by the JAX fabric as step 4 writes
    it: one RS(chain_len - 1, 1) chain, 4 KiB chunks."""
    fab = JaxFabric(JaxConfig(num_storage_nodes=chain_len, num_chains=1,
                              chunk_size=4096, ec_k=chain_len - 1, ec_m=1))
    chain_id = fab.chain_ids[0]
    assert fab.storage_client().write_stripe(
        chain_id, JaxChunkId(1, 0), payload, chunk_size=4096).ok
    routing = fab.routing()
    t = routing.chains[chain_id].target_of_shard(1)
    node = routing.node_of_target(t.target_id).node_id
    return fab.nodes[node].service.target(t.target_id).engine.read(
        JaxChunkId(1, 0))


@pytest.mark.parametrize("chain_len", [2, 3, 4])
def test_fabric_round_trip_matches_jax_fabric(chain_len):
    got = fabric_round_trip(chain_len, np.random.default_rng(chain_len),
                            device="cpu")
    assert got["moved"] >= 1
    assert got["rebuilt"] == got["shard"] == _jax_shard_1(chain_len,
                                                          got["payload"])
    assert got["read"] == got["payload"]


def test_dryrun_multichip_runs_step4_on_gloo_ranks(tmp_path):
    outs = ranks.spawn(4, tmp_path)
    assert all(out["dryrun"].tolist() == [2, 2] for out in outs)
    for out in outs:
        payload = out["step4_payload"].tobytes()
        assert out["step4_read"].tobytes() == payload
        assert out["step4_rebuilt"].tobytes() == \
            out["step4_shard"].tobytes() == _jax_shard_1(2, payload)
        assert int(out["step4_moved"]) >= 1
