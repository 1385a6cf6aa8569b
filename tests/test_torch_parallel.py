"""The port's multi-device data plane (tpu3fs_torch.parallel) against
tpu3fs.parallel, on the CPU.

The JAX side runs here on the virtual CPU devices of conftest.py. The port
side runs in gloo ranks spawned once per world size (8 and 6), each rank
running every case (tests/torch_parallel_ranks.py) and saving its local
outputs; the tests assemble them into the JAX global layout and require
equal bytes. Tolerance 0."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_ranks as ranks
from tpu3fs.ops.crc32c import BatchCrc32c as JaxCrc
from tpu3fs.ops.rs import RSCode as JaxRS
from tpu3fs.parallel.chain import _xor_fold_crc as jax_xor_fold_crc
from tpu3fs.parallel.chain import chain_write_step as jax_chain_write
from tpu3fs.parallel.rebuild import rebuild_lost_shard as jax_rebuild
from tpu3fs.parallel.shuffle import shuffle_partitions as jax_shuffle
from tpu3fs_torch.entry import dryrun_chain_len
from tpu3fs_torch.ops.xor_fold import xor_fold_crc
from tpu3fs_torch.parallel import backend_for

@pytest.fixture(scope="module")
def ranks8(tmp_path_factory):
    return ranks.spawn(8, tmp_path_factory.mktemp("gloo8"))


@pytest.fixture(scope="module")
def ranks6(tmp_path_factory):
    return ranks.spawn(6, tmp_path_factory.mktemp("gloo6"))


def _jax_mesh(n: int, chain_len: int) -> Mesh:
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} virtual devices (see conftest.py)")
    return Mesh(np.array(devs[:n]).reshape(n // chain_len, chain_len),
                ("dp", "chain"))


def _assemble_chain(outs, chain_len, key):
    """Rank (dp_i, c_i)'s (1, b, ...) output -> global (chain, dp * b, ...)."""
    per = outs[0][key].shape[1]
    dp = len(outs) // chain_len
    glob = np.zeros((chain_len, dp * per) + outs[0][key].shape[2:],
                    dtype=outs[0][key].dtype)
    for r, out in enumerate(outs):
        dp_i, c_i = divmod(r, chain_len)
        glob[c_i, dp_i * per:(dp_i + 1) * per] = out[key][0]
    return glob


def _check_chain(outs, chain_len, key, data, **kw):
    n = len(outs)
    want_rep, want_ok = jax_chain_write(_jax_mesh(n, chain_len), data, **kw)
    rep = _assemble_chain(outs, chain_len, key + "_rep")
    ok = _assemble_chain(outs, chain_len, key + "_ok")
    assert np.array_equal(rep, np.asarray(want_rep))
    assert np.array_equal(ok, np.asarray(want_ok)) and ok.all()
    for pos in range(chain_len):
        assert np.array_equal(rep[pos], data), f"chain position {pos}"


def test_mesh_shapes_and_positions(ranks8):
    for c in (1, 2, 4, 8):
        for r, out in enumerate(ranks8):
            assert out[f"mesh{c}_shape"].tolist() == [8 // c, c]
            assert out[f"mesh{c}_pos"].tolist() == [r // c, r % c]


def test_mesh_divisibility_and_backend_errors(ranks8):
    for out in ranks8:
        assert out["mesh_errors"].tolist() == [True, True, True]


def test_chain_write_2x4(ranks8):
    _check_chain(ranks8, 4, "chain4", ranks.chain_data())


def test_chain_write_2x4_with_batch_crc(ranks8):
    _check_chain(ranks8, 4, "chain4crc", ranks.chain_crc_data(),
                 crc_fn=JaxCrc(512, block=512).compute)


def test_chain_write_chain_len_2(ranks8):
    _check_chain(ranks8, 2, "chain2", ranks.chain2_data())


def _check_rebuild(outs, chain_len, key, shards, rs, lost, batch_axis=None):
    corrupted = shards.copy()
    corrupted[list(lost)] = 0
    want = np.asarray(jax_rebuild(_jax_mesh(len(outs), chain_len), corrupted,
                                  rs, lost, batch_axis=batch_axis))
    assert np.array_equal(want, shards[list(lost)])
    dp = len(outs) // chain_len
    per = shards.shape[1] // dp if batch_axis else shards.shape[1]
    for r, out in enumerate(outs):
        dp_i = r // chain_len if batch_axis else 0
        assert np.array_equal(out[key], want[:, dp_i * per:(dp_i + 1) * per])
    return [int(out[key + "_xor"]) for out in outs]


def test_rebuild_one_lost_takes_the_xor(ranks8):
    calls = _check_rebuild(ranks8, 8, "rebuild1",
                           ranks.stripe_shards(6, 2, 2, 128, 1), JaxRS(6, 2), [3])
    assert calls == [1] * 8


def test_rebuild_two_lost_takes_the_matrix(ranks8):
    calls = _check_rebuild(ranks8, 8, "rebuild2",
                           ranks.stripe_shards(6, 2, 1, 64, 2), JaxRS(6, 2),
                           [0, 7])
    assert calls == [0] * 8


def test_rebuild_2d_batch_over_dp(ranks8):
    _check_rebuild(ranks8, 4, "rebuild2d", ranks.stripe_shards(3, 1, 6, 128, 4),
                   JaxRS(3, 1), [2], batch_axis="dp")


def test_rebuild_errors(ranks8):
    for out in ranks8:
        assert out["rebuild_errors"].tolist() == [True, True, True]


def test_shuffle_over_dp8(ranks8):
    data = ranks.shuffle_data(8)
    want = np.asarray(jax_shuffle(_jax_mesh(8, 1), data))
    got = np.concatenate([out["shuffle"] for out in ranks8], axis=0)
    assert np.array_equal(got, want)
    for dst in range(8):
        for src in range(8):
            assert (got[dst * 8 + src] == src * 16 + dst).all()


def test_dryrun_multichip_8_ranks(ranks8):
    assert all(out["dryrun"].tolist() == [2, 4] for out in ranks8)


def test_dryrun_multichip_6_ranks(ranks6):
    assert all(out["dryrun"].tolist() == [2, 3] for out in ranks6)


def test_chain_write_2x3(ranks6):
    _check_chain(ranks6, 3, "chain3", ranks.chain23_data())


def test_rebuild_2d_2x3(ranks6):
    calls = _check_rebuild(ranks6, 3, "rebuild2d",
                           ranks.stripe_shards(2, 1, 4, 96, 6), JaxRS(2, 1), [1],
                           batch_axis="dp")
    assert calls == [1] * 6


@pytest.mark.parametrize("size", [128, 130, 1, 7])
def test_xor_fold_crc_matches_jax(size):
    chunks = np.random.default_rng(size).integers(
        0, 256, (5, size)).astype(np.uint8)
    got = xor_fold_crc(torch.from_numpy(chunks))
    assert got.dtype == torch.uint32
    want = np.asarray(jax_xor_fold_crc(chunks))
    assert np.array_equal(got.view(torch.int32).numpy().view(np.uint32), want)



def test_backend_follows_the_device():
    assert backend_for("cuda") == "nccl"
    assert backend_for(torch.device("cuda", 1)) == "nccl"
    assert backend_for("cpu") == "gloo"
    with pytest.raises(ValueError):
        backend_for("meta")


def test_dryrun_chain_len_prefers_a_2d_mesh():
    """The choice of __graft_entry__.dryrun_multichip: dp >= 2 and chain
    >= 2 whenever the count allows, else the longest of 8, 4, 2."""
    want = {1: 1, 2: 2, 3: 1, 4: 2, 6: 3, 8: 4, 9: 3, 12: 4, 16: 4}
    assert {n: dryrun_chain_len(n) for n in want} == want
