"""A resharded restore onto DTensor templates on 8 gloo ranks, against the
JAX package's restore onto ``NamedSharding``s of the same shape on the 8
virtual CPU devices of conftest.py.

The JAX package saves a pytree sharded over a (2, 4) mesh; its fabric is
dumped and every rank loads the dump into the port's ``Fabric`` on the
CPU (tests/torch_train_ranks.py) and restores onto DTensor templates on a
(4, 2) mesh, verified and byte-range exact. Rank r sits at mesh position
(r // 2, r % 2), as virtual device r does in the JAX mesh, and its local
tensor must equal that device's shard. A save of a DTensor on the 8-rank
mesh must raise ``NotImplementedError``. Tolerance 0."""

import pickle

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_train_ranks as ranks
import tpu3fs.ckpt as jax_ckpt
import tpu3fs.fabric as jax_fabric
from test_torch_convert import _dump
from torch_fabric_sequence import deterministic

CFG = dict(num_storage_nodes=6, num_chains=2, chunk_size=1024, ec_k=4,
           ec_m=2)
# leaf -> (global shape, saved spec on the (2, 4) mesh, target spec on the
# (4, 2) mesh), specs as tuples of axis names per dim
LEAVES = {
    "w": ((16, 8), ("dp", None), ("chain", "dp")),
    "b": ((8,), ("chain",), ("dp",)),
    "e": ((16, 4), ("chain", "dp"), (("dp", "chain"), None)),
    "r": ((4, 6), ("dp",), ()),
    "m": ((8, 8), (("dp", "chain"),), (None, "chain")),
}


def _mesh(shape):
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices (see conftest.py)")
    return Mesh(np.array(devs[:8]).reshape(shape), ("dp", "chain"))


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt8")
    src, dst = _mesh((2, 4)), _mesh((4, 2))
    rng = np.random.default_rng(8)
    values = {k: rng.standard_normal(shape).astype(np.float32)
              for k, (shape, _, _) in LEAVES.items()}
    with deterministic(seed=6):
        fab = jax_fabric.Fabric(jax_fabric.SystemSetupConfig(**CFG))
        mgr = jax_ckpt.CheckpointManager(fab.meta, fab.file_client(),
                                         kv=fab.kv)
        mgr.save({k: jax.device_put(v, NamedSharding(src, P(*LEAVES[k][1])))
                  for k, v in values.items()}, 3)
        like = {k: jax.ShapeDtypeStruct(shape, np.float32,
                                        sharding=NamedSharding(dst, P(*spec)))
                for k, (shape, _, spec) in LEAVES.items()}
        want = {mode: mgr.restore(3, like=like, verify=verify)
                for mode, verify in (("verified", True), ("ranged", False))}
        (root / "dump.pkl").write_bytes(pickle.dumps({
            "dump": _dump(fab), "cfg": CFG, "step": 3,
            "specs": {k: (shape, spec)
                      for k, (shape, _, spec) in LEAVES.items()}}))
        manifest = mgr.manifest(3)
        fab.close()
    return values, want, manifest, ranks.spawn("ckpt", root)


def test_saved_on_more_shards_than_restored(restored):
    _, _, manifest, _ = restored
    per_leaf = {l.key: len(manifest.shards_of_leaf(i))
                for i, l in enumerate(manifest.leaves)}
    assert per_leaf == {"w": 2, "b": 4, "e": 8, "r": 2, "m": 8}
    assert manifest.mesh == {"dp": 2, "chain": 4}


@pytest.mark.parametrize("mode", ["verified", "ranged"])
@pytest.mark.parametrize("key", sorted(LEAVES))
def test_rank_local_equals_device_shard(restored, mode, key):
    values, want, _, outs = restored
    arr = want[mode][key]
    assert arr.sharding.spec == P(*LEAVES[key][2])
    devs = jax.devices()[:8]
    shards = {sh.device: sh for sh in arr.addressable_shards}
    for r, out in enumerate(outs):
        sh = shards[devs[r]]
        assert np.array_equal(out[f"{mode}_{key}"], np.asarray(sh.data)), \
            f"rank {r}"
        assert np.array_equal(np.asarray(sh.data), values[key][sh.index])


def test_multi_rank_dtensor_save_raises(restored):
    *_, outs = restored
    assert all(bool(out["save_raised"]) for out in outs)
