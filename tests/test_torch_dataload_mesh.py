"""The loader's mesh mode on 8 gloo ranks, against the JAX package's
loader on a mesh of the 8 virtual CPU devices of conftest.py.

The JAX package packs a token dataset into its fabric; the fabric is
dumped and every rank loads the dump into the port's ``Fabric`` on the CPU
(tests/torch_train_ranks.py) and runs one shuffled epoch with a (4, 2)
``DeviceMesh``: each batch is a DTensor sharded ``Shard(0)`` on ``dp``.
Rank r sits at mesh position (r // 2, r % 2), as virtual device r does in
the JAX mesh; its local batch must equal that device's shard of the JAX
package's global ``jax.Array`` batch, and its ids that dp row's ids.
Tolerance 0."""

import pickle

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import torch_train_ranks as ranks
import tpu3fs.dataload as jax_dl
import tpu3fs.fabric as jax_fabric
from test_torch_convert import _dump
from torch_fabric_sequence import deterministic

CFG = dict(num_storage_nodes=3, num_chains=2, num_replicas=2,
           chunk_size=4096)
LOADER = dict(global_batch=16, seed=3, epochs=1, dtype="<i4",
              sample_shape=(64,))
SAMPLES, FILES = 96, 3


@pytest.fixture(scope="module")
def epochs(tmp_path_factory):
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices (see conftest.py)")
    mesh = Mesh(np.array(devs[:8]).reshape(4, 2), ("dp", "chain"))
    root = tmp_path_factory.mktemp("dataload8")
    rng = np.random.default_rng(12)
    recs = [rng.integers(0, 128_256, 64, dtype=np.int32).tobytes()
            for _ in range(SAMPLES)]
    per = SAMPLES // FILES
    paths = [f"/data/tok{i}.rec" for i in range(FILES)]
    with deterministic(seed=7):
        fab = jax_fabric.Fabric(jax_fabric.SystemSetupConfig(**CFG))
        fab.meta.mkdirs("/data", recursive=True)
        fio = fab.file_client()
        for i, path in enumerate(paths):
            jax_dl.pack_records(fab.meta, fio, path,
                                recs[i * per:(i + 1) * per])
        ds = jax_dl.PackedDataset(fab.meta, fio, paths)
        with jax_dl.DataLoader(ds, jax_dl.LoaderConfig(**LOADER),
                               mesh=mesh) as ld:
            want = list(ld)
        (root / "dump.pkl").write_bytes(pickle.dumps({
            "dump": _dump(fab), "cfg": CFG, "paths": paths,
            "loader": LOADER}))
        fab.close()
    return recs, want, ranks.spawn("dataload", root)


def test_jax_batches_are_dp_sharded(epochs):
    recs, want, _ = epochs
    assert len(want) == SAMPLES // LOADER["global_batch"]
    for b in want:
        assert b.data.sharding.spec == P("dp")
        host = np.asarray(b.data)
        assert [host[i].tobytes() for i in range(len(b.ids))] == \
            [recs[g] for g in b.ids]


def test_rank_ids_are_its_dp_rows(epochs):
    _, want, outs = epochs
    b = LOADER["global_batch"] // 4
    for r, out in enumerate(outs):
        dp = r // 2
        assert out["ids"].tolist() == [batch.ids[dp * b:(dp + 1) * b]
                                       for batch in want], f"rank {r}"


@pytest.mark.parametrize("rank", range(8))
def test_rank_local_batch_equals_device_shard(epochs, rank):
    recs, want, outs = epochs
    dev = jax.devices()[rank]
    local = outs[rank]["local"]
    assert local.shape == (len(want), LOADER["global_batch"] // 4, 64)
    for step, batch in enumerate(want):
        (shard,) = [s for s in batch.data.addressable_shards
                    if s.device == dev]
        assert np.array_equal(local[step], np.asarray(shard.data))
        for row, gid in zip(local[step], outs[rank]["ids"][step]):
            assert row.tobytes() == recs[gid]
