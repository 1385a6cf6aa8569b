"""The multi-rank DTensor save: 8 gloo ranks save one pytree of DTensors
on a (2, 4) mesh into one cluster of the port's service apps, against the
JAX package's save of the same values as ``NamedSharding``s on a (2, 4)
mesh of the 8 virtual CPU devices of conftest.py.

The cluster (mgmtd, six storage apps, a meta app; RS(4,2) chains) runs in
this process over loopback; each rank (tests/torch_train_ranks.py,
``save_case``) reaches it through the port's RPC clients, builds its
local boxes as DTensors and calls ``CheckpointManager.save``. The
committed manifest must equal the JAX package's (leaves, shards with
their offsets, shapes, file names, lengths and CRCs, the mesh and the
tree), every shard file must hold the JAX package's bytes, and a restore
through the cluster must give the values back. A second save whose shard
write fails on rank 5 must raise on every rank, naming rank 5, and leave
no manifest. Tolerance 0."""

import pickle

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_train_ranks as ranks
import tpu3fs.ckpt as jax_ckpt
import tpu3fs.fabric as jax_fabric
from torch_socket_sequence import SHAPES, AppCluster
from tpu3fs_torch.ckpt import CheckpointManager
from tpu3fs_torch.ckpt.manifest import MANIFEST_NAME, step_dir, tmp_dir
from tpu3fs_torch.utils.result import FsError

SHAPE = SHAPES["ec_4_2"]
# leaf -> (global shape, spec on the (2, 4) mesh: per dim None, an axis
# name or a tuple of names; None for a plain numpy leaf)
LEAVES = {
    "w": ((16, 8), ("dp", None)),
    "b": ((8,), ("chain",)),
    "e": ((16, 4), ("chain", "dp")),
    "r": ((4, 6), ()),
    "m": ((8, 8), (("dp", "chain"),)),
    "n": ((5,), None),
}


def _values():
    rng = np.random.default_rng(18)
    return {k: (rng.standard_normal(shape).astype(np.float32)
                if spec is not None else np.arange(shape[0], dtype=np.int64))
            for k, (shape, spec) in LEAVES.items()}


def _jax_save(values):
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices (see conftest.py)")
    mesh = Mesh(np.array(devs[:8]).reshape(2, 4), ("dp", "chain"))
    fab = jax_fabric.Fabric(jax_fabric.SystemSetupConfig(
        num_storage_nodes=SHAPE["nodes"], num_chains=SHAPE["chains"],
        chunk_size=SHAPE["chunk_size"], ec_k=SHAPE["ec_k"],
        ec_m=SHAPE["ec_m"]))
    try:
        mgr = jax_ckpt.CheckpointManager(fab.meta, fab.file_client(),
                                         kv=fab.kv)
        tree = {k: (jax.device_put(v, NamedSharding(mesh,
                                                    P(*LEAVES[k][1])))
                    if LEAVES[k][1] is not None else v)
                for k, v in values.items()}
        manifest = mgr.save(tree, 3)
        return manifest, _files(fab.meta, fab.file_client(), manifest)
    finally:
        fab.close()


def _files(meta, fio, manifest) -> dict:
    """file name -> bytes, for every shard of a committed manifest."""
    out = {}
    for spec in manifest.shards:
        inode = meta.stat(f"{step_dir('/ckpt', manifest.step)}/{spec.file}")
        out[spec.file] = fio.read(inode, 0, inode.length)
    return out


def _entries(m) -> dict:
    return {"leaves": [(l.key, l.dtype, list(l.shape), list(l.spec))
                       for l in m.leaves],
            "shards": [(s.leaf, list(s.offset), list(s.shape), s.file,
                        s.length, s.crc) for s in m.shards],
            "mesh": dict(m.mesh), "tree": m.tree, "step": m.step,
            "format": m.format_version}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt_ranks")
    values = _values()
    want, want_files = _jax_save(values)
    cluster = AppCluster("tpu3fs_torch", SHAPE, app_kw={"device": "cpu"},
                         client_kw={"device": "cpu"})
    try:
        (root / "save.pkl").write_bytes(pickle.dumps({
            "mgmtd": cluster.maddr,
            "meta": (cluster.meta_app.info.hostname,
                     cluster.meta_app.info.port),
            "values": {k: (v, LEAVES[k][1]) for k, v in values.items()}}))
        outs = ranks.spawn("save", root)
        fio = cluster.file_client()
        mgr = CheckpointManager(cluster.meta, fio)
        got = mgr.manifest(3)
        files = _files(cluster.meta, fio, got)
        restored = mgr.restore(3)
        step4 = (4 in mgr.steps(), _stat(cluster.meta,
                                         f"{tmp_dir('/ckpt', 4)}/"
                                         f"{MANIFEST_NAME}"))
    finally:
        cluster.close()
    return dict(values=values, want=want, want_files=want_files, got=got,
                files=files, restored=restored, outs=outs, step4=step4)


def _stat(meta, path) -> bool:
    try:
        meta.stat(path)
        return True
    except FsError:
        return False


def test_manifest_equals_the_jax_packages(saved):
    assert _entries(saved["got"]) == _entries(saved["want"])
    per_leaf = {l.key: len(saved["got"].shards_of_leaf(i))
                for i, l in enumerate(saved["got"].leaves)}
    assert per_leaf == {"w": 2, "b": 4, "e": 8, "r": 1, "m": 8, "n": 1}


def test_every_shard_file_equals_the_jax_packages(saved):
    assert sorted(saved["files"]) == sorted(saved["want_files"])
    for name, data in saved["want_files"].items():
        assert saved["files"][name] == data, name


def test_every_rank_returned_the_committed_crcs(saved):
    crcs = [s.crc for s in saved["got"].shards]
    for r, out in enumerate(saved["outs"]):
        assert out["crcs"].tolist() == crcs, f"rank {r}"


def test_restore_gives_the_values_back(saved):
    for key, value in saved["values"].items():
        got = np.asarray(saved["restored"][key])
        assert got.dtype == value.dtype and np.array_equal(got, value), key


def test_a_failed_rank_fails_the_save_on_every_rank(saved):
    errors = [str(out["save_error"]) for out in saved["outs"]]
    assert all("shard write failed on rank 5" in e for e in errors), errors
    assert all("injected shard write failure" in e for e in errors)
    assert saved["step4"] == (False, False)
