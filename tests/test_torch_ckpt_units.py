"""The checkpoint package's host cases on the CPU, each run over both
packages (the JAX package's ``tpu3fs.ckpt`` and the port's copy): the
cases of ``tests/test_ckpt.py`` that need no sharded ``jax.Array``
(manifest units, save and restore, crash before the commit, corruption,
async barrier and failures, save sessions, retention through the trash,
EC archival, the ``ckpt`` QoS class, the monitor's recorders), with
host-array leaves. Then the port's own rules: tensor leaves and
templates, a DTensor on a one-rank mesh written as the JAX package writes
a ``NamedSharding`` leaf, bfloat16 failing where the JAX package fails,
one K2 launch a verified restore, and the card by default. Tolerance 0."""

import importlib
import threading
from datetime import timedelta
from types import SimpleNamespace
from unittest import mock

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import tpu3fs.ckpt as jax_ckpt
import tpu3fs.fabric as jax_fabric

import tpu3fs_torch.ckpt as ckpt
import tpu3fs_torch.ops.crc32c as port_crc
from tpu3fs_torch.fabric import Fabric, SystemSetupConfig

PACKAGES = ["tpu3fs", "tpu3fs_torch"]
CHUNK = 4096


def _pkg(root: str) -> SimpleNamespace:
    mods = {name: importlib.import_module(f"{root}.{path}") for name, path in (
        ("ckpt", "ckpt"), ("manifest", "ckpt.manifest"), ("saver", "ckpt.saver"),
        ("fabric", "fabric.fabric"), ("mtypes", "meta.types"),
        ("stripe", "ops.stripe"), ("target", "storage.target"),
        ("trash", "utils.trash"), ("result", "utils.result"),
        ("qos", "qos.core"), ("recorder", "monitor.recorder"))}
    pkg = SimpleNamespace(**mods)
    pkg.port = root == "tpu3fs_torch"
    return pkg


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return _pkg(request.param)


def _fabric(pkg, **kw):
    cfg = dict(num_storage_nodes=2, num_chains=2, num_replicas=2,
               chunk_size=CHUNK)
    cfg.update(kw)
    extra = {"device": "cpu"} if pkg.port else {}
    return pkg.fabric.Fabric(pkg.fabric.SystemSetupConfig(**cfg), **extra)


def _manager(pkg, fab, **kw):
    return pkg.ckpt.CheckpointManager(fab.meta, fab.file_client(), kv=fab.kv,
                                      **kw)


def _add_ec_chain(pkg, fab, chain_id=990_001, k=3, m=1, first_tid=5000):
    node_ids = sorted(fab.nodes)
    tids = []
    extra = {"device": fab.device} if pkg.port else {}
    for i in range(k + m):
        tid = first_tid + i
        nid = node_ids[i % len(node_ids)]
        fab.mgmtd.create_target(tid, node_id=nid)
        fab.nodes[nid].service.add_target(pkg.target.StorageTarget(
            tid, chain_id, engine="mem",
            chunk_size=pkg.stripe.shard_size_of(CHUNK, k), **extra))
        tids.append(tid)
    fab.mgmtd.upload_chain(chain_id, tids, ec_k=k, ec_m=m)
    fab.heartbeat_all()
    fab.tick()
    return pkg.mtypes.Layout(table_id=1, chains=[chain_id], chunk_size=CHUNK,
                             seed=1)


def _tree(rng):
    w = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32)
    return {
        "params": {"w": w, "b": b},
        "opt": [np.arange(12, dtype=np.int32).reshape(3, 4),
                (np.float64(0.125),)],
        "step_count": np.int64(7),
    }, w, b


def _assert_tree_equal(out, w, b):
    assert np.array_equal(np.asarray(out["params"]["w"]), w)
    assert np.array_equal(np.asarray(out["params"]["b"]), b)
    assert np.array_equal(out["opt"][0],
                          np.arange(12, dtype=np.int32).reshape(3, 4))
    assert isinstance(out["opt"], list) and isinstance(out["opt"][1], tuple)
    assert float(out["opt"][1][0]) == 0.125
    assert int(out["step_count"]) == 7


def _raises(pkg, code, fn, *a, **kw):
    with pytest.raises(pkg.result.FsError) as ei:
        fn(*a, **kw)
    assert ei.value.code == getattr(pkg.result.Code, code)


# -- manifest ------------------------------------------------------------------
def test_tree_skeleton_roundtrip_exact(pkg):
    mf = pkg.manifest
    tree = {"a": [1, (2, {"b": 3})], "c": 4}
    skel, leaves = mf.flatten_tree(tree)
    assert leaves == [1, 2, 3, 4]
    assert mf.unflatten_tree(skel, leaves) == tree
    rebuilt = mf.unflatten_tree(skel, ["w", "x", "y", "z"])
    assert isinstance(rebuilt["a"], list)
    assert isinstance(rebuilt["a"][1], tuple)
    assert mf.leaf_keypaths(skel) == ["a/0", "a/1/0", "a/1/1/b", "c"]


def test_non_string_dict_keys_rejected(pkg):
    _raises(pkg, "INVALID_ARG", pkg.manifest.flatten_tree, {1: "x"})


def test_step_dir_parsing(pkg):
    mf = pkg.manifest
    assert mf.parse_step("120") == 120
    assert mf.parse_step("120.tmp") is None
    assert mf.parse_staging("120.tmp") == (120, ".tmp")
    assert mf.parse_staging("120.arc") == (120, ".arc")
    assert mf.parse_staging("MANIFEST") is None


def test_overlap_box_and_runs(pkg):
    mf = pkg.manifest
    assert mf.overlap_box([0, 0], [4, 4], [2, 2], [4, 4]) == ([2, 2], [2, 2])
    assert mf.overlap_box([0], [4], [4], [4]) is None
    assert mf.contiguous_runs([0, 0], [4, 8], [0, 0], [4, 8], 4) == [(0, 128)]
    assert mf.contiguous_runs([0, 2], [4, 3], [0, 0], [4, 8], 1) == [
        (2, 3), (10, 3), (18, 3), (26, 3)]


def test_contiguous_runs_match_numpy_slicing(pkg):
    rng = np.random.default_rng(3)
    src = rng.integers(0, 255, (5, 7, 4), dtype=np.uint8)
    s_off = [2, 0, 4]
    box_off, box_shape = [3, 2, 4], [3, 4, 3]
    raw = src.tobytes()
    runs = pkg.manifest.contiguous_runs(box_off, box_shape, s_off,
                                        list(src.shape), src.itemsize)
    got = b"".join(raw[o:o + n] for o, n in runs)
    rel = tuple(slice(box_off[d] - s_off[d],
                      box_off[d] - s_off[d] + box_shape[d]) for d in range(3))
    assert got == np.ascontiguousarray(src[rel]).tobytes()


def test_manifest_serde_roundtrip_and_bytes_equal(pkg):
    mf = pkg.manifest
    m = mf.Manifest(step=5, created=1.5, mesh={"dp": 4},
                    tree='{"t":"x","i":0}')
    m.leaves.append(mf.LeafSpec("w", "<f4", [4, 4], ["dp", ""]))
    m.shards.append(mf.ShardSpec(0, [0, 0], [2, 4], "l0.s0", 32, 99))
    assert mf.Manifest.decode(m.encode()) == m
    j = jax_ckpt.manifest
    want = j.Manifest(step=5, created=1.5, mesh={"dp": 4},
                      tree='{"t":"x","i":0}',
                      leaves=[j.LeafSpec("w", "<f4", [4, 4], ["dp", ""])],
                      shards=[j.ShardSpec(0, [0, 0], [2, 4], "l0.s0", 32, 99)])
    assert m.encode() == want.encode()


def test_manifest_decode_garbage_is_ckpt_corrupt(pkg):
    _raises(pkg, "CKPT_CORRUPT", pkg.manifest.Manifest.decode,
            b"\xff\xfe not a manifest")


# -- save and restore ------------------------------------------------------------
def test_roundtrip(pkg):
    fab = _fabric(pkg)
    mgr = _manager(pkg, fab)
    tree, w, b = _tree(np.random.default_rng(0))
    mgr.save(tree, 100)
    assert mgr.steps() == [100]
    _assert_tree_equal(mgr.restore(100), w, b)
    _assert_tree_equal(mgr.restore(100, verify=False), w, b)
    _assert_tree_equal(mgr.restore_latest(), w, b)


def test_crash_before_rename_leaves_no_visible_checkpoint(pkg):
    fab = _fabric(pkg)
    mgr = _manager(pkg, fab)
    tree, _, _ = _tree(np.random.default_rng(2))
    real_rename = fab.meta.rename

    def crash(src, dst, *a, **kw):
        raise RuntimeError("crash before commit")

    fab.meta.rename = crash
    try:
        with pytest.raises(RuntimeError):
            mgr.save(tree, 9)
    finally:
        fab.meta.rename = real_rename
    assert mgr.steps() == []
    _raises(pkg, "CKPT_NOT_FOUND", mgr.restore, 9)
    assert [e.name for e in fab.meta.list_dir(mgr.root)] == ["9.tmp"]
    mgr.save(tree, 9)
    assert mgr.steps() == [9]


def test_corrupt_shard_detected_on_verified_restore(pkg):
    fab = _fabric(pkg)
    mgr = _manager(pkg, fab)
    tree, _, _ = _tree(np.random.default_rng(4))
    m = mgr.save(tree, 3)
    res = fab.meta.open(f"{mgr.root}/3/{m.shards[0].file}", flags=2)
    fab.file_client().write(res.inode, 0, b"\xff" * 4)
    fab.meta.close(res.inode.id, res.session_id, wrote=True)
    _raises(pkg, "CKPT_CORRUPT", mgr.restore, 3)


def test_double_save_same_step_rejected(pkg):
    fab = _fabric(pkg)
    mgr = _manager(pkg, fab)
    tree, _, _ = _tree(np.random.default_rng(5))
    mgr.save(tree, 11)
    _raises(pkg, "META_EXISTS", mgr.save, tree, 11)


def test_template_shape_and_structure_checked(pkg):
    fab = _fabric(pkg)
    mgr = _manager(pkg, fab)
    mgr.save({"w": np.zeros((4, 4), np.float32)}, 1)
    _raises(pkg, "INVALID_ARG", mgr.restore, 1,
            like={"w": np.zeros((4, 5), np.float32)})
    _raises(pkg, "INVALID_ARG", mgr.restore, 1,
            like={"w": np.zeros((4, 4), np.int32)})
    _raises(pkg, "INVALID_ARG", mgr.restore, 1,
            like=[np.zeros((4, 4), np.float32)])


# -- async save ------------------------------------------------------------------
def test_async_returns_before_durable_and_barrier_waits(pkg):
    fab = _fabric(pkg)
    mgr = _manager(pkg, fab)
    tree, w, b = _tree(np.random.default_rng(6))
    gate = threading.Event()
    real_rename = fab.meta.rename

    def gated_rename(src, dst, *a, **kw):
        gate.wait(10.0)
        return real_rename(src, dst, *a, **kw)

    fab.meta.rename = gated_rename
    try:
        handle = mgr.save_async(tree, 20)
        assert not handle.done
        assert mgr.steps() == []
        _raises(pkg, "CKPT_BUSY", mgr.save_async, tree, 21)
        gate.set()
        assert handle.result(10.0) == 20
    finally:
        fab.meta.rename = real_rename
    assert mgr.steps() == [20]
    _assert_tree_equal(mgr.restore(20), w, b)
    mgr.save_async(tree, 21).result(10.0)
    assert mgr.steps() == [20, 21]


def test_async_failure_surfaces_via_result(pkg):
    fab = _fabric(pkg)
    mgr = _manager(pkg, fab)
    tree, _, _ = _tree(np.random.default_rng(7))
    real_rename = fab.meta.rename
    fab.meta.rename = lambda *a, **kw: (_ for _ in ()).throw(
        RuntimeError("boom"))
    try:
        handle = mgr.save_async(tree, 30)
        handle.wait(10.0)
        with pytest.raises(RuntimeError):
            handle.result(1.0)
    finally:
        fab.meta.rename = real_rename
    assert mgr.steps() == []


def test_stale_session_of_crashed_saver_is_taken_over(pkg):
    fab = _fabric(pkg)
    clock = {"t": 1000.0}
    mgr = _manager(pkg, fab, session_ttl_s=60.0, clock=lambda: clock["t"])
    tree, _, _ = _tree(np.random.default_rng(8))
    dead = pkg.saver.SaveSession(fab.kv, mgr.root, 40, "dead", 60.0,
                                 clock=lambda: clock["t"])
    dead.acquire()
    _raises(pkg, "CKPT_BUSY", mgr.save, tree, 41)
    clock["t"] += 61.0
    mgr.save(tree, 41)
    assert mgr.steps() == [41]


# -- retention and archival --------------------------------------------------------
def test_keep_last_n_routes_through_trash(pkg):
    fab = _fabric(pkg)
    clock = {"t": 50_000.0}
    mgr = _manager(pkg, fab, policy=pkg.ckpt.RetentionPolicy(keep_last=2),
                   clock=lambda: clock["t"])
    tree, _, _ = _tree(np.random.default_rng(9))
    for step in (1, 2, 3, 4):
        mgr.save(tree, step)
    assert mgr.run_gc() == 2
    assert mgr.steps() == [3, 4]
    entries = pkg.trash.list_trash(fab.meta)
    assert sorted(e.orig_name for e in entries) == ["1", "2"]
    assert {e.create_ts for e in entries} == {50_000}
    pkg.trash.restore_from_trash(fab.meta, entries[0].path,
                                 f"{mgr.root}/{entries[0].orig_name}")
    assert len(mgr.steps()) == 3


def test_keep_every_k_preserves_milestones(pkg):
    policy = pkg.ckpt.RetentionPolicy(keep_last=1, keep_every=10)
    assert policy.keep([5, 10, 15, 20, 25]) == {10, 20, 25}


def test_stale_tmp_swept_live_tmp_kept(pkg):
    fab = _fabric(pkg)
    mgr = _manager(pkg, fab)
    mgr.gc._tmp_ttl_s = 3600.0
    tree, _, _ = _tree(np.random.default_rng(10))
    real_rename = fab.meta.rename
    fab.meta.rename = lambda *a, **kw: (_ for _ in ()).throw(
        RuntimeError("crash"))
    try:
        with pytest.raises(RuntimeError):
            mgr.save(tree, 8)
    finally:
        fab.meta.rename = real_rename
    assert [e.name for e in fab.meta.list_dir(mgr.root)] == ["8.tmp"]
    mgr.run_gc()
    assert [e.name for e in fab.meta.list_dir(mgr.root)] == ["8.tmp"]
    mgr.gc._tmp_ttl_s = -1.0
    mgr.run_gc()
    assert [e.name for e in fab.meta.list_dir(mgr.root)] == []


def test_explicit_remove_step(pkg):
    fab = _fabric(pkg)
    mgr = _manager(pkg, fab)
    tree, _, _ = _tree(np.random.default_rng(11))
    mgr.save(tree, 77)
    mgr.remove(77)
    assert mgr.steps() == []
    assert [e.orig_name for e in pkg.trash.list_trash(fab.meta)] == ["77"]
    _raises(pkg, "CKPT_NOT_FOUND", mgr.remove, 78)


def test_archive_reencodes_onto_ec_and_restores(pkg):
    fab = _fabric(pkg, num_storage_nodes=4)
    ec_layout = _add_ec_chain(pkg, fab)
    mgr = _manager(pkg, fab)
    tree = {"w": np.random.default_rng(12).standard_normal(
        (64, 64)).astype(np.float32)}
    mgr.save(tree, 5)
    assert not mgr.gc.step_is_archived(5)
    mgr.archive(5, ec_layout)
    assert mgr.gc.step_is_archived(5)
    assert fab.meta.stat(f"{mgr.root}/5/l0.s0").layout.chains == \
        ec_layout.chains
    assert np.array_equal(mgr.restore(5)["w"], tree["w"])
    assert np.array_equal(mgr.restore(5, verify=False)["w"], tree["w"])
    assert [e.orig_name for e in pkg.trash.list_trash(fab.meta)] == ["5"]
    assert mgr.gc.archive_pass(ec_layout, keep_replicated=0) == 0


def test_archive_missing_step_raises(pkg):
    fab = _fabric(pkg, num_storage_nodes=4)
    ec_layout = _add_ec_chain(pkg, fab)
    mgr = _manager(pkg, fab)
    _raises(pkg, "CKPT_NOT_FOUND", mgr.archive, 99, ec_layout)


# -- QoS and monitor ---------------------------------------------------------------
def test_checkpoint_io_rides_the_ckpt_class(pkg):
    fab = _fabric(pkg, qos=pkg.qos.QosConfig(), num_storage_nodes=1,
                  num_chains=1, num_replicas=1)
    seen = []
    svc = fab.nodes[min(fab.nodes)].service
    real = svc._submit_batch_update

    def spy(target, reqs):
        seen.append(pkg.qos.current_class(None))
        return real(target, reqs)

    svc._submit_batch_update = spy
    _manager(pkg, fab).save({"w": np.arange(64, dtype=np.float32)}, 1)
    assert seen and all(tc == pkg.qos.TrafficClass.CKPT for tc in seen)


def test_ckpt_metrics_reach_the_monitor(pkg):
    fab = _fabric(pkg)
    mgr = _manager(pkg, fab, policy=pkg.ckpt.RetentionPolicy(keep_last=1))
    tree, _, _ = _tree(np.random.default_rng(15))
    mgr.save(tree, 1)
    mgr.save(tree, 2)
    mgr.restore(2)
    mgr.run_gc()
    sink = pkg.recorder.MemorySink()
    mon = pkg.recorder.Monitor.default()
    mon.add_sink(sink)
    try:
        mon.collect()
    finally:
        mon._sinks.remove(sink)
    assert {"ckpt.save_ms", "ckpt.restore_ms", "ckpt.save_bytes",
            "ckpt.gc_removed"} <= {s.name for s in sink.samples}


# -- the port's own rules ------------------------------------------------------------
@pytest.fixture
def port_mgr():
    fab = Fabric(SystemSetupConfig(num_storage_nodes=2, num_chains=2,
                                   num_replicas=2, chunk_size=CHUNK),
                 device="cpu")
    yield fab, ckpt.CheckpointManager(fab.meta, fab.file_client(), kv=fab.kv,
                                      clock=lambda: 5.0)
    fab.close()


def test_tensor_leaves_are_snapshotted_and_land_on_their_template(port_mgr):
    fab, mgr = port_mgr
    w = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    handle = mgr.save_async({"w": w, "n": torch.tensor(3)}, 1)
    w.zero_()  # the snapshot was taken before save_async returned
    handle.result(30.0)
    out = mgr.restore(1)
    assert isinstance(out["w"], np.ndarray) and out["n"].dtype == np.int64
    assert np.array_equal(out["w"], np.arange(24, dtype=np.float32)
                          .reshape(4, 6))
    like = {"w": torch.empty(4, 6), "n": torch.tensor(0)}
    got = mgr.restore(1, like=like, verify=False)
    assert got["w"].device == like["w"].device and got["w"].sum() == 276
    assert [s.dtype for s in mgr.manifest(1).leaves] == ["<f4", "<i8"]


def test_one_k2_call_per_verified_restore(port_mgr):
    fab, mgr = port_mgr
    rng = np.random.default_rng(1)
    tree = {f"l{i}": rng.standard_normal((n,)).astype(np.float32)
            for i, n in enumerate([3, 1500, 4000, 9000])}
    mgr.save(tree, 1)
    calls = []
    real = port_crc.crc32c_many

    def spy(bufs, device=None):
        calls.append(len(bufs))
        return real(bufs, device)

    with mock.patch.object(port_crc, "crc32c_many", spy):
        mgr.restore(1)
        assert len(calls) == 1 and calls[0] == sum(
            -(-a.nbytes // port_crc.PIECE_BYTES) for a in tree.values())
        mgr.restore(1, verify=False)
        assert len(calls) == 1


def test_bfloat16_leaf_fails_where_the_jax_save_fails(port_mgr):
    fab, mgr = port_mgr
    jfab = jax_fabric.Fabric(jax_fabric.SystemSetupConfig(
        num_storage_nodes=2, num_chains=2, num_replicas=2, chunk_size=CHUNK))
    jmgr = jax_ckpt.CheckpointManager(jfab.meta, jfab.file_client(),
                                      kv=jfab.kv)
    import jax.numpy as jnp

    with pytest.raises(ValueError):
        jmgr.save({"w": jnp.ones((2, 3), jnp.bfloat16)}, 1)
    with pytest.raises(ValueError):
        mgr.save({"w": torch.ones((2, 3), dtype=torch.bfloat16)}, 1)
    assert [e.name for e in fab.meta.list_dir(mgr.root)] == \
        [e.name for e in jfab.meta.list_dir(jmgr.root)] == ["1.tmp"]
    jfab.close()


def test_dtensor_on_one_rank_is_saved_as_a_named_sharding(tmp_path):
    """A DTensor on a one-rank (1, 1) mesh, Shard(0) on ``dp``: its
    manifest equals the JAX package's for a ``NamedSharding`` leaf on a
    (1, 1) mesh with ``P("dp", None)``; it restores onto a DTensor
    template as a DTensor holding the same values."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    w = np.random.default_rng(2).standard_normal((6, 5)).astype(np.float32)
    jmesh = Mesh(np.array(jax.devices("cpu")[:1]).reshape(1, 1),
                 ("dp", "chain"))
    jfab = jax_fabric.Fabric(jax_fabric.SystemSetupConfig(
        num_storage_nodes=2, num_chains=2, num_replicas=2, chunk_size=CHUNK))
    jmgr = jax_ckpt.CheckpointManager(jfab.meta, jfab.file_client(),
                                      kv=jfab.kv, clock=lambda: 5.0)
    want = jmgr.save({"w": jax.device_put(w, NamedSharding(
        jmesh, PartitionSpec("dp", None)))}, 1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0,
                            timeout=timedelta(seconds=30))
    fab = Fabric(SystemSetupConfig(num_storage_nodes=2, num_chains=2,
                                   num_replicas=2, chunk_size=CHUNK),
                 device="cpu")
    try:
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("dp", "chain"))
        placements = [Shard(0), Replicate()]
        leaf = DTensor.from_local(torch.from_numpy(w.copy()), mesh,
                                  placements, run_check=False)
        mgr = ckpt.CheckpointManager(fab.meta, fab.file_client(), kv=fab.kv,
                                     clock=lambda: 5.0)
        got = mgr.save({"w": leaf}, 1)
        assert got.encode() == want.encode()
        assert got.mesh == {"dp": 1, "chain": 1}
        assert got.leaves[0].spec == ["dp", ""]
        out = mgr.restore(1, like={"w": leaf})["w"]
        assert isinstance(out, DTensor) and out.placements == leaf.placements
        assert np.array_equal(out.to_local().numpy(), w)
    finally:
        fab.close()
        jfab.close()
        dist.destroy_process_group()


def test_manager_without_a_device_runs_on_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Fabric(SystemSetupConfig(num_storage_nodes=2, num_chains=2,
                                 num_replicas=2, chunk_size=CHUNK))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_crc.crc32c_pieces([b"x"])
