"""The storage maintenance workers and the meta scans on the CPU, each case
run over both packages (the JAX package's ``tpu3fs.storage.workers`` and
``tpu3fs.meta.scan`` and the port's copies): ``CheckWorker``'s disk probe,
offlining and low-space flags, ``PunchHoleWorker`` and ``AllocateWorker``
(cases of ``tests/test_workers.py`` on mem targets with a directory, and
its native-engine cases on the C++ engine of each package); the
namespace scans, the orphan check,
the usage stats and the meta event log (``tests/test_meta_scan.py``). Then
one seeded cluster, an RS(4,2) and a CR fabric built the same way in both
packages: ``DumpWorker``'s chunk records, the maintenance passes and the
meta scans (inode and dirent records serialized, the event rows) must be
equal. Tolerance 0.

Left out: ``TestMemoryMonitor`` (``monitor/memory`` moves to M6a-2)."""

import importlib
import random
import shutil
from types import SimpleNamespace

import pytest

import tpu3fs.meta.scan as jax_scan
import tpu3fs.meta.store as jax_meta_store
import tpu3fs.meta.types as jax_meta_types
from torch_ckpt_sequence import SHAPES, deterministic

import tpu3fs_torch.meta.scan as port_scan
import tpu3fs_torch.meta.store as port_meta_store
import tpu3fs_torch.meta.types as port_meta_types

PACKAGES = ["tpu3fs", "tpu3fs_torch"]


def _pkg(root: str) -> SimpleNamespace:
    mods = {name: importlib.import_module(f"{root}.{path}") for name, path in (
        ("workers", "storage.workers"), ("craq", "storage.craq"),
        ("target", "storage.target"), ("stypes", "storage.types"),
        ("gtypes", "mgmtd.types"), ("fabric", "fabric.fabric"),
        ("meta", "meta.store"), ("mtypes", "meta.types"),
        ("scan", "meta.scan"), ("kv", "kv"), ("kvkv", "kv.kv"),
        ("serde", "rpc.serde"), ("trace", "analytics.trace"),
        ("result", "utils.result"))}
    pkg = SimpleNamespace(**mods)
    pkg.dev = {"device": "cpu"} if root == "tpu3fs_torch" else {}
    return pkg


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return _pkg(request.param)


def _single_service(pkg, tmp_path, engine: str = "mem"):
    """One service over a hand-made routing: chain 7 of one target (70)
    on ``engine`` whose directory the check worker probes."""
    g = pkg.gtypes
    routing = g.RoutingInfo(version=1)
    routing.nodes[1] = g.NodeInfo(node_id=1, type=g.NodeType.STORAGE)
    routing.chains[7] = g.ChainInfo(
        chain_id=7, chain_version=1,
        targets=[g.TargetInfo(target_id=70, node_id=1,
                              public_state=g.PublicTargetState.SERVING)])
    routing.targets[70] = routing.chains[7].targets[0]
    svc = pkg.craq.StorageService(1, lambda: routing, lambda *a: None,
                                  **pkg.dev)
    path = tmp_path / "t70"
    path.mkdir()
    target = pkg.target.StorageTarget(70, 7, engine=engine, path=str(path),
                                      chunk_size=4096, **pkg.dev)
    svc.add_target(target)
    return svc, target


def _write(pkg, svc, file_id, data, **kw):
    return svc.write(pkg.craq.WriteReq(
        chain_id=7, chain_ver=1, chunk_id=pkg.stypes.ChunkId(file_id, 0),
        offset=0, data=data, chunk_size=4096, client_id="c", channel_id=1,
        seqnum=file_id, **kw))


# -- workers ---------------------------------------------------------------------
def test_healthy_disk_keeps_target_serving(pkg, tmp_path):
    svc, target = _single_service(pkg, tmp_path)
    assert pkg.workers.CheckWorker(svc).run_once() == 0
    assert target.local_state == pkg.gtypes.LocalTargetState.UPTODATE
    assert not target.reject_create and not target.emergency_recycling


def test_vanished_path_offlines_target_and_fires_callback(pkg, tmp_path):
    svc, target = _single_service(pkg, tmp_path)
    fired = []
    w = pkg.workers.CheckWorker(svc,
                                on_offline=lambda t: fired.append(t.target_id))
    shutil.rmtree(target.path)
    assert w.run_once() == 1
    assert target.local_state == pkg.gtypes.LocalTargetState.OFFLINE
    assert fired == [70]
    assert w.run_once() == 0  # already offline: skipped


def test_low_space_flags_reject_create(pkg, tmp_path):
    svc, target = _single_service(pkg, tmp_path)
    pkg.workers.CheckWorker(svc, reject_create_threshold=0.0,
                            emergency_recycling_ratio=0.0).run_once()
    assert target.reject_create and target.emergency_recycling
    rep = _write(pkg, svc, 5, b"x")
    assert rep.code == pkg.result.Code.NO_SPACE
    assert target.local_state == pkg.gtypes.LocalTargetState.UPTODATE


def test_mem_target_without_a_directory_has_no_disk_to_fail(pkg):
    fab = pkg.fabric.Fabric(pkg.fabric.SystemSetupConfig(
        num_storage_nodes=1, num_chains=1, num_replicas=1), **pkg.dev)
    try:
        svc = next(iter(fab.nodes.values())).service
        assert pkg.workers.CheckWorker(svc).run_once() == 0
    finally:
        fab.close()


def test_punch_hole_and_allocate_workers(pkg, tmp_path):
    svc, target = _single_service(pkg, tmp_path)
    assert _write(pkg, svc, 9, b"y" * 4096).ok
    assert target.engine.remove(pkg.stypes.ChunkId(9, 0))
    compacts = 1 if hasattr(target.engine, "compact") else 0
    assert pkg.workers.PunchHoleWorker(svc).run_once() == compacts
    assert target.engine.used_size() == 0
    alloc = pkg.workers.AllocateWorker(svc)
    assert alloc.run_once() == 0
    target.emergency_recycling = True
    assert alloc.run_once() == 1


def test_native_check_worker_cases(pkg, tmp_path):
    """``tests/test_workers.py``'s CheckWorker cases on a native target:
    a healthy disk serves, low space flags reject-create (new chunks
    refused, resync and chain forwards still land), a vanished directory
    offlines the target."""
    svc, target = _single_service(pkg, tmp_path, "native")
    assert type(target.engine).__name__ == "NativeChunkEngine"
    w = pkg.workers.CheckWorker(svc)
    assert w.run_once() == 0
    assert target.local_state == pkg.gtypes.LocalTargetState.UPTODATE
    assert target.space_info().capacity > 0
    pkg.workers.CheckWorker(svc, reject_create_threshold=0.0,
                            emergency_recycling_ratio=0.0).run_once()
    assert target.reject_create and target.emergency_recycling
    assert _write(pkg, svc, 5, b"x").code == pkg.result.Code.NO_SPACE
    ChunkId, WriteReq = pkg.stypes.ChunkId, pkg.craq.WriteReq
    assert svc.update(WriteReq(
        chain_id=7, chain_ver=1, chunk_id=ChunkId(6, 0), offset=0,
        data=b"r" * 4096, chunk_size=4096, full_replace=True, update_ver=1,
        from_target=999)).ok
    assert svc.update(WriteReq(
        chain_id=7, chain_ver=1, chunk_id=ChunkId(6, 1), offset=0,
        data=b"f" * 64, chunk_size=4096, update_ver=1, from_target=999)).ok
    fired = []
    w = pkg.workers.CheckWorker(svc,
                                on_offline=lambda t: fired.append(t.target_id))
    shutil.rmtree(target.path)
    assert w.run_once() == 1 and fired == [70]
    assert target.local_state == pkg.gtypes.LocalTargetState.OFFLINE
    target.engine.close()


def test_punch_hole_compacts_native_engine(pkg, tmp_path):
    svc, target = _single_service(pkg, tmp_path, "native")
    assert _write(pkg, svc, 9, b"y" * 4096).ok
    assert target.engine.remove(pkg.stypes.ChunkId(9, 0))
    assert pkg.workers.PunchHoleWorker(svc).run_once() == 1
    assert target.engine.used_size() == 0
    alloc = pkg.workers.AllocateWorker(svc)
    assert alloc.run_once() == 0
    target.emergency_recycling = True
    assert alloc.run_once() == 1
    target.engine.close()


# -- meta scans --------------------------------------------------------------------
@pytest.fixture
def meta(pkg):
    return pkg.meta.MetaStore(pkg.kv.MemKVEngine(),
                              pkg.meta.ChainAllocator(1, [101, 102]))


def test_scan_inodes_and_dirents(pkg, meta):
    meta.mkdirs("/a")
    meta.create("/a/f1")
    meta.create("/a/f2")
    meta.symlink("/a/l", "f1")
    assert len(list(pkg.scan.scan_inodes(meta._engine))) == 5
    assert sorted(e.name for e in pkg.scan.scan_dirents(meta._engine)) == [
        "a", "f1", "f2", "l"]


def test_scan_batches_cross_boundary(pkg, meta, monkeypatch):
    for i in range(7):
        meta.create(f"/f{i}")
    monkeypatch.setattr(pkg.scan, "_SCAN_BATCH", 3)
    assert len(list(pkg.scan.scan_inodes(meta._engine))) == 8


def test_namespace_stats(pkg, meta):
    meta.mkdirs("/d")
    res = meta.create("/d/f")
    meta.sync(res.inode.id, length_hint=4096)
    st = pkg.scan.namespace_stats(meta._engine)
    assert st == {"files": 1, "dirs": 2, "symlinks": 0, "total_length": 4096}


def test_find_orphans(pkg, meta):
    meta.create("/ok")
    assert pkg.scan.find_orphan_inodes(meta._engine) == []
    t = pkg.mtypes
    ghost = t.Inode.new_file(999, t.Acl(0, 0, 0o644),
                             t.Layout(1, [101], 1 << 20, 0))
    pkg.kvkv.with_transaction(meta._engine, lambda txn: txn.set(
        t.inode_key(999), pkg.serde.serialize(ghost)))
    assert [o.id for o in pkg.scan.find_orphan_inodes(meta._engine)] == [999]


def test_mutating_ops_emit_rows(pkg, tmp_path):
    log = pkg.scan.MetaEventLog(str(tmp_path), flush_rows=4)
    meta = pkg.meta.MetaStore(pkg.kv.MemKVEngine(),
                              pkg.meta.ChainAllocator(1, [101]),
                              event_log=log)
    meta.mkdirs("/d")
    meta.create("/d/f")
    meta.rename("/d/f", "/d/g")
    meta.remove("/d/g")
    log.flush()
    rows = pkg.trace.SerdeObjectReader(pkg.scan.MetaEvent).read(log.paths)
    assert [r.op for r in rows] == ["mkdir", "create", "rename", "remove"]
    assert rows[2].detail == "/d/g"
    assert rows[1].inode_id > 0 and rows[1].ts > 0


# -- one seeded cluster through both packages ---------------------------------------
def cluster_sequence(pkg, shape, tmp_path) -> dict:
    """Files written, overwritten and removed on a fabric of ``shape``;
    then every node's maintenance passes and dumps, and the meta scans."""
    fab = pkg.fabric.Fabric(pkg.fabric.SystemSetupConfig(**SHAPES[shape]),
                            **pkg.dev)
    try:
        log = pkg.scan.MetaEventLog(str(tmp_path / "events"), flush_rows=8)
        fab.meta._events = log
        fio = fab.file_client()
        rng = random.Random(61)
        fab.meta.mkdirs("/m/n", recursive=True)
        for i in range(4):
            res = fab.meta.create(f"/m/n/f{i}",
                                  flags=pkg.meta.OpenFlags.WRITE,
                                  client_id="c")
            n = 4096 * (i + 1) + 97 * i
            fio.write(res.inode, 0, bytes(rng.getrandbits(8)
                                          for _ in range(n)))
            fab.meta.close(res.inode.id, res.session_id, length_hint=n,
                           wrote=True)
        fio.write(fab.meta.stat("/m/n/f2"), 100, b"\xab" * 300)
        fab.meta.rename("/m/n/f3", "/m/g3")
        fab.meta.remove("/m/n/f0")
        log.flush()
        rec = {"check": [], "dumps": [], "punch": [], "alloc": []}
        for node_id, node in sorted(fab.nodes.items()):
            svc = node.service
            rec["check"].append(pkg.workers.CheckWorker(svc).run_once())
            files = pkg.workers.DumpWorker(
                svc, str(tmp_path / "dumps"), node_id=node_id).run_once()
            rows = [pkg.trace.read_records(p) for p in files]
            rec["dumps"].append([sorted(tuple(sorted(r.items())) for r in rs)
                                 for rs in rows])
            rec["punch"].append(pkg.workers.PunchHoleWorker(svc).run_once())
            rec["alloc"].append(pkg.workers.AllocateWorker(svc).run_once())
        eng = fab.meta.engine
        ser = pkg.serde.serialize
        rec["inodes"] = [ser(i) for i in pkg.scan.scan_inodes(eng)]
        rec["dirents"] = [ser(d) for d in pkg.scan.scan_dirents(eng)]
        rec["orphans"] = [i.id for i in pkg.scan.find_orphan_inodes(eng)]
        rec["stats"] = pkg.scan.namespace_stats(eng)
        rec["events"] = [(r["op"], r["path"], r["inode_id"], r["detail"])
                         for p in log.paths
                         for r in pkg.trace.read_records(p)]
        return rec
    finally:
        fab.close()


@pytest.fixture(scope="module", params=sorted(SHAPES))
def cluster_runs(request, tmp_path_factory):
    shape = request.param
    with deterministic([jax_meta_store, jax_meta_types, jax_scan]):
        want = cluster_sequence(_pkg("tpu3fs"), shape,
                                tmp_path_factory.mktemp("jax"))
    with deterministic([port_meta_store, port_meta_types, port_scan]):
        got = cluster_sequence(_pkg("tpu3fs_torch"), shape,
                               tmp_path_factory.mktemp("port"))
    return want, got


def test_dump_records_equal(cluster_runs):
    want, got = cluster_runs
    assert got["dumps"] == want["dumps"]
    assert sum(len(rows) for node in got["dumps"] for rows in node) > 0


def test_maintenance_passes_equal(cluster_runs):
    want, got = cluster_runs
    for key in ("check", "punch", "alloc"):
        assert got[key] == want[key], key
    assert set(got["check"]) == {0}


def test_meta_scans_equal(cluster_runs):
    want, got = cluster_runs
    for key in ("inodes", "dirents", "orphans", "stats", "events"):
        assert got[key] == want[key], key
    assert [e[0] for e in got["events"]][-2:] == ["rename", "remove"]
