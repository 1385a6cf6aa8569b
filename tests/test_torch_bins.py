"""The operator's tools in the port (``bin/ckpt_gc_main``,
``bin/dataload_pack_main``, ``bin/kvcache_gc_main``), on the CPU, run from
their entry points (``main`` with ``--connect`` and ``--device cpu``)
against a port cluster over sockets (``tests/torch_socket_sequence.py``:
mgmtd, four storage apps on CR chains, meta; an EC(3,1) chain added for
the archive). Tolerance 0: bytes and tensors must be equal.

The packed record file is byte-equal to the JAX package's
``dataload_pack_main.run`` output for the same seeded samples; a
checkpoint archived to EC by ``ckpt_gc_main --archive-after`` restores
equal, its leaves on the EC chain; ``kvcache_gc_main --ttl 0`` removes
every entry under its root and the meta GC then drops their chunks.
Each tool, with no ``--device`` and no card, raises."""

import argparse
import io
import os

import numpy as np
import pytest
import torch

from torch_socket_sequence import AppCluster

CHUNK = 1 << 16
EC_CHAIN = 990_001
CPU = {"device": "cpu"}


@pytest.fixture
def cluster():
    c = AppCluster("tpu3fs_torch", dict(nodes=4, chains=2, replicas=2,
                                        chunk_size=CHUNK),
                   app_kw=CPU, client_kw=CPU)
    try:
        yield c
    finally:
        c.close()


def _connect(cluster) -> list:
    return ["--connect", "%s:%d" % cluster.maddr]


def _add_ec_chain(cluster, k: int = 3, m: int = 1, first_tid: int = 5000):
    """One EC(k, m) chain over the cluster's nodes, opened by their
    target scans (the archive's destination)."""
    ids = sorted(cluster.nodes)
    tids = []
    for i in range(k + m):
        cluster.admin.create_target(first_tid + i, node_id=ids[i % len(ids)])
        tids.append(first_tid + i)
    cluster.admin.upload_chain(EC_CHAIN, tids, ec_k=k, ec_m=m)
    for app in cluster.nodes.values():
        app.scan_targets()
    cluster.tick()
    chain = cluster.admin.refresh_routing().chains[EC_CHAIN]
    assert chain.is_ec and len(chain.targets) == k + m


def _samples(tmp_path, seed: int = 11, n: int = 9) -> list:
    rng = np.random.default_rng(seed)
    files = []
    for i in range(n):
        p = tmp_path / f"s{i:02d}.bin"
        p.write_bytes(rng.integers(0, 256, int(rng.integers(1, 40_000)),
                                   dtype=np.uint8).tobytes())
        files.append(str(p))
    return files


def _read_file(meta, fio, path: str) -> bytes:
    inode = meta.stat(path)
    return fio.read(inode, 0, inode.length)


def test_dataload_pack_main_equals_the_jax_writer(cluster, tmp_path, capfd):
    from tpu3fs.bin import dataload_pack_main as jax_pack
    from tpu3fs.fabric.fabric import Fabric, SystemSetupConfig

    from tpu3fs_torch.bin import dataload_pack_main as pack
    from tpu3fs_torch.dataload.recordio import RecordFile

    files = _samples(tmp_path)
    jfab = Fabric(SystemSetupConfig(num_storage_nodes=4, num_chains=2,
                                    chunk_size=CHUNK))
    ns = argparse.Namespace(out="/packed/train.rec", files=files,
                            from_dir="", inspect="")
    assert jax_pack.run(jfab, ns, out=io.StringIO()) == 0
    want = _read_file(jfab.meta, jfab.file_client(), "/packed/train.rec")

    assert pack.main([*_connect(cluster), "--device", "cpu",
                      "--out", "/packed/train.rec", *files]) == 0
    total = sum(os.path.getsize(f) for f in files)
    assert capfd.readouterr().out.strip() == (
        f"packed {len(files)} records, {total} payload bytes "
        "-> /packed/train.rec")
    fio = cluster.file_client()
    assert _read_file(cluster.meta, fio, "/packed/train.rec") == want
    rf = RecordFile.open(cluster.meta, fio, "/packed/train.rec")
    for i, f in enumerate(files):
        with open(f, "rb") as fh:
            assert rf.read(i) == fh.read()
    assert pack.main([*_connect(cluster), "--device", "cpu",
                      "--inspect", "/packed/train.rec"]) == 0
    assert f"records: {len(files)}" in capfd.readouterr().out


def test_ckpt_gc_main_archives_to_ec_and_restores_equal(cluster, capfd):
    from tpu3fs_torch.bin import ckpt_gc_main
    from tpu3fs_torch.ckpt import CheckpointManager

    _add_ec_chain(cluster)
    mgr = CheckpointManager(cluster.meta, cluster.file_client())
    g = torch.Generator().manual_seed(16)
    trees = {step: {"q": torch.randn(64, 48, generator=g),
                    "k": torch.randn(48, generator=g),
                    "o": torch.arange(300, dtype=torch.int32) * step}
             for step in (1, 2, 3)}
    for step, tree in trees.items():
        mgr.save(tree, step)
    assert ckpt_gc_main.main([
        *_connect(cluster), "--device", "cpu", "--once",
        "--keep-last", "10", "--archive-after", "1",
        "--archive-chunk-size", str(CHUNK)]) == 0
    assert "evicted=0 archived=2 steps_left=3" in capfd.readouterr().out
    for step in (1, 2):
        for leaf in range(3):
            ino = cluster.meta.stat(f"{mgr.root}/{step}/l{leaf}.s0")
            assert ino.layout.chains == [EC_CHAIN], (step, leaf)
    assert cluster.meta.stat(f"{mgr.root}/3/l0.s0").layout.chains \
        != [EC_CHAIN]
    fresh = CheckpointManager(cluster.meta, cluster.file_client())
    for step, tree in trees.items():
        got = fresh.restore(step)
        for name, want in tree.items():
            assert torch.equal(torch.as_tensor(got[name]), want), \
                (step, name)
    assert ckpt_gc_main.main([
        *_connect(cluster), "--device", "cpu", "--once",
        "--keep-last", "10", "--archive-after", "1"]) == 0
    assert "archived=0" in capfd.readouterr().out


def test_kvcache_gc_main_removes_entries_and_their_chunks(cluster, capfd):
    from tpu3fs_torch.bin import kvcache_gc_main
    from tpu3fs_torch.kvcache.cache import KVCacheClient

    kv = KVCacheClient(cluster.meta, cluster.file_client(), root="/kvc")
    rng = np.random.default_rng(5)
    for i in range(12):
        kv.put(f"page{i}", rng.integers(0, 256, 3000 + i,
                                        dtype=np.uint8).tobytes())
    ids = {cluster.meta.stat(p).id for p in _entry_paths(cluster, "/kvc")}
    assert len(ids) == 12 and _chunks_of(cluster, ids)
    assert kvcache_gc_main.main([
        *_connect(cluster), "--device", "cpu", "--once", "--ttl", "0",
        "--root", "/kvc"]) == 0
    assert "ttl_removed=12" in capfd.readouterr().out
    assert _entry_paths(cluster, "/kvc") == []
    cluster.run_gc()
    assert not _chunks_of(cluster, ids)


def _entry_paths(cluster, root: str) -> list:
    """Every file under ``root`` (the cache's shard directories)."""
    out, todo = [], [root]
    while todo:
        d = todo.pop()
        for e in cluster.meta.list_dir(d):
            path = f"{d}/{e.name}"
            if e.type.name == "DIRECTORY":
                todo.append(path)
            else:
                out.append(path)
    return sorted(out)


def _chunks_of(cluster, file_ids) -> list:
    """The committed chunks of ``file_ids`` on every target."""
    routing = cluster.admin.refresh_routing()
    m = cluster.messenger()
    found = []
    for tid, info in routing.targets.items():
        for meta in m(info.node_id, "dump_chunkmeta", tid):
            if meta.chunk_id.file_id in file_ids:
                found.append((tid, meta.chunk_id))
    return found


@pytest.mark.parametrize("module,extra", [
    ("ckpt_gc_main", ["--once"]),
    ("dataload_pack_main", ["--inspect", "/x.rec"]),
    ("kvcache_gc_main", ["--once"])])
def test_tool_without_a_card_or_a_device_raises(cluster, module, extra):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    main = importlib.import_module(f"tpu3fs_torch.bin.{module}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([*_connect(cluster), *extra])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([*_connect(cluster), "--device", "cuda", *extra])
