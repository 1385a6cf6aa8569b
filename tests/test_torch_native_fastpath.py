"""The C++ transport's storage fast paths in the port
(``tpu3fs_torch/storage/native_fastpath.py`` over
``tpu3fs_torch/hostsrc/rpc_net.cpp``): ``tests/test_native_fastpath.py``'s
classes run on the port's nodes (``tests/torch_native_cluster.py``), and
one seeded write and read sequence through a JAX package chain and a port
chain, both native, gives equal replies and stored bytes.

The contract: fast-path reads and writes are byte-identical to the Python
dispatch's, anything ambiguous falls back (and still answers), the
registry follows target state, ``TPU3FS_NATIVE_WRITE=0`` stands the head
down, exactly-once holds across the path swap, the planted
``native_commit_skip_crc`` bug shows only when armed, and the fast path
serves in a process that loaded the JAX package's libraries first (the
same C symbols, each library ``RTLD_LOCAL``)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_native_cluster as tnc
from tpu3fs_torch.client.storage_client import ReadReq
from tpu3fs_torch.mgmtd.types import LocalTargetState
from tpu3fs_torch.ops.crc32c import crc32c_py
from tpu3fs_torch.rpc.services import RpcMessenger
from tpu3fs_torch.storage.native_fastpath import sync_read_fastpath
from tpu3fs_torch.storage.target import StorageTarget
from tpu3fs_torch.storage.types import ChunkId
from tpu3fs_torch.utils.result import Code

CHUNK, CHAIN = tnc.CHUNK, tnc.CHAIN
PORT = "tpu3fs_torch"
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def native_node(tmp_path):
    env = tnc.build(PORT, tmp_path, [(10, 1000)])
    node = env["nodes"][10]
    env.update(svc=node["svc"], server=node["server"], target=node["target"])
    try:
        yield env
    finally:
        tnc.close(env)


@pytest.fixture
def native_chain(tmp_path):
    env = tnc.build(PORT, tmp_path, [(10, 1000), (11, 1001)])
    try:
        yield env
    finally:
        tnc.close(env)


def _client_for(env, **kw):
    return tnc.storage_client(env, **kw)


def _sync_all(env):
    return tnc.sync_all(env)


class TestNativeReadFastpath:
    def test_fastpath_hits_and_matches_python_dispatch(self, native_node):
        env = native_node
        sc = _client_for(env)
        payloads = {i: bytes([i]) * (CHUNK - i * 7) for i in range(1, 6)}
        for i, p in payloads.items():
            assert sc.write_chunk(CHAIN, ChunkId(5, i), 0, p,
                                  chunk_size=CHUNK).ok
        reqs = [ReadReq(CHAIN, ChunkId(5, i), 0, -1) for i in payloads]
        golden = sc.batch_read(reqs)
        h0, f0 = env["server"].fastpath_stats()
        assert h0 == 0 and f0 > 0
        assert sync_read_fastpath(env["server"], env["svc"]) == 1
        fast = sc.batch_read(reqs)
        assert env["server"].fastpath_stats()[0] >= 1
        for g, f in zip(golden, fast):
            assert (g.code, bytes(g.data), g.commit_ver, g.checksum.value,
                    g.logical_len) == (f.code, bytes(f.data), f.commit_ver,
                                       f.checksum.value, f.logical_len)
        assert bytes(fast[0].data) == payloads[1]

    def test_ranged_reads_and_missing_chunks(self, native_node):
        env = native_node
        sc = _client_for(env)
        blob = bytes(range(256)) * 16
        assert sc.write_chunk(CHAIN, ChunkId(6, 0), 0, blob,
                              chunk_size=CHUNK).ok
        sync_read_fastpath(env["server"], env["svc"])
        got = sc.batch_read([ReadReq(CHAIN, ChunkId(6, 0), 100, 50),
                             ReadReq(CHAIN, ChunkId(6, 404), 0, -1)])
        assert got[0].ok and bytes(got[0].data) == blob[100:150]
        assert got[1].code == Code.CHUNK_NOT_FOUND
        assert env["server"].fastpath_stats()[0] >= 1

    def test_registry_follows_target_state(self, native_node):
        env = native_node
        sc = _client_for(env)
        assert sc.write_chunk(CHAIN, ChunkId(7, 0), 0, b"x" * 100,
                              chunk_size=CHUNK).ok
        assert sync_read_fastpath(env["server"], env["svc"]) == 1
        env["svc"].offline_target(1000)
        h0, f0 = env["server"].fastpath_stats()
        got = sc.batch_read([ReadReq(CHAIN, ChunkId(7, 0), 0, -1)])
        assert not got[0].ok
        h1, f1 = env["server"].fastpath_stats()
        assert h1 == h0 and f1 > f0
        assert sync_read_fastpath(env["server"], env["svc"]) == 0

    def test_mem_engine_targets_never_register(self, native_node):
        env = native_node
        env["svc"].add_target(StorageTarget(1001, 700_002, engine="mem",
                                            chunk_size=CHUNK, device="cpu"))
        assert sync_read_fastpath(env["server"], env["svc"]) == 1


class TestFastpathEcShards:
    def test_ec_shard_reads_identical_via_fastpath(self, native_node,
                                                   tmp_path):
        env = native_node
        mgmtd = env["mgmtd"]
        ec_chain, tids = 800_001, (1100, 1101, 1102)
        for tid in tids:
            env["svc"].add_target(StorageTarget(
                tid, ec_chain, engine="native",
                path=str(tmp_path / f"ec{tid}"), chunk_size=2048,
                device="cpu"))
            mgmtd.create_target(tid, node_id=10)
        mgmtd.upload_chain(ec_chain, list(tids), ec_k=2, ec_m=1)
        mgmtd.upload_chain_table(2, [ec_chain])
        mgmtd.heartbeat(10, 9, {tid: LocalTargetState.UPTODATE
                                for tid in (1000,) + tids})
        sc = _client_for(env)
        rng = np.random.default_rng(11)
        payloads = {0: rng.integers(0, 256, 4096, dtype=np.uint8).tobytes(),
                    1: rng.integers(0, 256, 1234, dtype=np.uint8).tobytes()}
        for i, p in payloads.items():
            assert sc.write_stripe(ec_chain, ChunkId(9, i), p,
                                   chunk_size=4096).ok
        env["server"].fastpath_sync(None, {})
        golden = {i: sc.read_stripe(ec_chain, ChunkId(9, i), 0, 4096,
                                    chunk_size=4096) for i in payloads}
        assert sync_read_fastpath(env["server"], env["svc"]) >= len(tids)
        h0, _ = env["server"].fastpath_stats()
        fast = {i: sc.read_stripe(ec_chain, ChunkId(9, i), 0, 4096,
                                  chunk_size=4096) for i in payloads}
        assert env["server"].fastpath_stats()[0] > h0
        for i in payloads:
            g, f = golden[i], fast[i]
            assert (g.code, bytes(g.data), g.logical_len) == (
                f.code, bytes(f.data), f.logical_len)
            assert bytes(f.data)[:f.logical_len] == payloads[i]


def _forwarded_reqs(env, items):
    from tpu3fs_torch.storage.craq import WriteReq

    chain = env["mcli"].refresh_routing().chains[CHAIN]
    return [WriteReq(chain_id=CHAIN, chain_ver=chain.chain_version,
                     chunk_id=cid, offset=0, data=data, chunk_size=CHUNK,
                     update_ver=ver, from_target=1000)
            for cid, data, ver in items]


def _send(env, node_id, method, arg):
    return RpcMessenger(env["mcli"].refresh_routing, env["client"])(
        node_id, method, arg)


class TestNativeWriteFastpath:
    def test_tail_batch_update_served_natively(self, native_chain):
        env = native_chain
        sc = _client_for(env)
        _sync_all(env)
        tail = env["nodes"][11]["server"]
        h0, _ = tail.fastpath_stats()
        payloads = {i: bytes([0x40 + i]) * (CHUNK - 11 * i)
                    for i in range(1, 7)}
        replies = sc.batch_write(
            [(CHAIN, ChunkId(21, i), 0, p) for i, p in payloads.items()],
            chunk_size=CHUNK)
        assert all(r.ok for r in replies), replies
        assert tail.fastpath_stats()[0] > h0
        for i, p in payloads.items():
            for node_id in (10, 11):
                eng = env["nodes"][node_id]["target"].engine
                assert eng.read(ChunkId(21, i)) == p
                meta = eng.get_meta(ChunkId(21, i))
                assert (meta.committed_ver, meta.pending_ver) == (1, 0)
        got = sc.batch_read([ReadReq(CHAIN, ChunkId(21, i), 0, -1)
                             for i in payloads])
        assert [bytes(g.data) for g in got] == list(payloads.values())

    def test_replies_match_python_tail(self, native_chain):
        env = native_chain
        sc = _client_for(env)
        _sync_all(env)
        payload = bytes(range(250)) * 2
        fast = sc.batch_write([(CHAIN, ChunkId(22, 1), 0, payload)],
                              chunk_size=CHUNK)
        env["nodes"][11]["server"].fastpath_sync(None, {})
        golden = sc.batch_write([(CHAIN, ChunkId(22, 2), 0, payload)],
                                chunk_size=CHUNK)
        f, g = fast[0], golden[0]
        assert f.ok and g.ok
        assert (f.update_ver, f.commit_ver) == (g.update_ver, g.commit_ver)
        assert f.checksum.value == g.checksum.value == crc32c_py(payload)
        assert f.checksum.length == g.checksum.length == len(payload)

    def test_overwrites_and_partial_offsets(self, native_chain):
        env = native_chain
        sc = _client_for(env)
        _sync_all(env)
        cid = ChunkId(23, 0)
        assert sc.write_chunk(CHAIN, cid, 0, b"a" * 1000,
                              chunk_size=CHUNK).ok
        assert sc.write_chunk(CHAIN, cid, 500, b"b" * 700,
                              chunk_size=CHUNK).ok
        for node_id in (10, 11):
            assert env["nodes"][node_id]["target"].engine.read(cid) == \
                b"a" * 500 + b"b" * 700

    def test_chain_version_skew_falls_back(self, native_chain):
        env = native_chain
        sc = _client_for(env)
        _sync_all(env)
        tail = env["nodes"][11]["server"]
        eng = env["nodes"][11]["target"].engine
        tail.fastpath_sync_write(None, {CHAIN: (eng._h, 1001, 999, CHUNK)})
        h0, f0 = tail.fastpath_stats()
        assert all(r.ok for r in sc.batch_write(
            [(CHAIN, ChunkId(24, 1), 0, b"z" * 600)], chunk_size=CHUNK))
        h1, f1 = tail.fastpath_stats()
        assert h1 == h0 and f1 > f0
        for node_id in (10, 11):
            assert env["nodes"][node_id]["target"].engine.read(
                ChunkId(24, 1)) == b"z" * 600

    def test_duplicate_chunks_in_batch_fall_back(self, native_chain):
        env = native_chain
        _sync_all(env)
        tail = env["nodes"][11]["server"]
        h0, f0 = tail.fastpath_stats()
        cid = ChunkId(25, 0)
        replies = _send(env, 11, "batch_update", _forwarded_reqs(
            env, [(cid, b"1" * 400, 1), (cid, b"2" * 400, 2)]))
        assert all(r.ok for r in replies)
        h1, f1 = tail.fastpath_stats()
        assert h1 == h0 and f1 > f0
        assert env["nodes"][11]["target"].engine.read(cid) == b"2" * 400

    def test_head_node_never_registers_write_chain(self, native_chain):
        env = native_chain
        _sync_all(env)
        head = env["nodes"][10]["server"]
        h0, f0 = head.fastpath_stats()
        replies = _send(env, 10, "batch_update", _forwarded_reqs(
            env, [(ChunkId(26, 0), b"q" * 100, 1)]))
        h1, f1 = head.fastpath_stats()
        assert h1 == h0 and f1 > f0
        assert all(r.ok for r in replies)
        assert env["nodes"][11]["target"].engine.read(
            ChunkId(26, 0)) == b"q" * 100


class TestNativeHeadWritePath:
    def test_ab_lever_byte_identity_and_worker_bypass(self, native_chain,
                                                      monkeypatch):
        from tpu3fs_torch.storage import update_worker

        env = native_chain
        sc = _client_for(env)
        _sync_all(env)
        head = env["nodes"][10]["server"]
        payloads = {i: bytes([0x60 + i]) * (CHUNK - 13 * i)
                    for i in range(1, 5)}
        s0 = head.fastpath_write_stats()
        r0 = update_worker.rounds_run()
        fast = sc.batch_write(
            [(CHAIN, ChunkId(30, i), 0, p) for i, p in payloads.items()],
            chunk_size=CHUNK)
        assert all(r.ok for r in fast), fast
        assert head.fastpath_write_stats()[0] > s0[0]
        assert update_worker.rounds_run() == r0
        monkeypatch.setenv("TPU3FS_NATIVE_WRITE", "0")
        _sync_all(env)
        s1 = head.fastpath_write_stats()
        golden = sc.batch_write(
            [(CHAIN, ChunkId(31, i), 0, p) for i, p in payloads.items()],
            chunk_size=CHUNK)
        assert all(r.ok for r in golden), golden
        assert head.fastpath_write_stats()[0] == s1[0]
        assert update_worker.rounds_run() > r0
        for f, g, p in zip(fast, golden, payloads.values()):
            assert (f.code, f.update_ver, f.commit_ver, f.retry_after_ms) \
                == (g.code, g.update_ver, g.commit_ver, g.retry_after_ms)
            assert f.checksum.value == g.checksum.value == crc32c_py(p)
            assert f.checksum.length == g.checksum.length == len(p)
        for i, p in payloads.items():
            for node_id in (10, 11):
                eng = env["nodes"][node_id]["target"].engine
                for fam in (30, 31):
                    meta = eng.get_meta(ChunkId(fam, i))
                    assert eng.read(ChunkId(fam, i)) == p
                    assert (meta.committed_ver, meta.pending_ver) == (1, 0)
                    assert meta.checksum.value == crc32c_py(p)

    def test_exactly_once_replay_across_path_swap(self, native_chain,
                                                  monkeypatch):
        from tpu3fs_torch.storage.craq import WriteReq

        env = native_chain
        _sync_all(env)
        head = env["nodes"][10]["server"]
        chain_ver = env["mcli"].refresh_routing().chains[CHAIN].chain_version
        cid = ChunkId(32, 0)

        def req(seq, data):
            return WriteReq(chain_id=CHAIN, chain_ver=chain_ver,
                            chunk_id=cid, offset=0, data=data,
                            chunk_size=CHUNK, client_id="xo-cli",
                            channel_id=9, seqnum=seq)

        def fields(r):
            return (r.code, r.update_ver, r.commit_ver, r.checksum.value)

        s0 = head.fastpath_write_stats()
        first = _send(env, 10, "write", req(1, b"once" * 100))
        assert first.ok, first
        assert head.fastpath_write_stats()[0] > s0[0]
        assert fields(_send(env, 10, "write", req(1, b"once" * 100))) == \
            fields(first)
        assert _send(env, 10, "write", req(0, b"never")).code == \
            Code.CHUNK_STALE_UPDATE
        monkeypatch.setenv("TPU3FS_NATIVE_WRITE", "0")
        _sync_all(env)
        assert fields(_send(env, 10, "write", req(1, b"once" * 100))) == \
            fields(first)
        assert _send(env, 10, "write", req(0, b"never")).code == \
            Code.CHUNK_STALE_UPDATE
        for node_id in (10, 11):
            eng = env["nodes"][node_id]["target"].engine
            assert eng.read(cid) == b"once" * 100
            assert eng.get_meta(cid).committed_ver == 1

    def test_skip_crc_bug_commits_divergent_replicas(self, native_chain):
        from tpu3fs_torch.chaos import bugs
        from tpu3fs_torch.client.storage_client import RetryOptions
        from tpu3fs_torch.utils.fault_injection import plane

        env = native_chain
        sc = _client_for(env, retry=RetryOptions(max_retries=0,
                                                 backoff_base_s=0.001))
        _sync_all(env)
        head = env["nodes"][10]["server"]
        chain_ver = env["mcli"].refresh_routing().chains[CHAIN].chain_version
        cid = ChunkId(33, 0)
        assert sc.write_chunk(CHAIN, cid, 0, b"s" * 1000,
                              chunk_size=CHUNK).ok
        for node_id, fill in ((10, b"H"), (11, b"T")):
            eng = env["nodes"][node_id]["target"].engine
            eng.update(cid, 2, chain_ver, fill * 1000, 0, chunk_size=CHUNK)
            eng.commit(cid, 2, chain_ver)
        s0 = head.fastpath_write_stats()
        r = sc.write_chunk(CHAIN, cid, 100, b"x" * 50, chunk_size=CHUNK)
        s1 = head.fastpath_write_stats()
        assert s1[1] > s0[1] and s1[0] == s0[0]
        assert not r.ok and "successor" in r.message
        bugs.arm("native_commit_skip_crc")
        plane().configure("point=storage.read,kind=delay_ms,arg=0")
        try:
            _sync_all(env)
            s2 = head.fastpath_write_stats()
            r2 = sc.write_chunk(CHAIN, cid, 200, b"y" * 50,
                                chunk_size=CHUNK)
            assert r2.ok, r2
            assert head.fastpath_write_stats()[0] > s2[0]
            metas = {nid: env["nodes"][nid]["target"].engine.get_meta(cid)
                     for nid in (10, 11)}
            assert metas[10].committed_ver == metas[11].committed_ver == 3
            assert metas[10].checksum.value != metas[11].checksum.value
        finally:
            bugs.disarm()
            plane().clear()
            _sync_all(env)

    def test_write_fault_rule_stands_head_down(self, native_chain):
        from tpu3fs_torch.utils.fault_injection import plane

        env = native_chain
        sc = _client_for(env)
        plane().configure("point=storage.update,kind=delay_ms,arg=0")
        try:
            _sync_all(env)
            head = env["nodes"][10]["server"]
            s0 = head.fastpath_write_stats()
            assert sc.write_chunk(CHAIN, ChunkId(34, 0), 0, b"d" * 100,
                                  chunk_size=CHUNK).ok
            assert head.fastpath_write_stats()[0] == s0[0]
        finally:
            plane().clear()
        _sync_all(env)
        s1 = env["nodes"][10]["server"].fastpath_write_stats()
        assert sc.write_chunk(CHAIN, ChunkId(34, 1), 0, b"d" * 100,
                              chunk_size=CHUNK).ok
        assert env["nodes"][10]["server"].fastpath_write_stats()[0] > s1[0]


class TestNativeHeadWriteGates:
    def test_tenant_throttle_rides_native_and_python_identically(
            self, native_node, monkeypatch):
        from tpu3fs_torch.client.storage_client import RetryOptions
        from tpu3fs_torch.qos.core import AdmissionController, QosConfig
        from tpu3fs_torch.tenant import registry, tenant_scope

        env = native_node
        server, svc = env["server"], env["svc"]
        sc = _client_for(env, retry=RetryOptions(max_retries=0,
                                                 backoff_base_s=0.001))
        assert sc.write_chunk(CHAIN, ChunkId(40, 0), 0, b"x" * 512,
                              chunk_size=CHUNK).ok
        server.set_admission(AdmissionController(QosConfig()))
        assert sync_read_fastpath(server, svc) == 1
        try:
            registry().configure("tenant=wg-alice,iops=2,burst_s=1")
            s0 = server.fastpath_write_stats()
            shed0 = server.tenant_shed_count()
            with tenant_scope("wg-alice"):
                native = [sc.batch_write(
                    [(CHAIN, ChunkId(40, 1), 0, b"n" * 256)],
                    chunk_size=CHUNK)[0] for _ in range(10)]
            assert server.fastpath_write_stats()[0] > s0[0]
            assert server.tenant_shed_count() > shed0
            throttled = [r for r in native
                         if r.code == Code.TENANT_THROTTLED]
            assert throttled and all(r.retry_after_ms > 0
                                     for r in throttled)
            monkeypatch.setenv("TPU3FS_NATIVE_WRITE", "0")
            sync_read_fastpath(server, svc)
            s1 = server.fastpath_write_stats()
            with tenant_scope("wg-alice"):
                pyth = [sc.batch_write(
                    [(CHAIN, ChunkId(40, 2), 0, b"p" * 256)],
                    chunk_size=CHUNK)[0] for _ in range(10)]
            assert server.fastpath_write_stats()[0] == s1[0]
            py_throttled = [r for r in pyth
                            if r.code == Code.TENANT_THROTTLED]
            assert py_throttled and all(r.retry_after_ms > 0
                                        for r in py_throttled)
            assert sc.write_chunk(CHAIN, ChunkId(40, 3), 0, b"z" * 64,
                                  chunk_size=CHUNK).ok
        finally:
            registry().clear()


def sequence(pkg: str, path, seed: int) -> dict:
    """One seeded write and read sequence on a native chain of two nodes
    of ``pkg``, fast paths synced: single and batch writes, a partial
    overwrite, whole, ranged and missing reads. -> replies, stored bytes
    and metas, and how many calls the C paths served."""
    rng = np.random.default_rng(seed)
    blob = lambda n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()  # noqa: E731
    ChunkId_ = tnc.mod(pkg, "storage.types").ChunkId
    RR = tnc.mod(pkg, "client.storage_client").ReadReq
    env = tnc.build(pkg, path, [(10, 1000), (11, 1001)])
    rec = []
    try:
        tnc.sync_all(env)
        sc = tnc.storage_client(env)
        w = lambda r: (int(r.code), r.update_ver, r.commit_ver,  # noqa: E731
                       r.checksum.value, r.checksum.length)
        for i in range(4):
            rec.append(w(sc.write_chunk(CHAIN, ChunkId_(50, i), 0,
                                        blob(CHUNK - 97 * i),
                                        chunk_size=CHUNK)))
        rec.append([w(r) for r in sc.batch_write(
            [(CHAIN, ChunkId_(51, i), 0, blob(64 + 300 * i))
             for i in range(8)], chunk_size=CHUNK)])
        rec.append(w(sc.write_chunk(CHAIN, ChunkId_(50, 1), 333, blob(999),
                                    chunk_size=CHUNK)))
        reads = ([RR(CHAIN, ChunkId_(50, i), 0, -1) for i in range(4)]
                 + [RR(CHAIN, ChunkId_(51, i), 17, 100) for i in range(8)]
                 + [RR(CHAIN, ChunkId_(52, 0), 0, -1)])
        rec.append([(int(r.code), bytes(r.data), r.commit_ver,
                     r.checksum.value) for r in sc.batch_read(reads)])
        stored = {}
        for nid, n in env["nodes"].items():
            eng = n["target"].engine
            stored[nid] = sorted(
                (m.chunk_id.to_bytes(), m.committed_ver, m.length,
                 m.checksum.value, eng.read(m.chunk_id))
                for m in eng.all_metadata())
        served = sum(n["server"].fastpath_stats()[0]
                     + n["server"].fastpath_write_stats()[0]
                     for n in env["nodes"].values())
    finally:
        tnc.close(env)
    return {"replies": rec, "stored": stored, "served": served}


def test_sequence_equal_across_packages(tmp_path):
    jax = sequence("tpu3fs", tmp_path / "jax", 15)
    port = sequence(PORT, tmp_path / "port", 15)
    assert port["replies"] == jax["replies"]
    assert port["stored"] == jax["stored"]
    assert port["served"] > 0 and jax["served"] > 0


JAX_FIRST = r"""
import sys, tempfile
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from tpu3fs.storage import native_engine as jax_engine
from tpu3fs.rpc import native_net as jax_net
jax_lib = jax_engine._load_lib()
jax_net._load_lib()
import torch_native_cluster as tnc
from tpu3fs_torch.client.storage_client import ReadReq
from tpu3fs_torch.storage.native_engine import _load_lib
from tpu3fs_torch.storage.types import ChunkId
assert _load_lib()._name != jax_lib._name
env = tnc.build("tpu3fs_torch", Path(tempfile.mkdtemp(dir=sys.argv[2])),
                [(10, 1000), (11, 1001)])
try:
    tnc.sync_all(env)
    sc = tnc.storage_client(env)
    data = [bytes([i + 1]) * (4096 - i) for i in range(6)]
    assert all(r.ok for r in sc.batch_write(
        [(tnc.CHAIN, ChunkId(60, i), 0, d) for i, d in enumerate(data)],
        chunk_size=tnc.CHUNK))
    got = sc.batch_read([ReadReq(tnc.CHAIN, ChunkId(60, i), 0, -1)
                         for i in range(6)])
    assert [bytes(r.data) for r in got] == data
    reads = sum(n["server"].fastpath_stats()[0]
                for n in env["nodes"].values())
    writes = env["nodes"][10]["server"].fastpath_write_stats()[0]
    print("served", reads, writes)
    assert reads > 0 and writes > 0
finally:
    tnc.close(env)
"""


def test_fast_path_serves_after_the_jax_libraries_loaded_first(tmp_path):
    """A fresh process dlopens the JAX package's ``native/*.so`` (the same
    ``ce_*`` and rpc symbols) before the port's; the port's fast path
    still serves reads and head writes, counted by its own stats."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, "-c", JAX_FIRST, str(REPO / "tests"), str(tmp_path)],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "served" in out.stdout
