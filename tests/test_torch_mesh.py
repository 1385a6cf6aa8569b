"""The port's single-process device mesh (``parallel.LocalMesh``), the ICI
chain transport on it (``storage/ici_chain.py``) and the EC mesh rebuild
(``EcResyncWorker(mesh=)``), against the JAX package on the 8 virtual CPU
devices of conftest.py.

The same seeded numpy inputs go through ``chain_write_step`` and
``rebuild_lost_shard`` on a JAX ``Mesh`` and on a ``LocalMesh`` of CPU
devices; the JAX package's ICI fabric tests (tests/test_parallel.py) and
its mesh resync (tests/test_ec.py) run in both packages, with the EC
nonces and layout seeds drawn from a seed, and give equal committed
state, replies, hit and fallback counts, rebuilt bytes and moved counts.
Then the port's own cases: the fallback on a SYNCING successor, the
successor chunk locks taken in sorted key order and released in reverse,
a corrupted hop refused at its position, and a process-group mesh
refused. Tolerance 0."""

import dataclasses
import enum

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import tpu3fs.fabric.fabric as jfabric
import tpu3fs.parallel as jpar
import tpu3fs_torch.fabric as tfabric
import tpu3fs_torch.parallel as tpar
from tpu3fs.ops.rs import RSCode as JRSCode
from tpu3fs.storage.engine import MemChunkEngine as JMemEngine
from tpu3fs.storage.types import ChunkId as JChunkId
from tpu3fs_torch.client.storage_client import RetryOptions
from tpu3fs_torch.mgmtd.types import PublicTargetState
from tpu3fs_torch.ops.rs import RSCode as TRSCode
from tpu3fs_torch.parallel import chain as tchain
from tpu3fs_torch.parallel.mesh import LocalMesh
from tpu3fs_torch.storage.engine import MemChunkEngine as TMemEngine
from tpu3fs_torch.storage.types import ChunkId as TChunkId
from torch_fabric_sequence import deterministic, stored


def _devs(n):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip("needs 8 virtual devices (see conftest.py)")
    return devs[:n]


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.uint8)


def plain(x):
    """A reply or record of either package as plain values: dataclasses
    as field dicts, enums by name, Checksums by (value, length)."""
    if isinstance(x, enum.Enum):
        return x.name
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


# -- the mesh and its two collectives ---------------------------------------
@pytest.mark.parametrize("chain_len", [1, 2, 4, 8])
def test_local_mesh_shape_equals_the_jax_mesh(chain_len):
    devs = _devs(8)
    want = jpar.make_storage_mesh(chain_len, devices=devs)
    got = tpar.make_storage_mesh(chain_len, devices=["cpu"] * 8)
    assert isinstance(got, LocalMesh)
    assert dict(got.shape) == dict(want.shape)
    assert list(got.shape) == list(want.shape)
    assert [len(row) for row in got.grid] == [chain_len] * (8 // chain_len)
    assert got.at("chain", 0, "dp", 0) == torch.device("cpu")


def test_local_mesh_refusals_equal_the_jax_mesh():
    devs = _devs(8)
    for bad in (3, 0):
        with pytest.raises(ValueError):
            jpar.make_storage_mesh(bad, devices=devs)
        with pytest.raises(ValueError, match="not divisible"):
            tpar.make_storage_mesh(bad, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="not both"):
        tpar.make_storage_mesh(2, devices=["cpu"] * 8, device="cpu")


@pytest.mark.parametrize("chain_len, batch, size", [
    (4, 8, 64), (2, 4, 32), (8, 3, 100), (1, 8, 7), (4, 6, 4097)])
def test_chain_write_step_equals_jax(chain_len, batch, size):
    devs = _devs(8)
    mesh = jpar.make_storage_mesh(chain_len, devices=devs)
    dp = mesh.shape["dp"]
    batch = -(-batch // dp) * dp
    data = _u8((batch, size), chain_len * 1000 + size)
    want_r, want_ok = jax.jit(
        lambda d: jpar.chain_write_step(mesh, d))(data)
    got_r, got_ok = tpar.chain_write_step(
        tpar.make_storage_mesh(chain_len, devices=["cpu"] * 8),
        torch.from_numpy(data))
    assert tuple(got_r.shape) == (chain_len, batch, size)
    assert np.array_equal(got_r.numpy(), np.asarray(want_r))
    assert np.array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert got_ok.all()


def test_chain_write_step_positions_hold_their_own_buffers():
    mesh = tpar.make_storage_mesh(4, devices=["cpu"] * 4)
    data = torch.from_numpy(_u8((2, 64), 3))
    seen = []

    def hop(prev, buf, pos):
        seen.append((pos, buf.data_ptr(), prev.data_ptr()))
        buf.copy_(prev)

    orig = tchain._hop
    tchain._hop = hop
    try:
        tpar.chain_write_step(mesh, data)
    finally:
        tchain._hop = orig
    assert [p for p, _, _ in seen] == [0, 1, 2, 3]
    bufs = [b for _, b, _ in seen]
    assert len(set(bufs)) == 4 and data.data_ptr() not in bufs
    assert [prev for _, _, prev in seen[1:]] == bufs[:-1]


def test_chain_write_step_flags_a_corrupted_hop():
    mesh = tpar.make_storage_mesh(4, devices=["cpu"] * 8)
    data = torch.from_numpy(_u8((4, 64), 4))

    def hop(prev, buf, pos):
        buf.copy_(prev)
        if pos == 2:
            buf[1, 5] ^= 0x10

    orig = tchain._hop
    tchain._hop = hop
    try:
        _, ok = tpar.chain_write_step(mesh, data)
    finally:
        tchain._hop = orig
    # dp row 0 holds rows 0-1, row 1 rows 2-3: each ring's position 2
    # and its tail got the flipped byte of their row 1
    want = np.ones((4, 4), dtype=bool)
    want[2:, 1] = want[2:, 3] = False
    assert np.array_equal(ok.numpy(), want)


@pytest.mark.parametrize("k, m, lost, batch_axis", [
    (6, 2, [3], None), (6, 2, [0, 7], None), (7, 1, [2], None),
    (7, 1, [7], None), (3, 1, [1], "dp"), (2, 2, [1, 2], "dp")])
def test_rebuild_lost_shard_equals_jax(k, m, lost, batch_axis):
    n = k + m
    devs = _devs(8)
    mesh = jpar.make_storage_mesh(n, devices=devs[:8 // n * n])
    dp = mesh.shape["dp"]
    data = _u8((2 * dp, k, 96), n * 10 + len(lost))
    parity = JRSCode(k, m).encode_np(data)
    shards = np.moveaxis(np.concatenate([data, parity], axis=1), 1, 0).copy()
    shards[lost] = 0
    want = np.asarray(jpar.rebuild_lost_shard(mesh, shards, JRSCode(k, m),
                                              lost, batch_axis=batch_axis))
    got = tpar.rebuild_lost_shard(
        tpar.make_storage_mesh(n, devices=["cpu"] * (8 // n * n)),
        torch.from_numpy(shards), TRSCode(k, m, device="cpu"), lost,
        batch_axis=batch_axis)
    assert np.array_equal(got.numpy(), want)
    full = np.moveaxis(np.concatenate([data, parity], axis=1), 1, 0)
    assert np.array_equal(got.numpy(), full[lost])


def test_rebuild_lost_shard_refusals():
    mesh = tpar.make_storage_mesh(4, devices=["cpu"] * 8)
    shards = torch.zeros((4, 2, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="k\\+m=5"):
        tpar.rebuild_lost_shard(mesh, shards, TRSCode(3, 2, device="cpu"),
                                [0])
    with pytest.raises(ValueError, match="cannot rebuild 2"):
        tpar.rebuild_lost_shard(mesh, shards, TRSCode(3, 1, device="cpu"),
                                [0, 1])
    with pytest.raises(ValueError, match="codec on meta"):
        tpar.rebuild_lost_shard(mesh, shards, TRSCode(3, 1, device="meta"),
                                [0])


# -- the ICI chain transport --------------------------------------------------
def _ici_fabric(pkg, transport, mesh=None):
    mod = jfabric if pkg == "jax" else tfabric
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return mod.Fabric(mod.SystemSetupConfig(
        num_storage_nodes=1, num_chains=2, num_replicas=4, chunk_size=8192,
        chain_transport=transport, mesh=mesh), **kw)


def _workload(fab, pkg):
    """tests/test_parallel.py's ICI workload: 8 chunks over both chains
    in one batch, then a partial-offset overwrite. -> the replies."""
    cid = JChunkId if pkg == "jax" else TChunkId
    client = fab.storage_client()
    ops = [(fab.chain_ids[i % 2], cid(31, i), 0,
            bytes([0x30 + i]) * (1000 + 317 * i)) for i in range(8)]
    replies = client.batch_write(ops, chunk_size=8192)
    r = client.write_chunk(fab.chain_ids[0], cid(31, 0), 500, b"Z" * 300,
                           chunk_size=8192)
    return plain(list(replies) + [r])


def _ici(fab):
    svc = next(iter(fab.nodes.values())).service
    return svc._ici.hits, svc._ici.fallbacks


def _jax_mesh(shape):
    return Mesh(np.array(_devs(8)[:shape[0] * shape[1]]).reshape(shape),
                ("dp", "chain"))


@pytest.mark.parametrize("shape", [(2, 4), (2, 2)],
                         ids=["width-matches", "width-mismatched"])
def test_ici_fabric_equals_the_jax_fabric(shape):
    """Committed state, replies, hits and fallbacks of the ICI fabric
    equal the JAX package's; both equal the messenger fabric's state; a
    chain axis narrower than the chain falls back on every batch."""
    runs = {}
    for pkg, mesh in (("jax", _jax_mesh(shape)),
                      ("torch", tpar.make_storage_mesh(
                          shape[1], devices=["cpu"] * (shape[0] * shape[1])))):
        with deterministic(seed=1):
            fab = _ici_fabric(pkg, "ici", mesh)
            replies = _workload(fab, pkg)
            runs[pkg] = (replies, stored(fab), _ici(fab))
            fab.close()
        with deterministic(seed=1):
            msg = _ici_fabric(pkg, "messenger")
            assert _workload(msg, pkg) == replies
            assert stored(msg) == runs[pkg][1]
            msg.close()
    assert runs["torch"] == runs["jax"]
    hits, fallbacks = runs["torch"][2]
    if shape == (2, 4):
        assert hits == 2 and fallbacks == 0
    else:
        assert hits == 0 and fallbacks > 0
    assert all(r["code"] == "OK" for r in runs["torch"][0])


def test_ici_fabric_reads_back_through_the_client():
    fab = _ici_fabric("torch", "ici",
                      tpar.make_storage_mesh(4, devices=["cpu"] * 8))
    try:
        _workload(fab, "torch")
        got = fab.storage_client().read_chunk(fab.chain_ids[0],
                                              TChunkId(31, 0))
        want = bytearray(bytes([0x30]) * 1000)
        want[500:800] = b"Z" * 300
        assert got.data == bytes(want)
    finally:
        fab.close()


def test_ici_falls_back_on_a_syncing_successor():
    fab = _ici_fabric("torch", "ici",
                      tpar.make_storage_mesh(4, devices=["cpu"] * 8))
    try:
        chain = fab.routing().chains[fab.chain_ids[0]]
        chain.targets[2].public_state = PublicTargetState.SYNCING
        client = fab.storage_client()
        (r,) = client.batch_write(
            [(fab.chain_ids[0], TChunkId(5, 0), 0, b"s" * 700)],
            chunk_size=8192)
        assert r.ok
        assert _ici(fab) == (0, 4)  # the head and its three successors
        (r,) = client.batch_write(
            [(fab.chain_ids[1], TChunkId(5, 1), 0, b"t" * 700)],
            chunk_size=8192)
        assert r.ok and _ici(fab) == (1, 4)
    finally:
        fab.close()


def test_ici_takes_successor_locks_in_sorted_order():
    fab = _ici_fabric("torch", "ici",
                      tpar.make_storage_mesh(4, devices=["cpu"] * 8))
    try:
        svc = next(iter(fab.nodes.values())).service
        chain = fab.routing().chains[fab.chain_ids[0]]
        succ = {t.target_id for t in chain.targets[1:]}
        taken, released = [], []
        locks = svc._locks
        acquire, release = locks.acquire, locks.release
        locks.acquire = lambda key: (taken.append(key), acquire(key))[1]
        locks.release = lambda key: (released.append(key), release(key))[1]
        ops = [(fab.chain_ids[0], TChunkId(7, i), 0, bytes([i]) * 300)
               for i in (5, 1, 9, 3)]
        assert all(r.ok for r in fab.storage_client().batch_write(
            ops, chunk_size=8192))
        want = sorted(svc._chunk_key(t, TChunkId(7, i))
                      for t in succ for i in (5, 1, 9, 3))
        keys = set(want)
        assert [k for k in taken if k in keys] == want
        assert [k for k in released if k in keys] == want[::-1]
        assert _ici(fab) == (1, 0)
    finally:
        fab.close()


def test_ici_corrupted_hop_is_refused_at_its_position():
    """A hop that flips a byte on its way into position 2: the head's
    batch reply is CHUNK_CHECKSUM_MISMATCH naming position 2, no
    successor installs that batch, and the client's single-op retry (over
    the messenger) lands the write on every replica."""
    fab = _ici_fabric("torch", "ici",
                      tpar.make_storage_mesh(4, devices=["cpu"] * 8))
    batch_replies = []
    send = fab.send

    def spy(node_id, method, *args, **kw):
        got = send(node_id, method, *args, **kw)
        if method == "batch_write":
            batch_replies.extend(got)
        return got

    def hop(prev, buf, pos):
        buf.copy_(prev)
        if pos == 2:
            buf[0, 0] ^= 1

    fab.send = spy
    orig = tchain._hop
    tchain._hop = hop
    try:
        client = fab.storage_client(retry=RetryOptions(max_retries=0))
        (r,) = client.batch_write(
            [(fab.chain_ids[0], TChunkId(8, 0), 0, b"c" * 500)],
            chunk_size=8192)
        assert [b.code.name for b in batch_replies] == \
            ["CHUNK_CHECKSUM_MISMATCH"]
        assert "position 2" in batch_replies[0].message
        assert r.ok and _ici(fab) == (1, 0)
        # no successor installed the refused batch: every replica reads
        # back the retried write, at one version
        chain = fab.routing().chains[fab.chain_ids[0]]
        svc = next(iter(fab.nodes.values())).service
        for t in chain.targets:
            eng = svc.target(t.target_id).engine
            assert eng.read(TChunkId(8, 0)) == b"c" * 500, t.target_id
            assert eng.get_meta(TChunkId(8, 0)).committed_ver == r.commit_ver
    finally:
        tchain._hop = orig
        fab.close()


# -- the EC mesh rebuild ------------------------------------------------------
EC_SHAPES = {"rs_3_1": (3, 1, 1 << 16), "rs_4_2": (4, 2, 1 << 15)}


def _ec_resync(pkg, k, m, chunk, mesh):
    """tests/test_ec.py's mesh resync, with a second stripe: -> (moved,
    the victim's rebuilt shards, the originals, stored state)."""
    mod = jfabric if pkg == "jax" else tfabric
    kw = {} if pkg == "jax" else {"device": "cpu"}
    cid = JChunkId if pkg == "jax" else TChunkId
    fab = mod.Fabric(mod.SystemSetupConfig(
        num_storage_nodes=k + m, num_chains=2, chunk_size=chunk, ec_k=k,
        ec_m=m), **kw)
    try:
        client = fab.storage_client()
        chain = fab.chain_ids[0]
        for i, body in enumerate((b"meshmesh" * (chunk // 8),
                                  bytes(_u8(chunk - 777, k)))):
            assert client.write_stripe(chain, cid(30, i), body,
                                       chunk_size=chunk).ok
        routing = fab.routing()
        t2 = routing.chains[chain].target_of_shard(k - 1)
        victim = routing.node_of_target(t2.target_id).node_id
        svc = fab.nodes[victim].service
        original = [svc.target(t2.target_id).engine.read(cid(30, i))
                    for i in range(2)]
        fab.fail_node(victim)
        svc.target(t2.target_id).engine = (JMemEngine() if pkg == "jax"
                                           else TMemEngine(device="cpu"))
        fab.restart_node(victim)
        moved = fab.resync_all(mesh=mesh)
        rebuilt = [svc.target(t2.target_id).engine.read(cid(30, i))
                   for i in range(2)]
        return moved, rebuilt, original, stored(fab)
    finally:
        fab.close()


@pytest.mark.parametrize("shape", sorted(EC_SHAPES))
def test_ec_mesh_resync_equals_the_jax_fabric(shape):
    k, m, chunk = EC_SHAPES[shape]
    devs = _devs(k + m)
    runs = {}
    for pkg, mesh in (
            ("jax", jpar.make_storage_mesh(k + m, devices=devs)),
            ("torch", tpar.make_storage_mesh(k + m,
                                             devices=["cpu"] * (k + m))),
            ("torch-no-mesh", None)):
        with deterministic(seed=2):
            runs[pkg] = _ec_resync(pkg.split("-")[0], k, m, chunk, mesh)
    moved, rebuilt, original, state = runs["torch"]
    assert moved >= 2 and rebuilt == original
    assert runs["torch"] == runs["jax"]
    assert runs["torch-no-mesh"] == runs["torch"]


def test_ec_mesh_resync_decodes_through_the_mesh(monkeypatch):
    from tpu3fs_torch.parallel import rebuild

    calls = []
    real = rebuild.rebuild_lost_shard

    def spy(mesh, shards, rs, lost, **kw):
        calls.append((mesh, tuple(lost)))
        return real(mesh, shards, rs, lost, **kw)

    monkeypatch.setattr(rebuild, "rebuild_lost_shard", spy)
    mesh = tpar.make_storage_mesh(6, devices=["cpu"] * 6)
    with deterministic(seed=2):
        moved, rebuilt, original, _ = _ec_resync("torch", 4, 2, 1 << 15,
                                                 mesh)
    assert rebuilt == original and moved >= 2
    # every shard outside the k survivors is declared lost: m of them
    assert calls and all(m is mesh and len(lost) == 2 for m, lost in calls)


# -- refusals of a process-group mesh ----------------------------------------
def test_a_process_group_mesh_is_refused():
    from tpu3fs_torch.storage.ec_resync import EcResyncWorker
    from tpu3fs_torch.storage.craq import StorageService

    with pytest.raises(ValueError, match="needs a mesh"):
        _ici_fabric("torch", "ici")
    with pytest.raises(TypeError, match="LocalMesh"):
        from tpu3fs_torch.storage.ici_chain import IciChainReplicator
        IciChainReplicator(object())
    svc = StorageService(10, lambda: None, device="cpu")
    with pytest.raises(NotImplementedError, match="M7/M8"):
        EcResyncWorker(svc, lambda *a: None, mesh=object(), device="cpu")
