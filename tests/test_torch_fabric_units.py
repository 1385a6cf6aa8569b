"""The serving stack's host modules in the port, on the CPU, each case run
over both packages (the JAX package's module and the port's copy): the
mem KV's transactions and conflicts, serde round trips (and the port's
bytes equal to the JAX package's on the same records), MetaStore's create,
open, rename, truncate and remove, mgmtd's heartbeat timeout and chain
state steps, the health registry's breaker and the hedge controller. Then
the port's own rules: the unported options raise, the default device is
the card, and the launch counters and codec caches stay exact under
threads. Tolerance 0."""

import importlib
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

PACKAGES = ["tpu3fs", "tpu3fs_torch"]


def _pkg(root: str) -> SimpleNamespace:
    mods = {name: importlib.import_module(f"{root}.{path}") for name, path in (
        ("kv", "kv"), ("kvkv", "kv.kv"), ("serde", "rpc.serde"),
        ("meta", "meta.store"), ("mtypes", "meta.types"),
        ("mgmtd", "mgmtd.service"), ("gtypes", "mgmtd.types"),
        ("chain_sm", "mgmtd.chain_sm"), ("health", "rpc.health"),
        ("hedging", "client.hedging"), ("result", "utils.result"))}
    return SimpleNamespace(**mods)


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return _pkg(request.param)


def _commit(eng, **kvs):
    txn = eng.transaction()
    for k, v in kvs.items():
        txn.set(k.encode(), v.encode())
    txn.commit()


# -- kv ------------------------------------------------------------------------
def test_mem_kv_reads_its_writes_and_ranges(pkg):
    eng = pkg.kv.MemKVEngine()
    _commit(eng, a="1", b="2", c="3", d="4")
    txn = eng.transaction()
    txn.set(b"bb", b"new")
    assert txn.get(b"bb") == b"new"
    txn.clear_range(b"b", b"c")
    assert [(p.key, p.value) for p in txn.get_range(b"a", b"z")] == [
        (b"a", b"1"), (b"c", b"3"), (b"d", b"4")]
    txn.commit()
    assert eng.transaction().get(b"b") is None
    assert [k for k, _ in eng.dump_at(eng.version)] == [b"a", b"c", b"d"]


def test_mem_kv_conflict_and_retry(pkg):
    eng = pkg.kv.MemKVEngine()
    _commit(eng, n="0")
    t1, t2 = eng.transaction(), eng.transaction()
    for t in (t1, t2):
        t.set(b"n", str(int(t.get(b"n")) + 1).encode())
    t1.commit()
    with pytest.raises(pkg.result.FsError) as ei:
        t2.commit()
    assert ei.value.code == pkg.result.Code.KV_CONFLICT

    def bump(txn):
        txn.set(b"n", str(int(txn.get(b"n")) + 1).encode())

    threads = [threading.Thread(target=lambda: pkg.kv.with_transaction(
        eng, bump, pkg.kvkv.RetryConfig(max_retries=100))) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert eng.transaction().get(b"n") == b"9"


# -- serde ---------------------------------------------------------------------
def _records(p) -> list:
    g, m = p.gtypes, p.mtypes
    layout = m.Layout(table_id=1, chains=[900_001, 900_002], chunk_size=1 << 20,
                      seed=77)
    return [
        g.NodeInfo(10, g.NodeType.STORAGE, status=g.NodeStatus.HEARTBEAT_CONNECTED,
                   heartbeat_version=3, last_heartbeat=1.5),
        g.ChainInfo(900_001, 4, [g.ChainTarget(1000, g.PublicTargetState.SERVING),
                                 g.ChainTarget(1001, g.PublicTargetState.OFFLINE)],
                    [1000, 1001], ec_k=12, ec_m=4),
        g.TargetInfo(1000, node_id=10, chain_id=900_001,
                     public_state=g.PublicTargetState.SYNCING,
                     local_state=g.LocalTargetState.ONLINE),
        g.ChainTable(1, chain_ids=[900_001, 900_002]),
        m.Inode(42, m.InodeType.FILE, m.Acl(1000, 100, 0o640), 1, 1.5, 2.5,
                3.5, layout=layout),
        m.DirEntry(1, "nameé", 42, m.InodeType.FILE),
    ]


@pytest.mark.parametrize("index", range(6))
def test_serde_round_trip_and_bytes_equal_jax(index):
    jax_pkg, port = _pkg("tpu3fs"), _pkg("tpu3fs_torch")
    want, rec = _records(jax_pkg)[index], _records(port)[index]
    wire = port.serde.serialize(rec)
    assert wire == jax_pkg.serde.serialize(want)
    assert port.serde.deserialize(wire, type(rec)) == rec
    assert jax_pkg.serde.deserialize(wire, type(want)) == want


# -- meta ----------------------------------------------------------------------
def test_metastore_create_open_rename_truncate_remove(pkg):
    store = pkg.meta.MetaStore(pkg.kv.MemKVEngine(),
                               pkg.meta.ChainAllocator(1, [101, 102, 103]))
    F = pkg.meta.OpenFlags
    res = store.create("/a", flags=F.WRITE, client_id="c")
    assert res.session_id and res.inode.layout.chains == [101]
    a = store.close(res.inode.id, res.session_id, length_hint=5000)
    assert a.length == 5000
    with pytest.raises(pkg.result.FsError) as ei:
        store.create("/a", flags=F.CREATE | F.EXCL)
    assert ei.value.code == pkg.result.Code.META_EXISTS
    r2 = store.open("/a", flags=F.WRITE | F.TRUNC, client_id="c")
    assert r2.session_id and store.stat("/a").length == 0
    store.close(r2.inode.id, r2.session_id, length_hint=9000)
    store.truncate("/a", 4096)
    assert store.stat("/a").length == 4096
    store.mkdirs("/d")
    store.rename("/a", "/d/b")
    assert store.stat("/d/b").id == a.id
    with pytest.raises(pkg.result.FsError):
        store.stat("/a")
    assert [e.name for e in store.list_dir("/d")] == ["b"]
    store.remove("/d/b")
    assert [i.id for i in store.gc_scan()] == [a.id]
    store.gc_finish(a.id)
    assert store.gc_scan() == []


# -- mgmtd ---------------------------------------------------------------------
def _states(targets):
    return [(t.target_id, t.public_state.name) for t in targets]


def test_mgmtd_heartbeat_timeout_and_chain_steps(pkg):
    clock = SimpleNamespace(t=1000.0)
    LS = pkg.gtypes.LocalTargetState
    m = pkg.mgmtd.Mgmtd(1, pkg.kv.MemKVEngine(),
                        pkg.mgmtd.MgmtdConfig(lease_length_s=60,
                                              heartbeat_timeout_s=60),
                        clock=lambda: clock.t)
    m.extend_lease()
    for node in (10, 11, 12):
        m.register_node(node, pkg.gtypes.NodeType.STORAGE)
    for t, node in ((101, 10), (102, 11), (103, 12)):
        m.create_target(t, node_id=node)
    m.upload_chain(900001, [101, 102, 103])
    m.upload_chain_table(1, [900001])
    for i, node in enumerate((10, 11, 12)):
        m.heartbeat(node, 1, {101 + i: LS.UPTODATE})
    v0 = m.get_routing_info().version
    with pytest.raises(pkg.result.FsError) as ei:
        m.heartbeat(10, 0)
    assert ei.value.code == pkg.result.Code.MGMTD_STALE_HEARTBEAT
    clock.t += 61  # node 11 goes silent past the timeout
    m.heartbeat(10, 2, {101: LS.UPTODATE})
    m.heartbeat(12, 2, {103: LS.UPTODATE})
    m.tick()
    ri = m.get_routing_info()
    c = ri.chains[900001]
    assert ri.version > v0 and c.chain_version == 2
    assert _states(c.targets) == [(101, "SERVING"), (103, "SERVING"),
                                  (102, "OFFLINE")]
    m.heartbeat(11, 3, {102: LS.ONLINE})
    m.tick()
    assert m.get_routing_info().chains[900001].targets[-1].public_state.name \
        == "SYNCING"
    m.heartbeat(11, 4, {102: LS.UPTODATE})
    m.tick()
    assert all(t.public_state.name == "SERVING"
               for t in m.get_routing_info().chains[900001].targets)


def test_chain_state_machine_steps(pkg):
    """A dead serving target goes OFFLINE to the chain's end, comes back
    through WAITING (no source yet) or SYNCING, and serves once up to date;
    the chain version moves only on a change."""
    g = pkg.gtypes
    LS = g.LocalTargetState

    def chain(*states):
        return g.ChainInfo(7, 1, [
            g.ChainTarget(t, g.PublicTargetState[ps], LS[ls])
            for t, (ps, ls) in enumerate(states, start=1)], [1, 2, 3])

    c, changed = pkg.chain_sm.step_chain(chain(
        ("SERVING", "UPTODATE"), ("SERVING", "OFFLINE"),
        ("SERVING", "UPTODATE")))
    assert changed and c.chain_version == 2
    assert _states(c.targets) == [(1, "SERVING"), (3, "SERVING"),
                                  (2, "OFFLINE")]
    same, changed = pkg.chain_sm.step_chain(c)
    assert not changed and same.chain_version == 2
    c, _ = pkg.chain_sm.step_chain(chain(
        ("SERVING", "UPTODATE"), ("OFFLINE", "ONLINE"), ("OFFLINE", "ONLINE")))
    assert _states(c.targets) == [(1, "SERVING"), (2, "SYNCING"),
                                  (3, "WAITING")]
    c, _ = pkg.chain_sm.step_chain(chain(
        ("SERVING", "UPTODATE"), ("SYNCING", "UPTODATE"), ("WAITING", "ONLINE")))
    assert _states(c.targets) == [(1, "SERVING"), (2, "SERVING"),
                                  (3, "SYNCING")]
    c, _ = pkg.chain_sm.step_chain(chain(
        ("SERVING", "OFFLINE"), ("SERVING", "OFFLINE"), ("OFFLINE", "OFFLINE")))
    assert _states(c.targets) == [(1, "LASTSRV"), (2, "OFFLINE"),
                                  (3, "OFFLINE")]


# -- health and hedging --------------------------------------------------------
def test_health_registry_breaker(pkg):
    clock = [0.0]
    reg = pkg.health.HealthRegistry(clock=lambda: clock[0],
                                    error_threshold=3, cooldown_s=5.0)
    for _ in range(3):
        reg.observe("p", 0.0, ok=False)
    assert reg.state("p") == pkg.health.BreakerState.OPEN
    assert not reg.allow("p")
    clock[0] += 6.0
    assert reg.allow("p") and not reg.allow("p")  # one half-open probe
    reg.observe("p", 0.002, ok=True)
    assert reg.state("p") == pkg.health.BreakerState.CLOSED
    assert (reg.opened_total, reg.closed_total, reg.probe_total) == (1, 1, 1)


def test_hedge_controller_backup_wins_and_budget(pkg):
    """A primary still out after the delay is hedged and the backup wins;
    with the one token spent the next is suppressed. Each primary holds
    until the outcome it waits on is decided, so load cannot reorder
    them."""
    ctl = pkg.hedging.HedgeController(budget_ratio=0.0, burst=1.0,
                                      delay_floor_ms=1.0)
    release = threading.Event()

    def held():
        release.wait(30)
        return "slow"

    reply, hedged, backup_won = pkg.hedging.run_hedged(
        held, lambda: "fast", 0.002, ctl)
    release.set()
    assert (reply, hedged, backup_won) == ("fast", True, True)

    def until_suppressed():
        deadline = time.monotonic() + 30
        while ctl.stats()["suppressed"] == 0 and time.monotonic() < deadline:
            time.sleep(0.001)
        return "slow"

    reply, hedged, _ = pkg.hedging.run_hedged(
        until_suppressed, lambda: "b", 0.002, ctl)
    assert reply == "slow" and not hedged  # the one token is spent
    assert ctl.stats()["sent"] == 1 and ctl.stats()["suppressed"] == 1


# -- the port's own rules ------------------------------------------------------
def _cpu_fabric(**kw):
    from tpu3fs_torch.fabric import Fabric, SystemSetupConfig

    return Fabric(SystemSetupConfig(**kw), device="cpu")


def test_file_client_prefetch_raises():
    """Readahead runs in the port (``prefetch=True`` no longer raises
    NotImplementedError). A readahead whose fetch raises installs nothing
    and is counted in ``failures``; the reads go the normal path and stay
    exact; closing the client joins its ``prefetch`` workers."""
    from tpu3fs_torch.client import FileIoClient
    from tpu3fs_torch.meta.store import OpenFlags

    # threads of other tests in this process (the JAX package's readahead
    # names its workers prefetch-* too) are not this client's
    before = set(threading.enumerate())
    fab = _cpu_fabric(num_storage_nodes=3, num_chains=2, num_replicas=2,
                      chunk_size=64 << 10)
    data = bytes(range(256)) * 1024
    res = fab.meta.create("/pf", flags=OpenFlags.WRITE, client_id="t")
    fab.file_client().write(res.inode, 0, data)
    fab.meta.close(res.inode.id, res.session_id, length_hint=len(data),
                   wrote=True)
    inode = fab.meta.stat("/pf")
    fio = FileIoClient(fab.storage_client(), prefetch=True)
    pf = fio.prefetcher

    def broken(*_):
        raise RuntimeError("planted readahead failure")

    pf._fetch = broken
    try:
        got = b"".join(fio.read(inode, off, 16 << 10)
                       for off in range(0, len(data), 16 << 10))
        deadline = time.monotonic() + 5
        while pf._inflight and time.monotonic() < deadline:
            time.sleep(0.01)
        assert got == data
        assert pf.failures._value > 0 and pf.hits._value == 0
        assert pf.cached_bytes() == 0
    finally:
        fio.close()
    assert not [t for t in set(threading.enumerate()) - before
                if t.name.startswith("prefetch-") and t.is_alive()]


@pytest.mark.parametrize("option, error, match", [
    (dict(chain_transport="ici"), NotImplementedError, "M8"),
    (dict(mesh=object()), NotImplementedError, "M8"),
    (dict(engine="native"), ValueError, "mem engine"),
])
def test_fabric_refuses_unported_options(option, error, match):
    with pytest.raises(error, match=match):
        _cpu_fabric(**option)


def test_fabric_resync_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="M7"):
        _cpu_fabric().resync_all(mesh=object())


def test_fabric_and_client_default_to_the_card():
    from tpu3fs_torch.client import StorageClient
    from tpu3fs_torch.fabric import Fabric

    if torch.cuda.is_available():
        assert Fabric().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Fabric()
    fab = _cpu_fabric()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StorageClient("c", fab.routing, fab.send)
    assert fab.storage_client().device.type == "cpu"
    assert all(t.engine.device.type == "cpu" for n in fab.nodes.values()
               for t in n.service.targets())


def _run_threads(target, n: int = 8, timeout_s: float = 120.0) -> None:
    """``n`` threads of ``target`` with a short switch interval, so a
    lost update in a read-modify-write shows; each join is bounded."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=target) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout_s)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)


def test_launch_counters_exact_under_threads():
    from tpu3fs_torch import kernels

    def fn():
        pass

    fn.launches = 0

    def bump():
        for _ in range(20_000):
            kernels.count(fn)

    _run_threads(bump)
    assert fn.launches == 8 * 20_000


def test_one_codec_from_8_threads_counts_exactly():
    """One codec shared by 8 threads, as the services' forward helpers,
    update workers and hedged reads share one: every result right, the
    plain versions' call counts exact, each decode matrix built once."""
    from tpu3fs_torch.ops.crc32c import BatchCrc32c
    from tpu3fs_torch.ops.gf2_matmul import gf2_matmul_plain
    from tpu3fs_torch.ops.stripe import StripeCodec
    from tpu3fs_torch.ops.xor_reduce import xor_reduce_plain

    codec = StripeCodec(4, 2, 512, device="cpu")
    data = np.random.default_rng(4).integers(0, 256, (3, 4, 512), np.uint8)
    shards, crcs = codec.encode_batch(data)
    present, lost = [1, 2, 3, 4], [0]  # the XOR rebuild (K3)
    present2, lost2 = [0, 3, 4, 5], [1, 2]  # a K1 decode
    k1, k2, k3 = (gf2_matmul_plain.calls, BatchCrc32c.compute.calls,
                  xor_reduce_plain.calls)
    fns, errors, rounds = [], [], 25
    barrier = threading.Barrier(8)

    def work():
        barrier.wait()
        try:
            for _ in range(rounds):
                s, c = codec.encode_batch(data)
                r1 = codec.reconstruct_batch(present, lost, shards[:, present])
                r2 = codec.reconstruct_batch(present2, lost2,
                                             shards[:, present2])
                d = codec.delta_parity(2, shards[0, 2])
                ok = (np.array_equal(s, shards) and np.array_equal(c, crcs)
                      and np.array_equal(r1, shards[:, lost])
                      and np.array_equal(r2, shards[:, lost2])
                      and np.array_equal(d, codec.rs.encode_np(
                          np.eye(4, dtype=np.uint8)[2][:, None]
                          * shards[0, 2])))
                if not ok:
                    errors.append("wrong bytes")
            fns.append(codec.rs.reconstruct_fn(present2, lost2))
        except Exception as e:  # reported below, with the thread's error
            errors.append(repr(e))

    _run_threads(work)
    assert errors == []
    n = 8 * rounds
    assert gf2_matmul_plain.calls - k1 == 3 * n  # encode, decode, delta
    assert BatchCrc32c.compute.calls - k2 == n
    assert xor_reduce_plain.calls - k3 == n
    assert len({id(f) for f in fns}) == 1


class _SlowTake:
    """A queue whose ``get`` returns only after ``delay_s``: the window in
    which a runner has taken an attempt but is still counted idle."""

    def __init__(self, q, delay_s):
        self._q, self._delay = q, delay_s

    def put(self, fn):
        self._q.put(fn)

    def get(self):
        fn = self._q.get()
        time.sleep(self._delay)
        return fn


def test_hedge_runner_pool_never_queues_a_backup_behind_its_primary():
    """With one runner idle, a primary that blocks and a backup submitted
    at once: the backup gets a runner of its own. (The JAX package's pool
    spawned only when no runner was idle, so a runner about to take the
    primary left the backup queued behind it; seen as a lost hedge in a
    loaded test run.)"""
    from tpu3fs_torch.client.hedging import _RunnerPool

    pool = _RunnerPool()
    warm = threading.Event()
    pool.submit(warm.set)
    assert warm.wait(10)
    deadline = time.monotonic() + 10
    while pool._idle != 1 and time.monotonic() < deadline:
        time.sleep(0.001)
    pool._q = _SlowTake(pool._q, 0.2)
    release, ran = threading.Event(), threading.Event()
    try:
        pool.submit(lambda: release.wait(30))
        pool.submit(ran.set)
        assert ran.wait(5), "the second attempt waited behind the first"
    finally:
        release.set()
