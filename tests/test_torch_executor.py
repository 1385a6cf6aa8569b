"""The concurrency layer on the CPU, each case run over both packages (the
JAX package's ``tpu3fs.utils.{executor,logging}`` and the port's copies):
the worker pool's results, errors, backpressure and shutdown; the
submitter's traffic class, tenant, armed fault points and trace following
a job onto its worker thread; the concurrency limiter and the periodic
runner; ``xlog`` and its rotating file writer; the storage client's
per-node fan-out on its ``client-<id>`` pool, under a stub messenger that
declares ``parallel_fanout`` (no in-process messenger does), joined on
close. Then the port's own rule: the kernel library is built and loaded
once when its first use comes from many threads at once. Every wait is
bounded. Tolerance 0."""

import importlib
import threading
import time
from types import SimpleNamespace
from unittest import mock

import pytest

from tpu3fs_torch import kernels

PACKAGES = ["tpu3fs", "tpu3fs_torch"]


def _pkg(root: str) -> SimpleNamespace:
    return SimpleNamespace(**{name: importlib.import_module(f"{root}.{path}")
                              for name, path in (
        ("ex", "utils.executor"), ("log", "utils.logging"),
        ("result", "utils.result"), ("qos", "qos.core"),
        ("tenant", "tenant.identity"), ("fi", "utils.fault_injection"),
        ("spans", "analytics.spans"))})


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return _pkg(request.param)


@pytest.fixture
def pool_of(pkg):
    pools = []

    def make(name="t", **kw):
        pools.append(pkg.ex.WorkerPool(name, **kw))
        return pools[-1]

    yield make
    for p in pools:
        p.shutdown()


# -- WorkerPool ----------------------------------------------------------------
def test_submit_and_results(pool_of):
    pool = pool_of(num_workers=3)
    futs = [pool.submit(lambda x=i: x * x) for i in range(20)]
    assert [f.get(5) for f in futs] == [i * i for i in range(20)]


def test_exceptions_delivered_via_future(pool_of):
    fut = pool_of(num_workers=1).submit(lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        fut.get(5)


def test_future_get_times_out(pkg, pool_of):
    gate = threading.Event()
    fut = pool_of(num_workers=1).submit(gate.wait, 5)
    try:
        with pytest.raises(pkg.result.FsError) as ei:
            fut.get(0.05)
        assert ei.value.code == pkg.result.Code.RPC_TIMEOUT
    finally:
        gate.set()
    assert fut.get(5) is True


def test_map_runs_all_and_raises_first_error(pool_of):
    done = []

    def work(i):
        if i == 3:
            raise ValueError("boom")
        done.append(i)
        return i

    with pytest.raises(ValueError):
        pool_of(num_workers=2).map(work, range(8))
    assert sorted(done) == [0, 1, 2, 4, 5, 6, 7]


def test_bounded_queue_backpressure(pkg, pool_of):
    pool = pool_of(num_workers=1, queue_cap=2)
    gate = threading.Event()
    try:
        pool.submit(gate.wait, 5)  # occupies the worker
        pool.submit(lambda: None)
        pool.submit(lambda: None)  # the queue is full (cap 2)
        assert pool.queue_depth == 2
        with pytest.raises(pkg.result.FsError) as ei:
            pool.submit(lambda: None, block=False)
        assert ei.value.code == pkg.result.Code.CLIENT_BUSY
        with pytest.raises(pkg.result.FsError):
            pool.submit(lambda: None, timeout=0.05)
    finally:
        gate.set()


def test_submit_after_shutdown_rejected(pkg):
    pool = pkg.ex.WorkerPool("t", num_workers=1)
    pool.shutdown()
    with pytest.raises(pkg.result.FsError) as ei:
        pool.submit(lambda: None)
    assert ei.value.code == pkg.result.Code.SHUTTING_DOWN


def test_shutdown_runs_the_queue_then_joins_every_worker(pkg):
    pool = pkg.ex.WorkerPool("drain", num_workers=2, queue_cap=8)
    futs = [pool.submit(time.sleep, 0.01) for _ in range(6)]
    pool.shutdown(wait=True)
    assert all(f.done() for f in futs)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("drain-")]


# -- context across threads ----------------------------------------------------
def test_qos_class_follows_submit_and_map(pkg, pool_of):
    pool = pool_of(num_workers=3)
    with pkg.qos.tagged(pkg.qos.TrafficClass.RESYNC):
        fut = pool.submit(pkg.qos.current_class)
    untagged = pool.submit(pkg.qos.current_class)
    assert fut.get(5) == pkg.qos.TrafficClass.RESYNC
    assert untagged.get(5) is None
    with pkg.qos.tagged(pkg.qos.TrafficClass.DATALOAD):
        got = pool.map(lambda _i: pkg.qos.current_class(), range(8))
    assert got == [pkg.qos.TrafficClass.DATALOAD] * 8


def test_tenant_follows_submit(pkg, pool_of):
    pool = pool_of(num_workers=2)
    with pkg.tenant.tenant_scope("team-a"):
        fut = pool.submit(pkg.tenant.current_tenant)
    assert fut.get(5) == "team-a"
    assert pool.submit(pkg.tenant.current_tenant).get(5) is None


def test_fault_injection_follows_submit(pkg, pool_of):
    # one worker: the shared times budget decrements without racing
    pool = pool_of(num_workers=1)

    def poke():
        try:
            pkg.fi.inject("pool-point")
            return "clean"
        except pkg.result.FsError as e:
            return e.code

    with pkg.fi.fault_injection(1.0, times=2):
        got = [f.get(5) for f in [pool.submit(poke) for _ in range(4)]]
    assert got.count(pkg.result.Code.FAULT_INJECTION) == 2
    assert got.count("clean") == 2
    assert pool.submit(poke).get(5) == "clean"


def test_trace_follows_map(pkg, pool_of, tmp_path):
    old = pkg.spans._TRACER
    pkg.spans._TRACER = pkg.spans.Tracer()
    try:
        pkg.spans._TRACER.configure(service="wp", node=1, sample_rate=1.0,
                                    directory=str(tmp_path))
        pool = pool_of(num_workers=2)
        with pkg.spans.root_span("client.pool") as ctx:
            got = pool.map(
                lambda _i: pkg.spans.current_trace().trace_id, range(4))
        assert got == [ctx.trace_id] * 4
    finally:
        pkg.spans._TRACER = old


# -- limiter, periodic runner --------------------------------------------------
def test_concurrency_limiter_caps_holders(pkg):
    lim = pkg.ex.ConcurrencyLimiter("t", 2)
    peak, cur, mu = [0], [0], threading.Lock()

    def work():
        with lim:
            with mu:
                cur[0] += 1
                peak[0] = max(peak[0], cur[0])
            time.sleep(0.01)
            with mu:
                cur[0] -= 1

    ts = [threading.Thread(target=work) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(5)
    assert peak[0] == 2 and not any(t.is_alive() for t in ts)
    assert lim.try_acquire(0.0) and lim.try_acquire(0.0)
    assert not lim.try_acquire(0.0)
    lim.release()
    lim.release()


def test_periodic_runner_survives_errors_and_stops(pkg):
    hits = []

    def tick():
        hits.append(1)
        if len(hits) == 1:
            raise RuntimeError("first tick fails")

    r = pkg.ex.PeriodicRunner("t", lambda: 0.02, tick, jitter=0.0)
    r.start()
    deadline = time.monotonic() + 5
    while len(hits) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    r.stop()
    assert len(hits) >= 3
    assert not [t for t in threading.enumerate() if t.name == "runner-t"]


# -- logging -------------------------------------------------------------------
def test_xlog_file_rotation_and_dfatal(pkg, tmp_path):
    path = str(tmp_path / "x.log")
    pkg.log.init_logging(path, "INFO", max_bytes=200, max_files=3)
    try:
        for i in range(20):
            pkg.log.xlog("INFO", "line %d of the log", i)
        pkg.log.xlog("DBG", "below the level")
        with pytest.raises(pkg.log.DFatalError, match="broken 7"):
            pkg.log.xlog("DFATAL", "broken %d", 7)
    finally:
        pkg.log.shutdown_logging()
    text = "".join(open(p).read() for p in sorted(tmp_path.glob("x.log*")))
    assert "line 19 of the log" in text and "below the level" not in text
    assert (tmp_path / "x.log.1").exists()
    assert not [t for t in threading.enumerate() if t.name == "log-writer"]


# -- the storage client's per-node fan-out -------------------------------------
class FanOutMessenger:
    """The fabric's direct dispatch, declaring ``parallel_fanout`` as the
    socket transports do; notes the thread each call runs on."""

    parallel_fanout = True

    def __init__(self, send):
        self._send, self.threads = send, []

    def __call__(self, node_id, method, payload):
        self.threads.append(threading.current_thread().name)
        return self._send(node_id, method, payload)


def test_client_fans_out_per_node_and_close_joins(pkg):
    root = pkg.ex.__name__.split(".")[0]
    fabric = importlib.import_module(f"{root}.fabric.fabric")
    sc_mod = importlib.import_module(f"{root}.client.storage_client")
    stypes = importlib.import_module(f"{root}.storage.types")
    dev = {"device": "cpu"} if root == "tpu3fs_torch" else {}
    fab = fabric.Fabric(fabric.SystemSetupConfig(
        num_storage_nodes=4, num_chains=4, num_replicas=1, chunk_size=4096),
        **dev)
    try:
        msgr = FanOutMessenger(fab.send)
        sc = sc_mod.StorageClient("fan", fab.routing, msgr, **dev)
        chains = sorted(fab.routing().chains)
        writes = [(c, stypes.ChunkId(9, i), 0, bytes([i]) * 512)
                  for i, c in enumerate(chains)]
        assert all(r.ok for r in sc.batch_write(writes))
        reads = sc.batch_read([sc_mod.ReadReq(c, stypes.ChunkId(9, i), 0,
                                              512)
                               for i, c in enumerate(chains)])
        assert [bytes(r.data) for r in reads] == [w[3] for w in writes]
        assert any(n.startswith("client-fan-") for n in msgr.threads)
        sc.close()
    finally:
        fab.close()
    for t in threading.enumerate():
        if t.name.startswith("client-fan-"):
            t.join(10)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("client-fan-")]


# -- the port's own rule -------------------------------------------------------
def test_library_builds_and_loads_once_from_eight_threads(monkeypatch,
                                                          tmp_path):
    builds, loads = [], []

    def fake_build(sources, target):
        builds.append(target)
        time.sleep(0.05)  # a slow nvcc: the other threads arrive meanwhile

    def fake_cdll(path):
        loads.append(path)
        return mock.MagicMock()

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_build", fake_build)
    monkeypatch.setattr(kernels.ctypes, "CDLL", fake_cdll)
    kernels.library.cache_clear()
    start = threading.Barrier(8)
    got = []

    def first_use():
        start.wait(5)
        got.append(kernels.library())

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
        assert len(builds) == 1 and len(loads) == 1 and len(got) == 8
        assert all(lib is got[0] for lib in got)
        assert kernels.library.cache_info().currsize == 1
    finally:
        kernels.library.cache_clear()
    assert kernels.library.cache_info().currsize == 0
