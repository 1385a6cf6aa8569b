"""The file client's readahead on the CPU, each case run over both packages
(the JAX package's ``tpu3fs.client.prefetch`` and ``FileIoClient`` and the
port's copies, on the port's ``Fabric(device="cpu")``): the cases of
``tests/test_readpath.py``'s prefetcher (sequential hits, invalidation on
write, truncate and remove, read-after-write, bounded memory, the reader's
traffic class and tenant on the readahead, the shuffle guard and its
recovery, batch reads, waiting on a window in flight, a stale window never
installed), a readahead over an RS(4,2) fabric with one node failed whose
decodes run on the readahead threads, and no ``prefetch`` worker alive
after the client closes. Every wait is bounded. Tolerance 0.

Left out of ``tests/test_readpath.py``: ``TestFusePrefetch`` (``fuse/`` is
not ported), and the socket, framing and native cases (ROADMAP M6a-2)."""

import importlib
import random
import threading
import time
from types import SimpleNamespace

import pytest

from torch_ckpt_sequence import SHAPES

PACKAGES = ["tpu3fs", "tpu3fs_torch"]
CHUNK = 64 << 10


def _pkg(root: str) -> SimpleNamespace:
    mods = {name: importlib.import_module(f"{root}.{path}") for name, path in (
        ("fio", "client.file_io"), ("pf", "client.prefetch"),
        ("fabric", "fabric.fabric"), ("meta", "meta.store"),
        ("qos", "qos.core"), ("tenant", "tenant.identity"),
        ("stripe", "ops.stripe"))}
    pkg = SimpleNamespace(**mods)
    pkg.dev = {"device": "cpu"} if root == "tpu3fs_torch" else {}
    return pkg


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return _pkg(request.param)


@pytest.fixture
def fab(pkg):
    f = pkg.fabric.Fabric(pkg.fabric.SystemSetupConfig(
        num_storage_nodes=3, num_chains=2, num_replicas=2, chunk_size=CHUNK),
        **pkg.dev)
    yield f
    f.close()


def _mkfile(pkg, fab, path: str, data: bytes):
    res = fab.meta.create(path, flags=pkg.meta.OpenFlags.WRITE, client_id="t")
    fab.file_client().write(res.inode, 0, data)
    fab.meta.close(res.inode.id, res.session_id, length_hint=len(data),
                   wrote=True)
    return fab.meta.stat(path)


@pytest.fixture
def pfio(pkg, fab):
    clients = []

    def make(**cfg):
        clients.append(pkg.fio.FileIoClient(
            fab.storage_client(), prefetch=pkg.pf.PrefetchConfig(**cfg)))
        return clients[-1]

    yield make
    for c in clients:
        c.close()


def _drain(pf, timeout: float = 5.0) -> None:
    """Wait (bounded) for in-flight readahead to settle."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with pf._mu:
            if not pf._inflight:
                return
        time.sleep(0.01)


def _wait_inflight(pf, timeout: float = 5.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with pf._mu:
            if pf._inflight:
                return
        time.sleep(0.005)
    raise AssertionError("prefetch never went in flight")


def prefetch_threads() -> list:
    return [t for t in threading.enumerate() if t.name.startswith("prefetch-")]


def _no_prefetch_worker_left() -> bool:
    for t in prefetch_threads():
        t.join(10)
    return not prefetch_threads()


# -- the prefetcher's contract ---------------------------------------------------
def test_sequential_scan_hits_and_matches(pkg, fab, pfio):
    data = bytes(range(256)) * (8 * CHUNK // 256)
    inode = _mkfile(pkg, fab, "/seq", data)
    fio = pfio(window_bytes=2 * CHUNK, min_run=2)
    step = CHUNK // 4
    got = bytearray()
    for off in range(0, len(data), step):
        got += fio.read(inode, off, step)
    assert bytes(got) == data
    assert fio.prefetcher.hits._value > 0


def test_invalidation_on_write(pkg, fab, pfio):
    inode = _mkfile(pkg, fab, "/waw", b"a" * (4 * CHUNK))
    fio = pfio(window_bytes=2 * CHUNK, min_run=2)
    step = CHUNK // 2
    for off in range(0, 4 * CHUNK, step):
        fio.read(inode, off, step)
    assert fio.prefetcher.cached_bytes() > 0
    fio.write(inode, 0, b"b" * (4 * CHUNK))
    assert fio.prefetcher.cached_bytes() == 0
    for off in range(0, 4 * CHUNK, step):
        assert fio.read(inode, off, step) == b"b" * step


def test_invalidation_on_truncate_and_remove(pkg, fab, pfio):
    inode = _mkfile(pkg, fab, "/trunc", b"c" * (4 * CHUNK))
    fio = pfio(window_bytes=2 * CHUNK, min_run=2)
    for off in range(0, 4 * CHUNK, CHUNK):
        fio.read(inode, off, CHUNK)
    assert fio.prefetcher.cached_bytes() > 0
    fio.truncate_chunks(inode, CHUNK)
    assert fio.prefetcher.cached_bytes() == 0
    for off in range(0, CHUNK, CHUNK // 4):
        fio.read(inode, off, CHUNK // 4)
    fio.remove_chunks(inode)
    assert fio.prefetcher.cached_bytes() == 0


def test_read_after_write_visibility_same_client(pkg, fab, pfio):
    inode = _mkfile(pkg, fab, "/rw", b"x" * (2 * CHUNK))
    fio = pfio(min_run=1, window_bytes=2 * CHUNK)
    assert fio.read(inode, 0, CHUNK) == b"x" * CHUNK
    assert fio.read(inode, CHUNK, CHUNK) == b"x" * CHUNK
    fio.write(inode, 0, b"y" * CHUNK)
    assert fio.read(inode, 0, CHUNK) == b"y" * CHUNK


def test_bounded_memory_adversarial(pkg, fab, pfio):
    cap = 4 * CHUNK
    files = [_mkfile(pkg, fab, f"/adv{i}", bytes([i]) * (8 * CHUNK))
             for i in range(4)]
    fio = pfio(window_bytes=2 * CHUNK, min_run=2, max_cache_bytes=cap,
               max_inflight=2)
    rng = random.Random(3)
    offs = [o * CHUNK for o in range(8)]
    for _ in range(4):
        rng.shuffle(offs)
        prev = None
        for inode in files:
            for off in offs:
                if prev is not None and prev == off:
                    continue
                fio.read(inode, off, CHUNK // 2)
                prev = off + CHUNK // 2
    assert fio.prefetcher.cached_bytes() == 0
    for i, inode in enumerate(files):
        for off in range(0, 8 * CHUNK, CHUNK):
            assert fio.read(inode, off, CHUNK) == bytes([i]) * CHUNK
    _drain(fio.prefetcher)
    assert fio.prefetcher.cached_bytes() <= cap


def test_prefetch_runs_under_the_readers_class_and_tenant(pkg, fab, pfio):
    inode = _mkfile(pkg, fab, "/cls", b"q" * (8 * CHUNK))
    fio = pfio(window_bytes=2 * CHUNK, min_run=2)
    seen, orig = [], fio.prefetcher._fetch

    def spy(ino, off, n):
        seen.append((threading.current_thread().name,
                     pkg.qos.current_class(), pkg.tenant.current_tenant()))
        return orig(ino, off, n)

    fio.prefetcher._fetch = spy
    with pkg.qos.tagged(pkg.qos.TrafficClass.CKPT), \
            pkg.tenant.tenant_scope("team-b"):
        for off in range(0, 8 * CHUNK, CHUNK):
            assert fio.read(inode, off, CHUNK) == b"q" * CHUNK
    _drain(fio.prefetcher)
    assert seen
    assert all(name.startswith("prefetch-") for name, _, _ in seen)
    assert {c for _, c, _ in seen} == {pkg.qos.TrafficClass.CKPT}
    assert {t for _, _, t in seen} == {"team-b"}


def test_shuffled_batches_do_not_thrash_readahead(pkg, fab, pfio):
    nrec, rec, window = 64, CHUNK // 4, 2 * CHUNK
    inode = _mkfile(pkg, fab, "/shuf", b"r" * (nrec * rec))
    fio = pfio(window_bytes=window, min_run=2)
    rng = random.Random(17)
    adjacent = 0
    for _step in range(16):
        batch = sorted(rng.sample(range(nrec), 12))
        adjacent += sum(1 for a, b in zip(batch, batch[1:]) if b - a == 1)
        for ri in batch:
            fio.read(inode, ri * rec, rec)
    assert adjacent > 10
    _drain(fio.prefetcher)
    assert fio.prefetcher.prefetched_bytes._value <= 2 * window


def test_guard_recovers_for_sequential_reader(pkg, fab, pfio):
    inode = _mkfile(pkg, fab, "/recov", b"s" * (64 * CHUNK))
    fio = pfio(window_bytes=2 * CHUNK, min_run=2)
    for o in random.Random(5).sample(range(0, 64), 32):
        fio.read(inode, o * CHUNK, CHUNK // 2)
    assert fio.prefetcher.cached_bytes() == 0
    for off in range(0, 64 * CHUNK, CHUNK):
        fio.read(inode, off, CHUNK)
    _drain(fio.prefetcher)
    assert fio.prefetcher.hits._value > 0


def test_batch_read_files_rides_the_windows(pkg, fab, pfio):
    datas = [bytes([i + 1]) * (2 * CHUNK) for i in range(3)]
    inodes = [_mkfile(pkg, fab, f"/brf{i}", d) for i, d in enumerate(datas)]
    fio = pfio(window_bytes=2 * CHUNK, min_run=1)
    for inode in inodes:
        fio.read(inode, 0, CHUNK)
        fio.read(inode, CHUNK, CHUNK)
    _drain(fio.prefetcher)
    assert fio.batch_read_files([(i, 0, 2 * CHUNK) for i in inodes]) == datas


class _Ino:
    def __init__(self, ino):
        self.id, self.length = ino, 1 << 20


def test_waiters_hit_the_window_in_flight(pkg):
    gate = threading.Event()
    pf = pkg.pf.ReadaheadPrefetcher(
        lambda inode, off, n: gate.wait(5) and b"z" * n,
        pkg.pf.PrefetchConfig(window_bytes=4096, min_run=1))
    try:
        pf.record_read(_Ino(1), 0, 4096)  # arms [4096, 8192)
        _wait_inflight(pf)
        got = []
        t = threading.Thread(target=lambda: got.append(pf.lookup(1, 4096,
                                                                 4096)))
        t.start()
        gate.set()
        t.join(5)
        assert got == [b"z" * 4096]
    finally:
        pf.close()


def test_stale_window_never_waited_or_installed(pkg):
    gate = threading.Event()
    pf = pkg.pf.ReadaheadPrefetcher(
        lambda inode, off, n: gate.wait(5) and b"s" * n,
        pkg.pf.PrefetchConfig(window_bytes=4096, min_run=1))
    try:
        pf.record_read(_Ino(2), 0, 4096)
        _wait_inflight(pf)
        pf.invalidate(2)
        assert pf.lookup(2, 4096, 4096) is None
        gate.set()
        _drain(pf)
        assert pf.cached_bytes() == 0
    finally:
        pf.close()


# -- degraded readahead and teardown ---------------------------------------------
def test_degraded_readahead_returns_the_written_bytes(pkg, monkeypatch):
    fab = pkg.fabric.Fabric(pkg.fabric.SystemSetupConfig(**SHAPES["ec_4_2"]),
                            **pkg.dev)
    chunk = SHAPES["ec_4_2"]["chunk_size"]
    rng = random.Random(41)
    data = bytes(rng.getrandbits(8) for _ in range(48 * chunk))
    decodes = []
    orig = pkg.stripe.StripeCodec.reconstruct_batch

    def spy(self, *a, **kw):
        decodes.append(threading.current_thread().name)
        return orig(self, *a, **kw)

    try:
        inode = _mkfile(pkg, fab, "/ec", data)
        fab.fail_node(sorted(fab.nodes)[0])
        monkeypatch.setattr(pkg.stripe.StripeCodec, "reconstruct_batch", spy)
        fio = pkg.fio.FileIoClient(fab.storage_client(),
                                   prefetch=pkg.pf.PrefetchConfig(
                                       window_bytes=8 * chunk, min_run=2))
        try:
            got = b"".join(fio.read(inode, off, chunk)
                           for off in range(0, len(data), chunk))
            hits = fio.prefetcher.hits._value
        finally:
            fio.close()
    finally:
        fab.close()
    assert got == data
    assert hits > 0
    assert any(name.startswith("prefetch-") for name in decodes)


def test_no_prefetch_worker_outlives_its_client(pkg, fab):
    inode = _mkfile(pkg, fab, "/td", b"t" * (8 * CHUNK))
    fio = pkg.fio.FileIoClient(fab.storage_client(),
                               prefetch=pkg.pf.PrefetchConfig(
                                   window_bytes=2 * CHUNK, min_run=1))
    for off in range(0, 8 * CHUNK, CHUNK):
        assert fio.read(inode, off, CHUNK) == b"t" * CHUNK
    assert prefetch_threads()
    fio.close()
    assert _no_prefetch_worker_left()
