"""The data-loading package's host cases on the CPU, each run over both
packages (the JAX package's ``tpu3fs.dataload`` and the port's copy): the
cases of ``tests/test_dataload.py`` that need no ``jax.Array`` and no
CLI (record files, coalescing, the Feistel shuffle, dp sharding, the
pipeline, resume, the ``dataload`` QoS class, recorders, transforms and
epoch callbacks, the adaptive gap). Then the port's own rules: one K2
launch a verified ``read_batch``, a record-file writer checksumming one
run a call, no concurrent fetch workers, the card by default.
Tolerance 0.

Left out of ``tests/test_dataload.py``:
``TestCliAndPacker.test_pack_main_and_inspect`` and
``test_admin_cli_pack_and_inspect`` (the pack and admin CLIs are not
ported), and ``TestDpSharding.test_mesh_global_array_content_and_sharding``
(a ``jax.Array``: ``test_torch_dataload_mesh.py`` holds its counterpart).
No case there sets ``LoaderConfig.workers`` above 1, so none is left out
for the port's missing concurrent fetch (ROADMAP M6a), and no case here
covers concurrent fetch in either package."""

import importlib
import math
import time
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

import tpu3fs_torch.ops.crc32c as port_crc
from tpu3fs_torch.dataload import recordio as port_recordio

PACKAGES = ["tpu3fs", "tpu3fs_torch"]
CHUNK = 64 << 10


def _pkg(root: str) -> SimpleNamespace:
    mods = {name: importlib.import_module(f"{root}.{path}") for name, path in (
        ("dl", "dataload"), ("recordio", "dataload.recordio"),
        ("autotune", "dataload.autotune"), ("fabric", "fabric.fabric"),
        ("ckpt", "ckpt"), ("qos", "qos.core"), ("result", "utils.result"),
        ("recorder", "monitor.recorder"))}
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
    f.meta.mkdirs("/data", recursive=True)
    yield f
    f.close()


def _payloads(n, size=1024, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
            for _ in range(n)]


def _dataset(pkg, fab, n=64, size=1024, files=2, seed=0):
    recs = _payloads(n, size, seed)
    fio = fab.file_client()
    paths = []
    per = n // files
    for f in range(files):
        lo = f * per
        hi = n if f == files - 1 else lo + per
        path = f"/data/ds{f}.rec"
        pkg.dl.pack_records(fab.meta, fio, path, recs[lo:hi])
        paths.append(path)
    return pkg.dl.PackedDataset(fab.meta, fio, paths), recs


def _code(pkg, e, name):
    return e.value.code == getattr(pkg.result.Code, name)


def _loader(pkg, ds, **cfg):
    kw = {k: cfg.pop(k) for k in ("state", "dp_rank", "dp_size") if k in cfg}
    return pkg.dl.DataLoader(ds, pkg.dl.LoaderConfig(**cfg), **kw)


# -- record files ---------------------------------------------------------------
def test_round_trip_and_summary(pkg, fab):
    recs = _payloads(32, 1500, seed=3)
    rf = pkg.dl.pack_records(fab.meta, fab.file_client(), "/data/a.rec", recs)
    assert rf.num_records == 32
    assert rf.read(0) == recs[0] and rf.read(31) == recs[31]
    got = rf.read_batch([7, 2, 30, 7])
    assert [bytes(g) for g in got] == [recs[7], recs[2], recs[30], recs[7]]
    s = rf.summary()
    assert s["records"] == 32 and s["payload_bytes"] == 32 * 1500
    assert s["min_record"] == s["max_record"] == 1500


def test_variable_sizes_and_reopen(pkg, fab):
    rng = np.random.default_rng(5)
    recs = [bytes(rng.integers(0, 256, size=int(sz), dtype=np.uint8))
            for sz in rng.integers(1, 5000, size=40)]
    fio = fab.file_client()
    pkg.dl.pack_records(fab.meta, fio, "/data/var.rec", recs)
    rf = pkg.dl.RecordFile.open(fab.meta, fio, "/data/var.rec")
    for i in (0, 13, 39):
        assert rf.read(i) == recs[i]


def test_streaming_writer_matches_buffered_image(pkg, fab):
    recs = _payloads(10, 3000, seed=9)
    fio = fab.file_client()
    w = pkg.dl.RecordFileWriter(fab.meta, fio, "/data/s.rec",
                                num_records=10, buffer_bytes=4096)
    for r in recs:
        w.append(r)
    w.commit()
    inode = fab.meta.stat("/data/s.rec")
    assert fio.read(inode, 0, inode.length) == \
        pkg.recordio.encode_record_file(recs, **pkg.dev)


def test_writer_count_mismatch_rejected(pkg, fab):
    fio = fab.file_client()
    w = pkg.dl.RecordFileWriter(fab.meta, fio, "/data/c.rec", num_records=2)
    w.append(b"x")
    with pytest.raises(pkg.result.FsError) as ei:
        w.commit()
    assert _code(pkg, ei, "INVALID_ARG")
    w.abort()
    w2 = pkg.dl.RecordFileWriter(fab.meta, fio, "/data/c.rec", num_records=1)
    w2.append(b"x")
    with pytest.raises(pkg.result.FsError):
        w2.append(b"y")


def test_crash_before_rename_invisible(pkg, fab):
    fio = fab.file_client()
    w = pkg.dl.RecordFileWriter(fab.meta, fio, "/data/crash.rec")
    w.append(b"payload")
    with pytest.raises(pkg.result.FsError) as ei:
        pkg.dl.RecordFile.open(fab.meta, fio, "/data/crash.rec")
    assert _code(pkg, ei, "META_NOT_FOUND")
    w.abort()
    with pytest.raises(pkg.result.FsError):
        fab.meta.stat("/data/crash.rec.tmp")


def test_record_crc_corruption_detected(pkg, fab):
    recs = _payloads(8, 2048, seed=1)
    fio = fab.file_client()
    rf = pkg.dl.pack_records(fab.meta, fio, "/data/corrupt.rec", recs)
    off, n = rf.extent(3)
    inode = fab.meta.stat("/data/corrupt.rec")
    blob = fio.read(inode, off, 1)
    fio.write(inode, off, bytes([blob[0] ^ 0xFF]))
    rf2 = pkg.dl.RecordFile.open(fab.meta, fio, "/data/corrupt.rec")
    with pytest.raises(pkg.result.FsError) as ei:
        rf2.read(3)
    assert _code(pkg, ei, "DATALOAD_CORRUPT")
    assert len(rf2.read(3, verify=False)) == n
    assert rf2.read(2) == recs[2]
    with pytest.raises(pkg.result.FsError) as ei:
        rf2.read_batch([2, 1, 3, 0])
    assert "[3]: record CRC mismatch" in str(ei.value)


def test_index_corruption_detected_at_open(pkg, fab):
    fio = fab.file_client()
    pkg.dl.pack_records(fab.meta, fio, "/data/badidx.rec", _payloads(4, 512))
    inode = fab.meta.stat("/data/badidx.rec")
    hs = pkg.recordio.HEADER_SIZE
    blob = fio.read(inode, hs, 1)
    fio.write(inode, hs, bytes([blob[0] ^ 0x01]))
    with pytest.raises(pkg.result.FsError) as ei:
        pkg.dl.RecordFile.open(fab.meta, fio, "/data/badidx.rec")
    assert _code(pkg, ei, "DATALOAD_CORRUPT")


def test_bad_magic_rejected(pkg, fab):
    fio = fab.file_client()
    pkg.dl.pack_records(fab.meta, fio, "/data/magic.rec", [b"x"])
    fio.write(fab.meta.stat("/data/magic.rec"), 0, b"NOPE")
    with pytest.raises(pkg.result.FsError) as ei:
        pkg.dl.RecordFile.open(fab.meta, fio, "/data/magic.rec")
    assert _code(pkg, ei, "DATALOAD_CORRUPT")


def test_header_geometry(pkg):
    r = pkg.recordio
    assert r.HEADER_SIZE == 32 and r.data_start(0) == 32
    assert r.data_start(4) == 32 + 64


# -- coalescing and shuffling ----------------------------------------------------
def test_plan_coalesced(pkg):
    plan = pkg.dl.plan_coalesced
    extents = [(0, 100), (150, 100), (1000, 50), (90, 20)]
    spans, places = plan(extents, gap=64, max_span=1 << 20)
    assert spans == [(0, 250), (1000, 50)]
    for k, (off, n) in enumerate(extents):
        si, rel = places[k]
        assert spans[si][0] + rel == off and rel + n <= spans[si][1]
    assert plan([(0, 10), (100, 10)], gap=10)[0] == [(0, 10), (100, 10)]
    assert plan([(0, 10), (15, 10)], gap=10)[0] == [(0, 25)]
    spans, _ = plan([(i * 10, 10) for i in range(10)], gap=0, max_span=30)
    assert all(n <= 30 for _, n in spans) and sum(n for _, n in spans) == 100
    assert plan([]) == ([], [])


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 100, 257, 1024])
def test_feistel_is_permutation(pkg, n):
    perm = pkg.dl.FeistelPermutation(n, seed=1234, epoch=5)
    assert sorted(perm(i) for i in range(n)) == list(range(n))


def test_feistel_deterministic_and_epoch_distinct(pkg):
    F = pkg.dl.FeistelPermutation
    seq = [F(500, seed=7, epoch=0)(i) for i in range(500)]
    assert seq == [F(500, seed=7, epoch=0)(i) for i in range(500)]
    assert seq != [F(500, seed=7, epoch=1)(i) for i in range(500)]
    assert seq != [F(500, seed=8, epoch=0)(i) for i in range(500)]
    perm = F(1 << 40, seed=3, epoch=2)
    vals = {perm(i) for i in (0, 1, 2, (1 << 40) - 1)}
    assert len(vals) == 4 and all(0 <= v < (1 << 40) for v in vals)


# -- dp sharding and the pipeline --------------------------------------------------
@pytest.mark.parametrize("dp_size", [1, 2, 4])
def test_epoch_coverage_no_dup_no_loss(pkg, fab, dp_size):
    ds, _ = _dataset(pkg, fab, n=64)
    perm = ds.permutation(seed=11, epoch=0)
    seen = []
    for step in range(ds.steps_per_epoch(16)):
        flat = [g for r in range(dp_size) for g in ds.batch_ids(
            perm, step, 16, dp_rank=r, dp_size=dp_size)]
        assert len(set(flat)) == 16 and flat == ds.batch_ids(perm, step, 16)
        seen.extend(flat)
    assert sorted(seen) == list(range(64))
    with pytest.raises(pkg.result.FsError):
        ds.batch_ids(perm, 0, 10, dp_rank=0, dp_size=3)


def test_single_replica_rank_slice(pkg, fab):
    ds, recs = _dataset(pkg, fab, n=32, size=128)
    with _loader(pkg, ds, global_batch=8, seed=2, epochs=1, dp_rank=1,
                 dp_size=2) as ld:
        batches = list(ld)
    perm = ds.permutation(seed=2, epoch=0)
    for b in batches:
        assert b.ids == ds.batch_ids(perm, b.step, 8, dp_rank=1, dp_size=2)
        assert [bytes(mv) for mv in b.data] == [recs[g] for g in b.ids]


def test_epochs_and_exact_content(pkg, fab):
    ds, recs = _dataset(pkg, fab, n=48, size=512)
    seen = []
    with _loader(pkg, ds, global_batch=12, seed=5, epochs=2, dtype="uint8",
                 sample_shape=(512,)) as ld:
        for b in ld:
            seen.extend(b.ids)
            for i, gid in enumerate(b.ids):
                assert b.data[i].tobytes() == recs[gid]
    assert sorted(seen[:48]) == sorted(seen[48:]) == list(range(48))
    assert seen[:48] != seen[48:]


def test_bounded_memory_under_stalled_consumer(pkg, fab):
    ds, _ = _dataset(pkg, fab, n=64, size=4096)
    batch_bytes = 8 * 4096
    cap = batch_bytes + 1
    ld = _loader(pkg, ds, global_batch=8, seed=1, epochs=None, depth=4,
                 max_buffered_bytes=cap)
    try:
        deadline = time.monotonic() + 5
        while ld.buffered_bytes() < batch_bytes and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.3)
        assert ld.buffered_bytes() <= cap + batch_bytes
        with ld._mu:
            assert len(ld._buf) <= 4
        assert ld._buffered_gauge._value <= cap + batch_bytes
    finally:
        ld.close()


def test_producer_error_delivered_on_next(pkg, fab):
    ds, _ = _dataset(pkg, fab, n=16, size=1024)
    fio = fab.file_client()
    off, _ = ds.files[0].extent(2)
    inode = fab.meta.stat("/data/ds0.rec")
    blob = fio.read(inode, off, 1)
    fio.write(inode, off, bytes([blob[0] ^ 0xAA]))
    ds2 = pkg.dl.PackedDataset(fab.meta, fab.file_client(),
                               ["/data/ds0.rec", "/data/ds1.rec"])
    with _loader(pkg, ds2, global_batch=16, seed=0, shuffle=False,
                 epochs=1) as ld:
        with pytest.raises(pkg.result.FsError) as ei:
            next(ld)
    assert _code(pkg, ei, "DATALOAD_CORRUPT")
    with pytest.raises(pkg.result.FsError):
        _loader(pkg, ds, global_batch=32)


# -- resume ---------------------------------------------------------------------
def test_batch_too_large_rejected(pkg, fab):
    ds, _ = _dataset(pkg, fab, n=16)
    with pytest.raises(pkg.result.FsError):
        _loader(pkg, ds, global_batch=32)


def test_mid_epoch_resume_exact(pkg, fab):
    ds, _ = _dataset(pkg, fab, n=64, size=256)
    cfg = dict(global_batch=8, seed=21, epochs=3, depth=3)
    with _loader(pkg, ds, **cfg) as full:
        expect = [b.ids for b in full]
    with _loader(pkg, ds, **cfg) as first:
        consumed = [next(first).ids for _ in range(11)]
        st = first.state()
    assert st.epoch == 1 and st.step == 3
    with _loader(pkg, ds, state=st, **cfg) as resumed:
        rest = [b.ids for b in resumed]
    assert consumed + rest == expect


def test_state_mismatch_rejected(pkg, fab):
    ds, _ = _dataset(pkg, fab, n=64)
    S = pkg.dl.DataloadState
    for bad in (S(seed=1, global_batch=16, num_samples=64),
                S(seed=1, global_batch=8, num_samples=32),
                S(seed=2, global_batch=8, num_samples=64)):
        with pytest.raises(pkg.result.FsError) as ei:
            _loader(pkg, ds, global_batch=8, seed=1, state=bad)
        assert _code(pkg, ei, "DATALOAD_STATE_MISMATCH")


def test_state_store_atomic_overwrite(pkg, fab):
    store = pkg.dl.StateStore(fab.meta, fab.file_client(), "/data/l.state")
    for epoch, step in ((1, 4), (2, 0)):
        st = pkg.dl.DataloadState(seed=9, epoch=epoch, step=step,
                                  global_batch=8, num_samples=64)
        store.save(st)
        assert store.load() == st
    with pytest.raises(pkg.result.FsError):
        fab.meta.stat("/data/l.state.tmp")


def test_composes_with_ckpt_save(pkg, fab):
    ds, _ = _dataset(pkg, fab, n=64, size=256)
    cfg = dict(global_batch=8, seed=33, epochs=2)
    with _loader(pkg, ds, **cfg) as full:
        expect = [b.ids for b in full]
    mgr = pkg.ckpt.CheckpointManager(fab.meta, fab.file_client(), kv=fab.kv,
                                     root="/ckpt-dl")
    with _loader(pkg, ds, **cfg) as ld:
        consumed = [next(ld).ids for _ in range(5)]
        mgr.save({"w": np.arange(8, dtype=np.float32),
                  "dataload": ld.state().to_leaf()}, step=5)
    st = pkg.dl.DataloadState.from_leaf(mgr.restore(5)["dataload"])
    with _loader(pkg, ds, state=st, **cfg) as resumed:
        rest = [b.ids for b in resumed]
    assert consumed + rest == expect


# -- QoS, recorders, transforms ------------------------------------------------------
def test_dataload_class_registered_and_share_bounded(pkg):
    q = pkg.qos
    cls = q.TrafficClass.DATALOAD
    assert q.CLASS_ATTRS[cls] == "dataload"
    assert cls in q.SHARE_BOUNDED_CLASSES
    assert cls not in q.BACKGROUND_CLASSES
    cfg = q.QosConfig()
    assert cfg.dataload.weight == 8 and cfg.dataload.queue_share == 0.5
    assert q.class_from_flags(q.class_to_flags(cls)) == cls


def test_wfq_share_bounds_dataload_but_not_fg(pkg):
    sched = importlib.import_module(
        pkg.qos.__name__.rsplit(".", 1)[0] + ".scheduler")
    wfq = sched.WeightedFairQueue(sched.WfqPolicy(pkg.qos.QosConfig()), cap=8)
    item = SimpleNamespace(cost=1)
    for _ in range(4):  # share 0.5 * cap 8 = 4
        assert wfq.try_push(item, pkg.qos.TrafficClass.DATALOAD) is None
    assert wfq.try_push(item, pkg.qos.TrafficClass.DATALOAD) is not None
    for _ in range(4):  # foreground fills the rest, unbounded
        assert wfq.try_push(item, pkg.qos.TrafficClass.FG_WRITE) is None


def test_loader_io_rides_dataload_class(pkg, fab):
    ds, _ = _dataset(pkg, fab, n=32, size=512)
    fio = ds._fio
    seen = []
    real = fio.batch_read_files

    def spy(files):
        seen.append(pkg.qos.current_class())
        return real(files)

    fio.batch_read_files = spy
    with _loader(pkg, ds, global_batch=8, seed=4, epochs=1) as ld:
        list(ld)
    assert seen and all(tc == pkg.qos.TrafficClass.DATALOAD for tc in seen)


def test_loader_self_throttles_on_shed(pkg, fab):
    ds, recs = _dataset(pkg, fab, n=32, size=512)
    sheds = [0]
    real = ds.read_samples
    status = importlib.import_module(pkg.result.__name__).Status

    def flaky(gids, **kw):
        if sheds[0] < 2:
            sheds[0] += 1
            raise pkg.result.FsError(status(
                pkg.result.Code.OVERLOADED,
                pkg.qos.format_retry_after(5, "test")))
        return real(gids, **kw)

    ds.read_samples = flaky
    with _loader(pkg, ds, global_batch=8, seed=6, epochs=1) as ld:
        batches = list(ld)
    assert sheds[0] == 2 and len(batches) == 4
    for b in batches:
        assert [bytes(mv) for mv in b.data] == [recs[g] for g in b.ids]


def test_dataload_metrics_reach_the_monitor(pkg, fab):
    ds, _ = _dataset(pkg, fab, n=32, size=512)
    with _loader(pkg, ds, global_batch=8, seed=2, epochs=1) as ld:
        list(ld)
        sink = pkg.recorder.MemorySink()
        mon = pkg.recorder.Monitor.default()
        mon.add_sink(sink)
        try:
            mon.collect()
        finally:
            mon._sinks.remove(sink)
    assert {"dataload.batch_ms", "dataload.stall_ms", "dataload.bytes",
            "dataload.batches"} <= {s.name for s in sink.samples}


def test_transforms(pkg, fab):
    ds, recs = _dataset(pkg, fab, n=32, size=512)
    with _loader(pkg, ds, global_batch=8, seed=3, epochs=1,
                 transform=lambda r: bytes(r)[::-1]) as ld:
        for b in ld:
            assert list(b.data) == [recs[g][::-1] for g in b.ids]
    with _loader(pkg, ds, global_batch=8, seed=3, epochs=1, dtype="uint8",
                 sample_shape=(512,), transform=lambda r: np.frombuffer(
                     r, dtype=np.uint8) + 1) as ld:
        for b in ld:
            assert b.data.shape == (8, 512)
            for row, gid in zip(b.data, b.ids):
                assert np.array_equal(
                    row, np.frombuffer(recs[gid], dtype=np.uint8) + 1)
    with _loader(pkg, ds, global_batch=8, seed=1, epochs=1, dtype="uint8",
                 sample_shape=(512,),
                 transform=lambda r: bytes(r)[:100]) as ld:
        with pytest.raises(pkg.result.FsError) as ei:
            next(ld)
        assert _code(pkg, ei, "DATALOAD_CORRUPT")


def test_epoch_callback_fires_per_epoch_including_resume(pkg, fab):
    ds, _ = _dataset(pkg, fab, n=32, size=256)
    cfg = dict(global_batch=8, seed=5, epochs=2)
    epochs = []
    with _loader(pkg, ds, epoch_callback=epochs.append, **cfg) as ld:
        list(ld)
    assert epochs == [0, 1]
    with _loader(pkg, ds, epoch_callback=[].append, **cfg) as ld:
        for _ in range(ds.steps_per_epoch(8) + 1):
            next(ld)
        st = ld.state()
    assert st.epoch == 1
    epochs3 = []
    with _loader(pkg, ds, epoch_callback=epochs3.append, state=st,
                 **cfg) as ld:
        list(ld)
    assert epochs3 == [1]


def test_transforms_preserve_resume_exactness(pkg, fab):
    ds, _ = _dataset(pkg, fab, n=32, size=256)

    def mk(state=None):
        return _loader(pkg, ds, global_batch=8, seed=9, epochs=2,
                       transform=lambda r: bytes(r)[::-1], state=state)

    with mk() as full:
        expect = [(b.ids, [bytes(r) for r in b.data]) for b in full]
    half = mk()
    consumed = [(b.ids, [bytes(r) for r in b.data])
                for b in [next(half) for _ in range(3)]]
    st = half.state()
    half.close()
    with mk(state=st) as resumed:
        rest = [(b.ids, [bytes(r) for r in b.data]) for b in resumed]
    assert consumed + rest == expect


def test_curriculum_swap_at_epoch_boundary(pkg, fab):
    ds, recs = _dataset(pkg, fab, n=32, size=256)
    cfg = pkg.dl.LoaderConfig(global_batch=8, seed=2, epochs=2, depth=1)

    def on_epoch(epoch):
        cfg.transform = None if epoch == 0 else (lambda r: bytes(r)[::-1])

    cfg.epoch_callback = on_epoch
    with pkg.dl.DataLoader(ds, cfg) as ld:
        for b in ld:
            for rec, gid in zip(b.data, b.ids):
                want = recs[gid] if b.epoch == 0 else recs[gid][::-1]
                assert bytes(rec) == want


# -- the adaptive gap ---------------------------------------------------------------
def test_gap_deterministic_convergence(pkg):
    def cost_ms(gap, nbytes=1 << 20):
        return (5 + 4 * abs(math.log2(gap) - 15)) * nbytes / (1 << 20)

    c = pkg.autotune.GapController()
    seen = [c.next_gap() for _ in range(c.explore_batches)]
    assert sorted(set(seen)) == sorted(set(c._ladder))
    for g in seen:
        c.observe(g, cost_ms(g), 1 << 20)
    assert c.gap == 32 << 10
    assert [c.next_gap() for _ in range(40)].count(32 << 10) >= 38


def test_gap_tracks_drift_via_reprobes(pkg):
    c = pkg.autotune.GapController(probes_per_arm=1, reprobe_every=2)
    for _ in range(c.explore_batches):
        g = c.next_gap()
        c.observe(g, 10 + abs(g - (64 << 10)) / 1024, 1 << 20)
    assert c.gap == 64 << 10
    for _ in range(300):
        g = c.next_gap()
        c.observe(g, 10 + abs(g - (128 << 10)) / 4096, 1 << 20)
    assert c.gap == 128 << 10


def test_loader_auto_mode_wires_the_controller(pkg, fab):
    ds, recs = _dataset(pkg, fab, n=32, size=512)
    with _loader(pkg, ds, global_batch=8, seed=0, epochs=1,
                 coalesce_gap=0) as ld:
        assert ld.gap_controller is not None
        got = {gid: bytes(rec) for b in ld for rec, gid in zip(b.data, b.ids)}
    assert got == {i: recs[i] for i in range(32)}
    assert ld.gap_controller._observed == 4


# -- the port's own rules -------------------------------------------------------------
def _crc_calls():
    """Patch the port's crc32c_many with a spy: the list of the row
    counts of its calls (each call is one K2 launch on the card)."""
    calls = []
    real = port_crc.crc32c_many

    def spy(bufs, device=None):
        calls.append(len(bufs))
        return real(bufs, device)

    return calls, mock.patch.object(port_crc, "crc32c_many", spy)


def test_one_k2_call_per_read_batch_and_per_writer_run():
    pkg = _pkg("tpu3fs_torch")
    f = pkg.fabric.Fabric(pkg.fabric.SystemSetupConfig(
        num_storage_nodes=3, num_chains=2, num_replicas=2, chunk_size=CHUNK),
        device="cpu")
    try:
        recs = _payloads(43, 1000, seed=4)
        calls, patch = _crc_calls()
        with patch:
            w = pkg.dl.RecordFileWriter(f.meta, f.file_client(), "/r.rec",
                                        num_records=43, buffer_bytes=8000)
            for r in recs:
                w.append(r)
            # one call a flushed run of 8 records; the last 3 wait
            assert calls == [8] * 5
            rf = w.commit()
            # the last run, the index, then open()'s index check
            assert calls == [8] * 5 + [3, 1, 1]
            del calls[:]
            got = rf.read_batch([5, 42, 0, 17, 5])
            assert calls == [5]
            assert [bytes(g) for g in got] == [recs[i] for i in (5, 42, 0,
                                                                  17, 5)]
            rf.read_batch([1, 2], verify=False)
            assert calls == [5]
            ds = pkg.dl.PackedDataset(f.meta, f.file_client(), ["/r.rec"])
            del calls[:]
            with pkg.dl.DataLoader(ds, pkg.dl.LoaderConfig(
                    global_batch=8, seed=1, epochs=1)) as ld:
                assert len(list(ld)) == 5
            assert calls == [8] * 5
    finally:
        f.close()


def test_corrupt_record_counts_a_crc_error():
    """In both packages a corrupted record raises DATALOAD_CORRUPT from
    the loader and counts one ``dataload.crc_err``."""
    for root in PACKAGES:
        pkg = _pkg(root)
        f = pkg.fabric.Fabric(pkg.fabric.SystemSetupConfig(
            num_storage_nodes=3, num_chains=2, num_replicas=2,
            chunk_size=CHUNK), **pkg.dev)
        try:
            f.meta.mkdirs("/data", recursive=True)
            ds, _ = _dataset(pkg, f, n=16, size=512, files=1)
            off, _ = ds.files[0].extent(5)
            fio = f.file_client()
            fio.write(f.meta.stat("/data/ds0.rec"), off, b"\x00\x01")
            ld = _loader(pkg, pkg.dl.PackedDataset(
                f.meta, fio, ["/data/ds0.rec"]), global_batch=16, seed=0,
                epochs=1)
            with pytest.raises(pkg.result.FsError) as ei:
                next(ld)
            ld.close()
            assert _code(pkg, ei, "DATALOAD_CORRUPT")
            assert ld._crc_err._value == 1
        finally:
            f.close()


def test_concurrent_fetch_workers_raise():
    pkg = _pkg("tpu3fs_torch")
    with pytest.raises(NotImplementedError, match="M6a"):
        pkg.dl.DataLoader(None, pkg.dl.LoaderConfig(workers=2, depth=2))


def test_encode_record_file_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_recordio.encode_record_file([b"x"])
