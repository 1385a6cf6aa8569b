"""The loader's concurrent fetch on the CPU: one seeded sequence through
the JAX package's ``tpu3fs.dataload`` and through the port's, on the
port's ``Fabric(device="cpu")``, at RS(4,2) and CR. Four record files of
int32 token samples; one shuffled, CRC-verified epoch at ``depth=4`` with
``workers`` 1, 2 and 4; an epoch cut mid-way at ``workers=4``, its state
saved (``StateStore``) and resumed at ``workers=4``; an epoch at
``workers=4`` with the adaptive gap (``coalesce_gap=0``), whose controller
is fed from the fetch threads. Batches (epoch, step, ids, bytes) and the
saved state must equal the JAX loader's at the same ``workers`` and the
port's at ``workers=1``; after each loader closes no ``dataload-fetch``
worker is left alive. Then the port's fetch threads: each runs under the
``dataload`` traffic class and the loader's tenant, each batch is a trace
of its own with a ``dataload.fetch`` root, and a worker's error reaches
the consumer. Tolerance 0."""

import hashlib
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import tpu3fs.dataload as jax_dl
import tpu3fs.fabric as jax_fabric
import tpu3fs.meta.store as jax_meta_store
import tpu3fs.meta.types as jax_meta_types
from torch_ckpt_sequence import SHAPES, deterministic

import tpu3fs_torch.dataload as dl
import tpu3fs_torch.meta.store as meta_store
import tpu3fs_torch.meta.types as meta_types
from tpu3fs_torch.analytics import assemble, spans
from tpu3fs_torch.fabric import Fabric, SystemSetupConfig
from tpu3fs_torch.qos.core import TrafficClass, current_class
from tpu3fs_torch.tenant.identity import current_tenant
from tpu3fs_torch.utils.result import Code, FsError, err

FILES, PER_FILE, TOKENS = 4, 24, 256     # 96 samples of 256 int32 tokens
GLOBAL_BATCH, CUT, DEPTH = 8, 5, 4       # 12 steps an epoch; resume at 5
WORKERS = (1, 2, 4)


def samples(n: int = FILES * PER_FILE) -> list:
    """Token samples: int32 ids below Llama 3's vocabulary of 128,256."""
    rng = np.random.default_rng(29)
    return [rng.integers(0, 128_256, TOKENS, dtype=np.int32).tobytes()
            for _ in range(n)]


def fetch_threads() -> list:
    return [t for t in threading.enumerate()
            if t.name.startswith("dataload-fetch")]


def closed_cleanly() -> bool:
    """No fetch worker alive, waiting a bounded time for the last ones
    to leave (a worker ends after the producer's bounded join)."""
    for t in fetch_threads():
        t.join(10)
    return not fetch_threads()


def run_sequence(fab, pkg) -> dict:
    recs = samples()
    fio = fab.file_client()
    fab.meta.mkdirs("/data", recursive=True)
    paths = [f"/data/shard{i}.rec" for i in range(FILES)]
    for i, path in enumerate(paths):
        pkg.dl.pack_records(fab.meta, fio, path,
                            recs[i * PER_FILE:(i + 1) * PER_FILE])
    ds = pkg.dl.PackedDataset(fab.meta, fio, paths)

    def cfg(workers, **kw):
        return pkg.dl.LoaderConfig(**dict(
            global_batch=GLOBAL_BATCH, seed=11, dtype="<i4",
            sample_shape=(TOKENS,), depth=DEPTH, workers=workers,
            epochs=1), **kw)

    def batch_rec(b):
        assert b.data.shape == (GLOBAL_BATCH, TOKENS)
        for row, gid in zip(b.data, b.ids):
            assert row.tobytes() == recs[gid], f"sample {gid} differs"
        return (b.epoch, b.step, b.ids,
                hashlib.sha256(b.data.tobytes()).hexdigest())

    rec = {"epoch": {}, "closed": []}
    for w in WORKERS:
        with pkg.dl.DataLoader(ds, cfg(w)) as ld:
            rec["epoch"][w] = [batch_rec(b) for b in ld]
        rec["closed"].append(closed_cleanly())
    store = pkg.dl.StateStore(fab.meta, fio, "/data/loader.state")
    with pkg.dl.DataLoader(ds, cfg(4)) as ld:
        rec["head"] = [batch_rec(next(ld)) for _ in range(CUT)]
        store.save(ld.state())
    rec["closed"].append(closed_cleanly())
    state = store.load()
    rec["state"] = state.encode()
    with pkg.dl.DataLoader(ds, cfg(4), state=state) as ld:
        rec["tail"] = [batch_rec(b) for b in ld]
    rec["closed"].append(closed_cleanly())
    with pkg.dl.DataLoader(ds, cfg(4, coalesce_gap=0)) as ld:
        rec["adaptive"] = [batch_rec(b) for b in ld]
        rec["adaptive_fed"] = ld.gap_controller is not None
    rec["closed"].append(closed_cleanly())
    return rec


def _jax_run(shape):
    pkg = SimpleNamespace(dl=jax_dl)
    with deterministic([jax_meta_store, jax_meta_types]):
        fab = jax_fabric.Fabric(jax_fabric.SystemSetupConfig(**SHAPES[shape]))
        try:
            return run_sequence(fab, pkg)
        finally:
            fab.close()


def _port_run(shape):
    pkg = SimpleNamespace(dl=dl)
    with deterministic([meta_store, meta_types]):
        fab = Fabric(SystemSetupConfig(**SHAPES[shape]), device="cpu")
        try:
            return run_sequence(fab, pkg)
        finally:
            fab.close()


@pytest.fixture(scope="module", params=sorted(SHAPES))
def runs(request):
    return _jax_run(request.param), _port_run(request.param)


@pytest.mark.parametrize("workers", [2, 4])
def test_concurrent_epoch_equals_jax_and_one_worker(runs, workers):
    want, got = runs
    assert got["epoch"][workers] == want["epoch"][workers]
    assert got["epoch"][workers] == got["epoch"][1] == want["epoch"][1]
    ids = [i for _, _, batch, _ in got["epoch"][workers] for i in batch]
    assert sorted(ids) == list(range(FILES * PER_FILE)) and ids != sorted(ids)


def test_resume_at_four_workers_equal_and_exact(runs):
    want, got = runs
    assert (got["head"], got["state"], got["tail"]) == \
        (want["head"], want["state"], want["tail"])
    assert got["head"] + got["tail"] == got["epoch"][1]


def test_adaptive_gap_keeps_the_bytes(runs):
    want, got = runs
    assert got["adaptive_fed"] and want["adaptive_fed"]
    assert got["adaptive"] == want["adaptive"] == got["epoch"][1]


def test_no_fetch_worker_outlives_its_loader(runs):
    want, got = runs
    assert got["closed"] == [True] * 6
    assert want["closed"] == got["closed"]


# -- the port's fetch threads ---------------------------------------------------
@pytest.fixture
def cpu_dataset():
    fab = Fabric(SystemSetupConfig(**SHAPES["cr_2"]), device="cpu")
    recs = samples(32)
    fio = fab.file_client()
    fab.meta.mkdirs("/data", recursive=True)
    dl.pack_records(fab.meta, fio, "/data/a.rec", recs)
    try:
        yield dl.PackedDataset(fab.meta, fio, ["/data/a.rec"]), recs
    finally:
        fab.close()


def test_fetch_threads_carry_class_and_tenant(cpu_dataset):
    ds, _ = cpu_dataset
    seen, orig = [], ds.read_samples

    def spy(ids, **kw):
        seen.append((threading.current_thread().name, current_class(),
                     current_tenant()))
        return orig(ids, **kw)

    ds.read_samples = spy
    with dl.DataLoader(ds, dl.LoaderConfig(global_batch=4, depth=4,
                                           workers=4, epochs=1,
                                           tenant="team-a")) as ld:
        assert len(list(ld)) == 8
    assert len(seen) == 8
    assert all(name.startswith("dataload-fetch-") for name, _, _ in seen)
    assert {c for _, c, _ in seen} == {TrafficClass.DATALOAD}
    assert {t for _, _, t in seen} == {"team-a"}
    assert closed_cleanly()


def test_each_batch_is_a_dataload_fetch_trace(cpu_dataset, tmp_path):
    ds, _ = cpu_dataset
    old = spans._TRACER
    spans._TRACER = spans.Tracer().configure(
        service="loader", node=0, sample_rate=1.0, directory=str(tmp_path))
    try:
        with dl.DataLoader(ds, dl.LoaderConfig(global_batch=4, depth=4,
                                               workers=4, epochs=1)) as ld:
            assert len(list(ld)) == 8
        spans._TRACER.flush()
        rows = assemble.load_spans([str(tmp_path)])
    finally:
        spans._TRACER = old
    trees = assemble.assemble_traces(rows)
    roots = [t.root["op"] for t in trees.values() if t.root is not None]
    assert roots.count("dataload.fetch") == 8


def test_worker_error_reaches_the_consumer(cpu_dataset):
    ds, _ = cpu_dataset
    calls = []

    def corrupt(ids, **kw):
        calls.append(threading.current_thread().name)
        raise err(Code.DATALOAD_CORRUPT, "planted")

    ds.read_samples = corrupt
    ld = dl.DataLoader(ds, dl.LoaderConfig(global_batch=4, depth=4,
                                           workers=4, epochs=1))
    try:
        with pytest.raises(FsError) as ei:
            next(ld)
        assert ei.value.code == Code.DATALOAD_CORRUPT
        assert ld._crc_err._value >= 1
        assert calls and all(n.startswith("dataload-fetch-") for n in calls)
    finally:
        ld.close()
    assert closed_cleanly()
