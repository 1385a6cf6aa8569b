"""The data-loading slice on the CPU: one seeded sequence through the JAX
package's ``tpu3fs.dataload`` and through the port's, on the port's
``Fabric(device="cpu")``, at RS(4,2) and CR: four record files packed
streaming (declared count), one buffered, an in-memory image
(``encode_record_file``); one shuffled, CRC-verified epoch of int32 token
samples with its state saved mid-epoch (``StateStore``) and a resumed
loader; the adaptive gap controller over a seeded feed. Record files,
stored chunks, batch ids and bytes, the saved state and the controller's
arms must be equal. Tolerance 0."""

import hashlib
from types import SimpleNamespace

import numpy as np
import pytest

import tpu3fs.dataload as jax_dl
import tpu3fs.dataload.autotune as jax_autotune
import tpu3fs.dataload.recordio as jax_recordio
import tpu3fs.fabric as jax_fabric
import tpu3fs.meta.store as jax_meta_store
import tpu3fs.meta.types as jax_meta_types
from torch_ckpt_sequence import SHAPES, deterministic
from torch_fabric_sequence import stored

import tpu3fs_torch.dataload as dl
import tpu3fs_torch.dataload.autotune as autotune
import tpu3fs_torch.dataload.recordio as recordio
import tpu3fs_torch.meta.store as meta_store
import tpu3fs_torch.meta.types as meta_types
from tpu3fs_torch.fabric import Fabric, SystemSetupConfig

FILES, PER_FILE, TOKENS = 4, 24, 256     # 96 samples of 256 int32 tokens
GLOBAL_BATCH, CUT = 8, 5                 # 12 steps an epoch; resume at 5


def samples(n: int = FILES * PER_FILE) -> list:
    """Token samples: int32 ids below Llama 3's vocabulary of 128,256."""
    rng = np.random.default_rng(17)
    return [rng.integers(0, 128_256, TOKENS, dtype=np.int32).tobytes()
            for _ in range(n)]


def run_sequence(fab, pkg, dev) -> dict:
    recs = samples()
    fio = fab.file_client()
    fab.meta.mkdirs("/data", recursive=True)
    paths = [f"/data/shard{i}.rec" for i in range(FILES)]
    rec = {}
    for i, path in enumerate(paths):
        w = pkg.dl.RecordFileWriter(fab.meta, fio, path,
                                    num_records=PER_FILE, buffer_bytes=4096)
        for r in recs[i * PER_FILE:(i + 1) * PER_FILE]:
            w.append(r)
        w.commit()
    pkg.dl.pack_records(fab.meta, fio, "/data/buffered.rec", iter(recs[:10]))
    rec["files"] = {}
    for path in paths + ["/data/buffered.rec"]:
        inode = fab.meta.stat(path)
        rec["files"][path] = fio.read(inode, 0, inode.length)
    rec["image"] = pkg.recordio.encode_record_file(recs[:PER_FILE], **dev)
    ds = pkg.dl.PackedDataset(fab.meta, fio, paths)
    cfg = dict(global_batch=GLOBAL_BATCH, seed=7, dtype="<i4",
               sample_shape=(TOKENS,), depth=2, epochs=1)

    def batch_rec(b):
        assert b.data.shape == (GLOBAL_BATCH, TOKENS)
        for row, gid in zip(b.data, b.ids):
            assert row.tobytes() == recs[gid], f"sample {gid} differs"
        return (b.epoch, b.step, b.ids,
                hashlib.sha256(b.data.tobytes()).hexdigest())

    with pkg.dl.DataLoader(ds, pkg.dl.LoaderConfig(**cfg)) as ld:
        rec["epoch"] = [batch_rec(b) for b in ld]
    store = pkg.dl.StateStore(fab.meta, fio, "/data/loader.state")
    with pkg.dl.DataLoader(ds, pkg.dl.LoaderConfig(**cfg)) as ld:
        rec["head"] = [batch_rec(next(ld)) for _ in range(CUT)]
        store.save(ld.state())
    state = store.load()
    rec["state"] = state.encode()
    with pkg.dl.DataLoader(ds, pkg.dl.LoaderConfig(**cfg),
                           state=state) as ld:
        rec["tail"] = [batch_rec(b) for b in ld]
    rec["stored"] = stored(fab)
    return rec


def gap_arms(autotune_mod, feed: int = 200) -> list:
    """(arm handed out, best arm after its observation) over a seeded feed
    of batch walls around a cost curve with its minimum at 32 KiB."""
    rng = np.random.default_rng(23)
    c = autotune_mod.GapController(probes_per_arm=2, reprobe_every=8)
    out = []
    for _ in range(feed):
        g = c.next_gap()
        cost = 5 + 3 * abs(np.log2(g) - 15) + float(rng.random())
        c.observe(g, cost, 1 << 20)
        out.append((g, c.gap))
    return out


def _jax_run(shape):
    pkg = SimpleNamespace(dl=jax_dl, recordio=jax_recordio)
    with deterministic([jax_meta_store, jax_meta_types]):
        fab = jax_fabric.Fabric(jax_fabric.SystemSetupConfig(**SHAPES[shape]))
        try:
            return run_sequence(fab, pkg, {})
        finally:
            fab.close()


def _port_run(shape):
    pkg = SimpleNamespace(dl=dl, recordio=recordio)
    with deterministic([meta_store, meta_types]):
        fab = Fabric(SystemSetupConfig(**SHAPES[shape]), device="cpu")
        try:
            return run_sequence(fab, pkg, {"device": "cpu"})
        finally:
            fab.close()


@pytest.fixture(scope="module", params=sorted(SHAPES))
def runs(request):
    return _jax_run(request.param), _port_run(request.param)


def test_record_files_equal(runs):
    want, got = runs
    assert got["files"] == want["files"]
    assert got["image"] == want["image"] == got["files"]["/data/shard0.rec"]


def test_epoch_ids_and_bytes_equal(runs):
    want, got = runs
    assert got["epoch"] == want["epoch"]
    ids = [i for _, _, batch, _ in got["epoch"] for i in batch]
    assert len(got["epoch"]) == FILES * PER_FILE // GLOBAL_BATCH
    assert sorted(ids) == list(range(FILES * PER_FILE))
    assert ids != sorted(ids)


def test_resume_equal_and_exact(runs):
    want, got = runs
    assert (got["head"], got["state"], got["tail"]) == \
        (want["head"], want["state"], want["tail"])
    assert got["head"] + got["tail"] == got["epoch"]


def test_stored_chunks_equal(runs):
    want, got = runs
    assert got["stored"].keys() == want["stored"].keys()
    for tid, rows in want["stored"].items():
        assert got["stored"][tid] == rows, f"target {tid}"


def test_gap_controller_arms_equal():
    got, want = gap_arms(autotune), gap_arms(jax_autotune)
    assert got == want
    assert got[-1][1] == 32 << 10
