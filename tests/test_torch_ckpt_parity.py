"""The checkpoint slice on the CPU: one seeded sequence (sync save,
verified and byte-range restores, an async save, a save with a node down,
degraded restores, keep-last-N retention, an EC archive) through the JAX
package's ``tpu3fs.ckpt`` and through the port's, on the port's
``Fabric(device="cpu")``, at RS(4,2) and CR. Manifests, restored leaves,
stored chunks, the GC's trash and the archive must be equal. A checkpoint
the JAX package wrote loads through ``convert.fabric_from_dump`` and
restores equal in the port. Tolerance 0."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import tpu3fs.ckpt as jax_ckpt
import tpu3fs.fabric as jax_fabric
import tpu3fs.meta.store as jax_meta_store
import tpu3fs.meta.types as jax_meta_types
from tpu3fs.ops.stripe import shard_size_of as jax_shard_size_of
from tpu3fs.storage.target import StorageTarget as JaxTarget
from tpu3fs.utils import trash as jax_trash
from test_torch_convert import _dump
from torch_ckpt_sequence import (SHAPES, deterministic, flat, run_sequence,
                                 tree_arrays, tree_of)

import tpu3fs_torch.ckpt as ckpt
import tpu3fs_torch.meta.store as meta_store
import tpu3fs_torch.meta.types as meta_types
from tpu3fs_torch import convert
from tpu3fs_torch.fabric import Fabric, SystemSetupConfig
from tpu3fs_torch.meta.types import Layout
from tpu3fs_torch.ops.stripe import shard_size_of
from tpu3fs_torch.storage.target import StorageTarget
from tpu3fs_torch.utils import trash


def _jax_array(arr):
    return jax.device_put(arr, jax.devices("cpu")[0])


def _jax_run(shape):
    pkg = SimpleNamespace(ckpt=jax_ckpt, trash=jax_trash,
                          StorageTarget=JaxTarget,
                          shard_size_of=jax_shard_size_of,
                          Layout=jax_meta_types.Layout)
    with deterministic([jax_meta_store, jax_meta_types]) as clock:
        fab = jax_fabric.Fabric(jax_fabric.SystemSetupConfig(**SHAPES[shape]))
        try:
            return run_sequence(fab, pkg, clock, shape, _jax_array,
                                np.asarray)
        finally:
            fab.close()


def _port_run(shape):
    pkg = SimpleNamespace(ckpt=ckpt, trash=trash, StorageTarget=StorageTarget,
                          shard_size_of=shard_size_of, Layout=Layout)
    with deterministic([meta_store, meta_types]) as clock:
        fab = Fabric(SystemSetupConfig(**SHAPES[shape]), device="cpu")
        try:
            return run_sequence(
                fab, pkg, clock, shape, lambda a: torch.from_numpy(a.copy()),
                lambda t: t.numpy() if isinstance(t, torch.Tensor) else t,
                target_kw={"device": fab.device})
        finally:
            fab.close()


@pytest.fixture(scope="module", params=sorted(SHAPES))
def runs(request):
    return request.param, _jax_run(request.param), _port_run(request.param)


def test_manifests_equal(runs):
    _, want, got = runs
    assert got["manifests"].keys() == {1, 2, 3}
    for step, raw in want["manifests"].items():
        assert got["manifests"][step] == raw, f"step {step}"
    assert got["archived"] == want["archived"]


@pytest.mark.parametrize("name", [
    "verified", "verified_like", "ranged_like", "degraded_3", "degraded_1",
    "archived", "archived_ranged"])
def test_restores_equal(runs, name):
    _, want, got = runs
    assert got["restores"][name] == want["restores"][name]


def test_stored_chunks_equal(runs):
    _, want, got = runs
    for key in ("stored_saved", "stored"):
        assert got[key].keys() == want[key].keys()
        for tid, rows in want[key].items():
            assert got[key][tid] == rows, f"{key}: target {tid}"


def test_retention_and_archive_equal(runs):
    _, want, got = runs
    for key in ("async", "resynced", "gc_removed", "steps", "trash",
                "archived_chains"):
        assert got[key] == want[key], key
    assert got["steps"] == [2, 3] and got["gc_removed"] == 1
    assert [t[0] for t in got["trash"]] == ["1"]


def test_manifest_records_numpy_dtype_strings(runs):
    _, _, got = runs
    m = ckpt.Manifest.decode(got["manifests"][1])
    assert [(s.key, s.dtype, s.shape) for s in m.leaves] == [
        ("params/w", "<f4", [48, 40]), ("params/b", "<f4", [40]),
        ("opt/0", "<i4", [3, 4]), ("opt/1/0", "<f8", []),
        ("step_count", "<i8", [])]
    assert m.mesh == {} and all(s.crc for s in m.shards)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_jax_checkpoint_restores_in_the_port(shape):
    """A checkpoint the JAX package saved (steps 1 and 2, step 2 archived
    nowhere) is carried across with ``fabric_from_dump``; the port lists
    its steps, decodes its manifests and restores every leaf, verified
    and byte-range exact, onto tensor templates."""
    values = tree_arrays(seed=3)
    with deterministic([jax_meta_store, jax_meta_types]) as clock:
        jfab = jax_fabric.Fabric(jax_fabric.SystemSetupConfig(**SHAPES[shape]))
        jmgr = jax_ckpt.CheckpointManager(jfab.meta, jfab.file_client(),
                                          kv=jfab.kv, clock=clock.time)
        for step in (1, 2):
            clock.advance()
            jmgr.save(tree_of(values, _jax_array), step)
        dump = _dump(jfab)
    fab = convert.fabric_from_dump(dump, SystemSetupConfig(**SHAPES[shape]),
                                   device="cpu")
    try:
        mgr = ckpt.CheckpointManager(fab.meta, fab.file_client(), kv=fab.kv)
        assert mgr.steps() == jmgr.steps() == [1, 2]
        want = flat(values, np.asarray)
        like = tree_of(values, lambda a: torch.zeros(a.shape, dtype=torch.float32))
        for step in (1, 2):
            assert mgr.manifest(step).encode() == jmgr.manifest(step).encode()
            assert flat(mgr.restore(step), np.asarray) == want
            got = mgr.restore(step, like=like, verify=False)
            assert isinstance(got["params"]["w"], torch.Tensor)
            assert flat(got, lambda t: t.numpy() if isinstance(
                t, torch.Tensor) else t) == want
    finally:
        fab.close()
        jfab.close()
