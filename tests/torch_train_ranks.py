"""Rank bodies for tests/test_torch_ckpt_mesh.py,
tests/test_torch_dataload_mesh.py and tests/test_torch_ckpt_ranks.py.

Each spawned process is one gloo rank on the CPU of a (4, 2) ``DeviceMesh``
(axes ``dp`` and ``chain``). The restore and loader cases load a plain
dump of a JAX-package fabric (``<root>/dump.pkl``: its KV pairs, every
target's chunks, the fabric's shape and the case's parameters) into the
port's ``Fabric`` with ``convert.fabric_from_dump``; the save case
(``<root>/save.pkl``) instead reaches one cluster of the port's service
apps over loopback, on a (2, 4) mesh. Each runs its case and writes its
LOCAL outputs to ``<root>/rank<r>.npz`` (a failure's traceback to
``<root>/rank<r>.err``). This module imports neither jax nor tpu3fs, so a
rank starts quickly.
"""

from __future__ import annotations

import multiprocessing
import pickle
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor import zeros as dtensor_zeros

MESH = (4, 2)
AXES = ("dp", "chain")


def placements_of(spec, axes=AXES) -> list:
    """A PartitionSpec written as a tuple of per-dim axis names (None, a
    name or a tuple of names) -> the DTensor placements over ``axes``
    that shard the same way: mesh axis i carries ``Shard(d)`` for the dim
    d that names it, else ``Replicate``."""
    out = [Replicate() for _ in axes]
    for d, names in enumerate(spec):
        for name in ((names,) if isinstance(names, str) else names or ()):
            out[axes.index(name)] = Shard(d)
    return out


def _fabric(root):
    from tpu3fs_torch import convert
    from tpu3fs_torch.fabric import SystemSetupConfig

    case = pickle.loads((Path(root) / "dump.pkl").read_bytes())
    fab = convert.fabric_from_dump(case["dump"],
                                   SystemSetupConfig(**case["cfg"]),
                                   device="cpu")
    return fab, case


def ckpt_case(rank: int, root) -> dict:
    """Restore the checkpoint (step ``case["step"]``) onto DTensor
    templates with ``case["specs"]``, verified and byte-range exact; a
    save of a DTensor on this 8-rank mesh must raise."""
    from tpu3fs_torch.ckpt import CheckpointManager
    from tpu3fs_torch.parallel import make_storage_mesh

    fab, case = _fabric(root)
    mesh = make_storage_mesh(MESH[1], device="cpu")
    like = {}
    for key, (shape, spec) in case["specs"].items():
        like[key] = dtensor_zeros(shape, dtype=torch.float32,
                                  device_mesh=mesh,
                                  placements=placements_of(spec))
    mgr = CheckpointManager(fab.meta, fab.file_client(), kv=fab.kv)
    out = {}
    for mode, verify in (("verified", True), ("ranged", False)):
        got = mgr.restore(case["step"], like=like, verify=verify)
        for key, leaf in got.items():
            assert isinstance(leaf, DTensor), f"{key} is not a DTensor"
            assert leaf.placements == like[key].placements
            assert leaf.to_local().shape == like[key].to_local().shape, key
            out[f"{mode}_{key}"] = leaf.to_local().numpy()
    out.update(failed_save(rank, mgr, {"w": like["w"]}, 99, bad_rank=3))
    out["committed"] = np.array(has_manifest(mgr, fab.meta, 99))
    fab.close()
    return out


def has_manifest(mgr, meta, step: int) -> bool:
    """True when ``step`` committed, or its ``.tmp`` directory holds a
    manifest."""
    from tpu3fs_torch.ckpt.manifest import MANIFEST_NAME, tmp_dir
    from tpu3fs_torch.utils.result import FsError

    if step in mgr.steps():
        return True
    try:
        meta.stat(f"{tmp_dir(mgr.root, step)}/{MANIFEST_NAME}")
        return True
    except FsError:
        return False


def failed_save(rank: int, mgr, tree, step: int, bad_rank: int) -> dict:
    """A multi-rank save whose shard write fails on ``bad_rank``: -> this
    rank's error message ("" when the save returned)."""
    from tpu3fs_torch.utils.result import Code, FsError
    from tpu3fs_torch.utils.result import err

    if rank == bad_rank:
        def refuse(items):
            raise err(Code.INTERNAL, "injected shard write failure")
        mgr.saver._write_files_batched = refuse
    try:
        mgr.save(tree, step)
        message = ""
    except FsError as e:
        message = e.status.message
    return {"save_error": np.array(message)}


def save_case(rank: int, root) -> dict:
    """Save ``case["values"]`` as DTensors on a (2, 4) mesh (each rank
    building its local box), through a cluster of the port's apps at
    ``case["mgmtd"]``/``case["meta"]``: step 3 commits, then a save of
    step 4 with rank 5's shard write failing must raise on every rank."""
    from tpu3fs_torch.ckpt import CheckpointManager
    from tpu3fs_torch.ckpt.manifest import placement_box
    from tpu3fs_torch.client.file_io import FileIoClient
    from tpu3fs_torch.client.storage_client import RetryOptions, StorageClient
    from tpu3fs_torch.parallel import make_storage_mesh
    from tpu3fs_torch.rpc.services import (MetaRpcClient, MgmtdAdminRpcClient,
                                           RpcMessenger)

    case = pickle.loads((Path(root) / "save.pkl").read_bytes())
    mesh = make_storage_mesh(4, device="cpu")
    admin = MgmtdAdminRpcClient(tuple(case["mgmtd"]))
    messenger = RpcMessenger(admin.refresh_routing)
    storage = StorageClient(f"rank{rank}", admin.refresh_routing, messenger,
                            retry=RetryOptions(hedge_reads=False),
                            device="cpu")
    meta = MetaRpcClient([tuple(case["meta"])], client_id=f"rank{rank}")
    tree = {}
    coord = mesh.get_coordinate()
    sizes = tuple(mesh.shape)
    for key, (value, spec) in case["values"].items():
        if spec is None:
            tree[key] = value
            continue
        placements = placements_of(spec, ("dp", "chain"))
        off, shape = placement_box(value.shape, placements, sizes, coord)
        local = value[tuple(slice(o, o + n) for o, n in zip(off, shape))]
        tree[key] = DTensor.from_local(
            torch.from_numpy(np.ascontiguousarray(local)), mesh, placements,
            run_check=False, shape=torch.Size(value.shape),
            stride=torch.empty(value.shape).stride())
    mgr = CheckpointManager(meta, FileIoClient(storage))
    try:
        manifest = mgr.save(tree, 3)
        out = {"crcs": np.array([s.crc for s in manifest.shards],
                                dtype=np.int64)}
        out.update(failed_save(rank, mgr, tree, 4, bad_rank=5))
    finally:
        storage.close()
        messenger.close_rings()
    return out


def dataload_case(rank: int, root) -> dict:
    """One epoch of the packed dataset in mesh mode: this rank's local
    batch of every step and its dp row's ids."""
    from tpu3fs_torch.dataload import DataLoader, LoaderConfig, PackedDataset
    from tpu3fs_torch.parallel import make_storage_mesh

    fab, case = _fabric(root)
    mesh = make_storage_mesh(MESH[1], device="cpu")
    ds = PackedDataset(fab.meta, fab.file_client(), case["paths"])
    out = {"ids": [], "local": []}
    with DataLoader(ds, LoaderConfig(**case["loader"]), mesh=mesh) as ld:
        for b in ld:
            assert isinstance(b.data, DTensor)
            assert tuple(b.data.shape) == (case["loader"]["global_batch"],
                                           *case["loader"]["sample_shape"])
            assert b.data.placements == (Shard(0), Replicate())
            out["ids"].append(b.ids)
            out["local"].append(b.data.to_local().numpy())
    fab.close()
    return {"ids": np.array(out["ids"]), "local": np.stack(out["local"])}


CASES = {"ckpt": ckpt_case, "dataload": dataload_case, "save": save_case}


def run(rank: int, world: int, root: str, case: str) -> None:
    """One rank: join the gloo group through ``root``, run ``case``, save
    this rank's outputs."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{root}/pg",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=45))
        np.savez(Path(root) / f"rank{rank}.npz", **CASES[case](rank, root))
    except BaseException:
        (Path(root) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


SPAWN_TIMEOUT_S = 90


def spawn(case: str, root, world: int = 8) -> list:
    """Run ``world`` gloo ranks of ``case``; return each rank's saved
    outputs. A rank that fails, or a spawn that outlives SPAWN_TIMEOUT_S,
    fails the test."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, world, str(root), case))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    errors = "".join(f.read_text() for f in sorted(root.glob("rank*.err")))
    assert not hung, f"ranks {hung} still running after {SPAWN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * world, errors
    return [dict(np.load(root / f"rank{r}.npz")) for r in range(world)]
