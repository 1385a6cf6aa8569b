"""Rank bodies for tests/test_torch_ckpt_mesh.py and
tests/test_torch_dataload_mesh.py.

Each spawned process is one gloo rank on the CPU of a (4, 2) ``DeviceMesh``
(axes ``dp`` and ``chain``). It loads a plain dump of a JAX-package fabric
(``<root>/dump.pkl``: its KV pairs, every target's chunks, the fabric's
shape and the case's parameters) into the port's ``Fabric`` with
``convert.fabric_from_dump``, runs its case and writes its LOCAL outputs
to ``<root>/rank<r>.npz`` (a failure's traceback to ``<root>/rank<r>.err``).
This module imports neither jax nor tpu3fs, so a rank starts quickly.
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


def placements_of(spec) -> list:
    """A PartitionSpec written as a tuple of per-dim axis names (None, a
    name or a tuple of names) -> the DTensor placements over ``AXES``
    that shard the same way: mesh axis i carries ``Shard(d)`` for the dim
    d that names it, else ``Replicate``."""
    out = [Replicate() for _ in AXES]
    for d, names in enumerate(spec):
        for name in ((names,) if isinstance(names, str) else names or ()):
            out[AXES.index(name)] = Shard(d)
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
    try:
        mgr.save({"w": like["w"]}, 99)
        out["save_raised"] = np.array(False)
    except NotImplementedError:
        out["save_raised"] = np.array(True)
    fab.close()
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


CASES = {"ckpt": ckpt_case, "dataload": dataload_case}


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
