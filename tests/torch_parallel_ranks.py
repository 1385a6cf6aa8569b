"""Rank bodies for tests/test_torch_parallel.py and tests/test_torch_entry.py.

Each spawned process is one gloo rank on the CPU. It runs every case of its
world size through ``tpu3fs_torch.parallel`` with the same seeded numpy
inputs as the JAX side of the test, and writes its LOCAL outputs to
``<root>/rank<r>.npz`` (a failure's traceback to ``<root>/rank<r>.err``).
This module imports neither jax nor tpu3fs, so a rank starts quickly.
"""

from __future__ import annotations

import multiprocessing
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from tpu3fs_torch.entry import dryrun_chain_len, dryrun_multichip
from tpu3fs_torch.ops.crc32c import BatchCrc32c
from tpu3fs_torch.ops.rs import RSCode
from tpu3fs_torch.ops.xor_reduce import xor_reduce_plain
from tpu3fs_torch.parallel import (chain_write_step, make_storage_mesh,
                                   rebuild_lost_shard, shuffle_partitions)
from tpu3fs_torch.parallel.mesh import mesh_axis

CPU = "cpu"


def chain_data():
    return np.random.default_rng(0).integers(0, 256, (8, 64)).astype(np.uint8)


def chain_crc_data():
    return np.random.default_rng(3).integers(0, 256, (8, 512)).astype(np.uint8)


def chain2_data():
    return np.arange(4 * 32, dtype=np.uint8).reshape(4, 32)


def chain23_data():
    return np.random.default_rng(5).integers(0, 256, (4, 96)).astype(np.uint8)


def stripe_shards(k, m, batch, size, seed):
    """(k+m, batch, S) shard rows of seeded stripes (the rebuild layout)."""
    data = np.random.default_rng(seed).integers(
        0, 256, (batch, k, size)).astype(np.uint8)
    parity = RSCode(k, m, device=CPU).encode_np(data)
    return np.moveaxis(np.concatenate([data, parity], axis=1), 1, 0).copy()


def shuffle_data(n):
    data = np.zeros((n * n, 4, 8), dtype=np.uint8)
    for src in range(n):
        for dst in range(n):
            data[src * n + dst] = src * 16 + dst
    return data


def _rows(a: np.ndarray, n_parts: int, part: int) -> torch.Tensor:
    rows = a.shape[0] // n_parts
    return torch.from_numpy(a[part * rows:(part + 1) * rows].copy())


def _raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def _rebuild(mesh, rs, shards, lost, batch_axis=None):
    """This rank's rebuilt rows, and how many K3 calls the rebuild made."""
    _, c_i, _ = mesh_axis(mesh, "chain")
    corrupted = shards.copy()
    corrupted[list(lost)] = 0
    _, dp_i, dp = mesh_axis(mesh, "dp")
    mine = (_rows(corrupted[c_i], dp, dp_i) if batch_axis
            else torch.from_numpy(corrupted[c_i]))
    calls = xor_reduce_plain.calls
    out = rebuild_lost_shard(mesh, mine[None], rs, lost, batch_axis=batch_axis)
    return out.numpy(), np.int64(xor_reduce_plain.calls - calls)


def _chain(mesh, data, **kw):
    _, dp_i, dp = mesh_axis(mesh, "dp")
    rep, ok = chain_write_step(mesh, _rows(data, dp, dp_i), **kw)
    return rep.numpy(), ok.numpy()


def cases_8(rank: int) -> dict:
    out = {}
    meshes = {c: make_storage_mesh(c, device=CPU) for c in (1, 2, 4, 8)}
    for c, mesh in meshes.items():
        out[f"mesh{c}_shape"] = np.array(mesh.shape)
        out[f"mesh{c}_pos"] = np.array([mesh.get_local_rank(0),
                                        mesh.get_local_rank(1)])
    out["mesh_errors"] = np.array([
        _raises(lambda: make_storage_mesh(3, device=CPU)),
        _raises(lambda: make_storage_mesh(0, device=CPU)),
        _raises(lambda: make_storage_mesh(4, device="cuda")),
    ])
    out["chain4_rep"], out["chain4_ok"] = _chain(meshes[4], chain_data())
    out["chain4crc_rep"], out["chain4crc_ok"] = _chain(
        meshes[4], chain_crc_data(), crc_fn=BatchCrc32c(512, device=CPU))
    out["chain2_rep"], out["chain2_ok"] = _chain(meshes[2], chain2_data())

    rs62 = RSCode(6, 2, device=CPU)
    out["rebuild1"], out["rebuild1_xor"] = _rebuild(
        meshes[8], rs62, stripe_shards(6, 2, 2, 128, 1), [3])
    out["rebuild2"], out["rebuild2_xor"] = _rebuild(
        meshes[8], rs62, stripe_shards(6, 2, 1, 64, 2), [0, 7])
    out["rebuild2d"], out["rebuild2d_xor"] = _rebuild(
        meshes[4], RSCode(3, 1, device=CPU), stripe_shards(3, 1, 6, 128, 4),
        [2], batch_axis="dp")
    local = torch.zeros((1, 2, 64), dtype=torch.uint8)
    out["rebuild_errors"] = np.array([
        _raises(lambda: rebuild_lost_shard(meshes[4], local, rs62, [3])),
        _raises(lambda: rebuild_lost_shard(meshes[8], local, rs62, [0, 1, 2])),
        _raises(lambda: rebuild_lost_shard(meshes[8], local, rs62, [3],
                                           batch_axis="rows")),
    ])

    out["shuffle"] = shuffle_partitions(
        meshes[1], _rows(shuffle_data(8), 8, rank)).numpy()
    out["dryrun"] = np.array(dryrun_multichip(
        make_storage_mesh(dryrun_chain_len(8), device=CPU)))
    return out


def cases_6(rank: int) -> dict:
    out = {}
    mesh = make_storage_mesh(dryrun_chain_len(6), device=CPU)
    out["dryrun"] = np.array(dryrun_multichip(mesh))
    out["chain3_rep"], out["chain3_ok"] = _chain(mesh, chain23_data())
    out["rebuild2d"], out["rebuild2d_xor"] = _rebuild(
        mesh, RSCode(2, 1, device=CPU), stripe_shards(2, 1, 4, 96, 6), [1],
        batch_axis="dp")
    return out


def cases_4(rank: int) -> dict:
    """The dry run on a (2, 2) mesh, with what its step 4 (the fabric EC
    round trip on this rank's CPU) wrote, rebuilt and read."""
    from tpu3fs_torch import entry

    seen = []
    trip = entry.fabric_round_trip

    def recorded(*args):
        seen.append(trip(*args))
        return seen[-1]

    entry.fabric_round_trip = recorded
    try:
        out = {"dryrun": np.array(dryrun_multichip(
            make_storage_mesh(dryrun_chain_len(4), device=CPU)))}
    finally:
        entry.fabric_round_trip = trip
    (step4,) = seen
    for key in ("payload", "shard", "rebuilt", "read"):
        out[f"step4_{key}"] = np.frombuffer(step4[key], np.uint8)
    out["step4_moved"] = np.array(step4["moved"])
    return out


CASES = {8: cases_8, 6: cases_6, 4: cases_4}


def run(rank: int, world: int, root: str) -> None:
    """One rank: join the gloo group through ``root``, run the cases of
    ``world``, save this rank's outputs."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{root}/pg",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=45))
        np.savez(Path(root) / f"rank{rank}.npz", **CASES[world](rank))
    except BaseException:
        (Path(root) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


SPAWN_TIMEOUT_S = 60


def spawn(world: int, root) -> list:
    """Run ``world`` gloo ranks; return each rank's saved outputs. A rank
    that fails, or a spawn that outlives SPAWN_TIMEOUT_S, fails the test."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, world, str(root)))
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
