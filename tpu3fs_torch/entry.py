"""The flagship data-plane step on one device, RS(12,4) parity encode plus
batched CRC32C over all k+m shards, and the multi-device dry run.

Counterpart of ``__graft_entry__.entry()`` and ``dryrun_multichip``. The
JAX step calls ``rs._encode`` (the einsum, not the Pallas kernel); this one
goes through ``RSCode.encode``, which is kernel K1 on the card. The bytes
are identical.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3fs_torch.device import resolve_device
from tpu3fs_torch.ops.crc32c import BatchCrc32c
from tpu3fs_torch.ops.rs import RSCode
from tpu3fs_torch.parallel.chain import chain_write_step
from tpu3fs_torch.parallel.mesh import mesh_axis
from tpu3fs_torch.parallel.rebuild import rebuild_lost_shard
from tpu3fs_torch.parallel.shuffle import shuffle_partitions


def entry(device=None):
    """-> (storage_step, (example,)): the step and its seeded example input
    (batch 4 of RS(12,4) stripes with S = 4096) on ``device``."""
    dev = resolve_device(device)
    k, m, size, batch = 12, 4, 4096, 4
    rs = RSCode(k, m, device=dev)
    crc = BatchCrc32c(size, block=512, device=dev)

    def storage_step(data: torch.Tensor):
        """data: (batch, k, S) uint8 -> (parity (batch, m, S), crcs (batch, k+m))."""
        parity = rs.encode(data)
        shards = torch.cat([data, parity], dim=1)
        crcs = crc(shards.reshape(batch * (k + m), size))
        return parity, crcs.reshape(batch, k + m)

    rng = np.random.default_rng(0)
    example = torch.from_numpy(
        rng.integers(0, 256, (batch, k, size)).astype(np.uint8)).to(dev)
    return storage_step, (example,)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def dryrun_chain_len(n_ranks: int) -> int:
    """The chain length the dry run takes on ``n_ranks``: a non-degenerate
    2-D layout (dp >= 2 and chain >= 2) whenever the count allows, else the
    longest chain of 8, 4 or 2 that divides it, else 1."""
    for c in (4, 3, 2):
        if n_ranks % c == 0 and n_ranks // c >= 2:
            return c
    for c in (8, 4, 2):
        if n_ranks % c == 0:
            return c
    return 1


def dryrun_multichip(mesh) -> tuple:
    """Steps 1-3 of ``__graft_entry__.dryrun_multichip`` on this rank of a
    (dp, chain) mesh from ``make_storage_mesh(dryrun_chain_len(world))``,
    with the same seeded data and asserts: the chain write, the EC rebuild
    with the batch sharded over dp (when chain > 1), the shuffle over dp
    (when dp > 1). Returns (dp, chain). Step 4, the fabric EC round trip,
    waits for the port of the serving stack (ROADMAP M6)."""
    _, dp_i, dp = mesh_axis(mesh, "dp")
    _, c_i, chain_len = mesh_axis(mesh, "chain")
    dev = torch.device(mesh.device_type)
    size = 128

    def local(global_rows: np.ndarray, n_parts: int, part: int):
        rows = global_rows.shape[0] // n_parts
        return torch.from_numpy(
            global_rows[part * rows:(part + 1) * rows].copy()).to(dev)

    # 1) CRAQ write: replicate a chunk batch down every chain
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (dp * 2, size)).astype(np.uint8)
    mine = local(data, dp, dp_i)
    replica, ok = chain_write_step(mesh, mine)
    _require(bool(ok.all()), "chain checksum cross-check failed")
    _require(torch.equal(replica[0], mine), f"replica {c_i} mismatch")

    # 2) EC rebuild over the chain axis, each dp row rebuilding its own
    # slice of the batch; distinct per-row content makes any cross-row mixup
    # a failed assert
    if chain_len > 1:
        rs = RSCode(chain_len - 1, 1, device=dev)
        batch = dp * 3
        sdata = rng.integers(0, 256, (batch, rs.k, size)).astype(np.uint8)
        parity = rs.encode_np(sdata)
        shards = np.moveaxis(np.concatenate([sdata, parity], axis=1), 1, 0).copy()
        lost = chain_len // 2
        corrupted = shards.copy()
        corrupted[lost] = 0
        mine = local(corrupted[c_i], dp, dp_i)[None]  # (1, batch / dp, S)
        rebuilt = rebuild_lost_shard(mesh, mine, rs, [lost],
                                     batch_axis="dp" if dp > 1 else None)
        want = local(shards[lost], dp, dp_i)
        _require(torch.equal(rebuilt[0], want), "rebuild mismatch")

    # 3) shuffle: all-to-all partition exchange over the dp axis
    if dp > 1:
        part = rng.integers(0, 256, (dp * dp, 2, size)).astype(np.uint8)
        out = shuffle_partitions(mesh, local(part, dp, dp_i))
        want = torch.from_numpy(part[dp_i::dp].copy()).to(dev)
        _require(torch.equal(out, want), "shuffle mismatch")
    return dp, chain_len
