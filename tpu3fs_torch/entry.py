"""The flagship data-plane step on one device: RS(12,4) parity encode plus
batched CRC32C over all k+m shards.

Counterpart of ``__graft_entry__.entry()``. That step calls ``rs._encode``
(the einsum, not the Pallas kernel); this one goes through ``RSCode.encode``,
which is kernel K1 on the card. The bytes are identical.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3fs_torch.device import resolve_device
from tpu3fs_torch.ops.crc32c import BatchCrc32c
from tpu3fs_torch.ops.rs import RSCode


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
