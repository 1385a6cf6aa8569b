"""tpu3fs_torch/dataload — the training-side input pipeline.

The port's own copy of ``tpu3fs/dataload/``: random batch reads over
packed datasets through the normal client stack — striped batched chunk
IO, atomic-rename commit, the ``dataload`` QoS class, monitor recorders.
Record and index CRCs run on the client's device, one K2 launch a batch.

- ``recordio`` — packed record-file format (fixed header, per-record
  offset index + CRC32C, ``.tmp`` → rename commit) and the packer
- ``dataset``  — multi-file global sample index, seeded Feistel-PRP
  per-epoch shuffle (no materialized permutation), dp sharding over a
  ``DeviceMesh``
- ``loader``   — pipelined batch fetcher: coalesced sorted batch reads,
  CRC verify, bounded-byte prefetch, a DTensor hand-off on a mesh
- ``state``    — the four-integer resumable cursor, composing with ckpt
  save sessions (a restored job resumes mid-epoch exactly)
"""

from __future__ import annotations

from tpu3fs_torch.dataload.dataset import (
    FeistelPermutation,
    IdentityPermutation,
    PackedDataset,
    dp_info,
)
from tpu3fs_torch.dataload.loader import Batch, DataLoader, LoaderConfig
from tpu3fs_torch.dataload.recordio import (
    RecordFile,
    RecordFileWriter,
    pack_records,
    plan_coalesced,
)
from tpu3fs_torch.dataload.state import DataloadState, StateStore

__all__ = [
    "Batch",
    "DataLoader",
    "DataloadState",
    "FeistelPermutation",
    "IdentityPermutation",
    "LoaderConfig",
    "PackedDataset",
    "RecordFile",
    "RecordFileWriter",
    "StateStore",
    "dp_info",
    "pack_records",
    "plan_coalesced",
]
