"""Per-target facade: engine dispatch + state mirror.

The port's own copy of ``tpu3fs/storage/target.py``, with the mem engine
only: ``make_engine`` raises ``ValueError`` for any other kind (the native
engine waits for a later slice, ROADMAP M6b). A target takes a ``device``
and hands it to its engine, where its chunk checksums run.

Mirrors src/storage/store/StorageTarget.{h,cc}: a target belongs to one chain,
owns one engine instance (engine choice gated by config exactly like the
reference's only_chunk_engine switch at StorageTarget.h:85-162), and reports a
local state through heartbeats.
"""

from __future__ import annotations

from typing import Optional

from tpu3fs_torch.mgmtd.types import LocalTargetState
from tpu3fs_torch.storage.engine import ChunkEngine, MemChunkEngine
from tpu3fs_torch.storage.types import DEFAULT_CHUNK_SIZE, SpaceInfo

# mem targets have no disk behind them; advertise a finite dev-sized
# capacity so statFs math stays meaningful (ref SpaceInfo from statvfs
# in src/storage/worker/SpaceInfo)
MEM_TARGET_CAPACITY = 16 << 30


def make_engine(kind: str = "mem", device=None) -> ChunkEngine:
    if kind == "mem":
        return MemChunkEngine(device=device)
    raise ValueError(f"chunk engine {kind!r} is not ported: the port has "
                     "only the mem engine (native_engine waits for a later "
                     "slice, ROADMAP M6b)")


class StorageTarget:
    def __init__(
        self,
        target_id: int,
        chain_id: int,
        *,
        engine: str = "mem",
        path: Optional[str] = None,
        chunk_size: int = DEFAULT_CHUNK_SIZE,
        device=None,
    ):
        self.target_id = target_id
        self.chain_id = chain_id
        self.engine = make_engine(engine, device)
        self.device = self.engine.device
        self.path = path
        self.chunk_size = chunk_size
        self.local_state = LocalTargetState.UPTODATE
        # flipped by CheckWorker on low disk space (ref CheckWorker.cc
        # disk_reject_create_chunk_threshold / emergency_recycling_ratio)
        self.reject_create = False
        self.emergency_recycling = False

    def space_info(self) -> SpaceInfo:
        return SpaceInfo(
            capacity=MEM_TARGET_CAPACITY,
            used=self.engine.used_size(),
            chunk_count=len(self.engine.all_metadata()),
        )
