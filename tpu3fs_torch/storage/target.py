"""Per-target facade: engine dispatch + state mirror.

The port's own copy of ``tpu3fs/storage/target.py``. A target takes a
``device`` and hands it to its engine: the mem engine checksums there
(K2 on the card), the native engine (``native_engine``, the C++ engine on
disk) computes its CRCs on the host and only reports the device.

Mirrors src/storage/store/StorageTarget.{h,cc}: a target belongs to one chain,
owns one engine instance (engine choice gated by config exactly like the
reference's only_chunk_engine switch at StorageTarget.h:85-162), and reports a
local state through heartbeats.
"""

from __future__ import annotations

import os
from typing import Optional

from tpu3fs_torch.mgmtd.types import LocalTargetState
from tpu3fs_torch.storage.engine import ChunkEngine, MemChunkEngine
from tpu3fs_torch.storage.types import DEFAULT_CHUNK_SIZE, SpaceInfo

# mem targets have no disk behind them; advertise a finite dev-sized
# capacity so statFs math stays meaningful (ref SpaceInfo from statvfs
# in src/storage/worker/SpaceInfo)
MEM_TARGET_CAPACITY = 16 << 30


def make_engine(kind: str = "mem", path: Optional[str] = None,
                device=None) -> ChunkEngine:
    if kind == "mem":
        return MemChunkEngine(device=device)
    if kind in ("native", "auto"):
        try:
            from tpu3fs_torch.storage import native_engine

            native_engine._load_lib()
        except Exception:
            if kind == "native":
                raise
            # auto: the flagship C++ engine when its LIBRARY builds/loads,
            # the pure-Python engine otherwise (no toolchain). Only the
            # library probe may fall back — an engine OPEN failure over a
            # real data dir (corrupt WAL, EACCES, ENOSPC) must stay fatal,
            # or a restarted node would silently serve an empty store
            # where committed chunks exist.
            from tpu3fs_torch.utils.logging import xlog

            xlog("WARN", "native chunk engine library unavailable; "
                 "falling back to mem engine")
            return MemChunkEngine(device=device)
        # path=None -> the engine makes itself a temp dir
        return native_engine.NativeChunkEngine(path, device=device)
    raise ValueError(f"unknown chunk engine kind: {kind}")


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
        self.engine = make_engine(engine, path, device)
        self.device = self.engine.device
        self.path = path
        self.chunk_size = chunk_size
        self.local_state = LocalTargetState.UPTODATE
        # flipped by CheckWorker on low disk space (ref CheckWorker.cc
        # disk_reject_create_chunk_threshold / emergency_recycling_ratio)
        self.reject_create = False
        self.emergency_recycling = False

    def space_info(self) -> SpaceInfo:
        if self.path and not isinstance(self.engine, MemChunkEngine):
            # disk-backed: both numbers from statvfs, so space consumed by
            # anything else on the device counts as used, not free
            st = os.statvfs(self.path)
            capacity = st.f_frsize * st.f_blocks
            used = capacity - st.f_frsize * st.f_bavail
        else:
            capacity = MEM_TARGET_CAPACITY
            used = self.engine.used_size()
        return SpaceInfo(
            capacity=capacity,
            used=used,
            chunk_count=len(self.engine.all_metadata()),
        )
