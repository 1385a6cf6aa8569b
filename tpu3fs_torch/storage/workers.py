"""Storage maintenance workers (ref src/storage/worker/).

Four background jobs the reference runs per storage server:

- CheckWorker (ref src/storage/worker/CheckWorker.cc:98-213): probe every
  target's disk — statvfs failure or a failed write probe offlines the
  targets on that path; low-space thresholds flip per-target flags
  (reject_create below the create threshold, emergency_recycling above the
  recycling ratio); disk gauges recorded per target.
- DumpWorker (ref src/storage/worker/DumpWorker.cc): periodic chunk-metadata
  dumps per target for offline analysis (the analytics module provides the
  writer).
- PunchHoleWorker (ref src/storage/worker/PunchHoleWorker.cc): reclaim
  space held by removed chunks — the native engine compacts punched holes;
  mem engines have nothing to reclaim.
- AllocateWorker (ref src/storage/worker/AllocateWorker.cc): keep allocator
  headroom warm. Our engines allocate inline, so this worker only records
  headroom metrics (capacity - used) and enforces the emergency-recycling
  flag by running an immediate compaction pass.

All are plain run_once() objects driven by the storage app's loops — the
test fabric calls run_once() directly, exactly like the reference's unit
tests drive worker iterations.

The port's own copy of ``tpu3fs/storage/workers.py``, over the port's
``StorageService``. Its dumps go through the port's ``analytics/trace.py``
(Parquet where ``pyarrow`` imports, NPZ otherwise). CheckWorker probes
a native target's disk through its ``space_info`` (statvfs), and
PunchHoleWorker compacts native engines.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Optional

from tpu3fs_torch.analytics.trace import write_records
from tpu3fs_torch.mgmtd.types import LocalTargetState
from tpu3fs_torch.monitor.recorder import CounterRecorder, ValueRecorder
from tpu3fs_torch.storage.craq import StorageService
from tpu3fs_torch.storage.target import StorageTarget
from tpu3fs_torch.utils.logging import xlog


class CheckWorker:
    """Disk health probe; offlines targets on bad disks.

    ref CheckWorker.cc:152-174 — space() failure or readonly disk =>
    offlineTargets(path); :201-213 — emergency recycling ratio.
    """

    def __init__(
        self,
        service: StorageService,
        *,
        reject_create_threshold: float = 0.98,
        emergency_recycling_ratio: float = 0.95,
        on_offline: Optional[Callable[[StorageTarget], None]] = None,
    ):
        self._service = service
        self.reject_create_threshold = reject_create_threshold
        self.emergency_recycling_ratio = emergency_recycling_ratio
        self._on_offline = on_offline
        # per-target gauges, tagged like the reference's per-instance
        # TagSets (CheckWorker.cc:104-107)
        self._capacity: dict = {}
        self._free: dict = {}
        self._offlined = CounterRecorder("storage.check_disk.offlined")

    def _gauges(self, target_id: int):
        if target_id not in self._capacity:
            tags = {"target": str(target_id)}
            self._capacity[target_id] = ValueRecorder(
                "storage.disk_info.capacity", tags)
            self._free[target_id] = ValueRecorder(
                "storage.disk_info.free", tags)
        return self._capacity[target_id], self._free[target_id]

    def _probe_writable(self, path: str) -> bool:
        """ref CheckWorker checkWritable: write+fsync+unlink a probe file."""
        probe = os.path.join(path, ".tpu3fs-health-probe")
        try:
            fd = os.open(probe, os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o600)
            try:
                os.write(fd, b"probe")
                os.fsync(fd)
            finally:
                os.close(fd)
            os.unlink(probe)
            return True
        except OSError:
            return False

    def _offline(self, target: StorageTarget, why: str) -> None:
        if target.local_state == LocalTargetState.OFFLINE:
            return
        target.local_state = LocalTargetState.OFFLINE
        self._offlined.add(1)
        xlog("CRITICAL", "check disk failed for target %d: %s",
             target.target_id, why)
        if self._on_offline is not None:
            self._on_offline(target)

    def run_once(self) -> int:
        """Probe all targets; returns how many were offlined this pass."""
        offlined = 0
        for target in self._service.targets():
            if target.local_state == LocalTargetState.OFFLINE:
                continue
            if not target.path:
                continue  # mem target: no disk to fail
            try:
                st = os.statvfs(target.path)
            except OSError as e:
                self._offline(target, f"statvfs: {e}")
                offlined += 1
                continue
            if not self._probe_writable(target.path):
                self._offline(target, "readonly or unwritable")
                offlined += 1
                continue
            capacity = st.f_frsize * st.f_blocks
            free = st.f_frsize * st.f_bavail
            cap_g, free_g = self._gauges(target.target_id)
            cap_g.set(capacity)
            free_g.set(free)
            usage = 1.0 - free / max(1, capacity)
            target.reject_create = usage >= self.reject_create_threshold
            target.emergency_recycling = usage >= self.emergency_recycling_ratio
        return offlined


class DumpWorker:
    """Periodic chunk-metadata dumps (ref DumpWorker.cc loop).

    One file per (timestamp, target), written by analytics.trace's
    write_records and read back by its read_records for fsck-style
    offline scans (the reference's dump files feed admin DumpChunkMeta)."""

    def __init__(self, service: StorageService, dump_dir: str,
                 node_id: int = 0):
        self._service = service
        self._dir = dump_dir
        self._node_id = node_id
        self._dumps = CounterRecorder("storage.dump.files")

    def run_once(self) -> List[str]:
        os.makedirs(self._dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        out: List[str] = []
        for target in self._service.targets():
            rows = [
                {
                    "file_id": meta.chunk_id.file_id,
                    "chunk_index": meta.chunk_id.index,
                    "committed_ver": meta.committed_ver,
                    "pending_ver": meta.pending_ver,
                    "chain_ver": meta.chain_ver,
                    "length": meta.length,
                    "checksum": meta.checksum.value,
                }
                for meta in target.engine.all_metadata()
            ]
            path = os.path.join(
                self._dir,
                f"chunkmeta-{stamp}-node{self._node_id}"
                f"-target{target.target_id}",
            )
            out.append(write_records(path, rows))
            self._dumps.add(1)
        return out


class PunchHoleWorker:
    """Reclaim removed-chunk space (ref PunchHoleWorker.cc loop: recycle
    batches of removed chunks every pass)."""

    def __init__(self, service: StorageService):
        self._service = service
        self._passes = CounterRecorder("storage.punch_hole.passes")

    def run_once(self) -> int:
        compacted = 0
        for target in self._service.targets():
            compact = getattr(target.engine, "compact", None)
            if compact is not None:
                compact()
                compacted += 1
        self._passes.add(1)
        return compacted


class AllocateWorker:
    """Allocator headroom keeper (ref AllocateWorker.cc). Our engines
    allocate inline, so the worker records headroom and forces an immediate
    compaction for targets flagged emergency_recycling by CheckWorker."""

    def __init__(self, service: StorageService):
        self._service = service
        self._headroom: dict = {}

    def run_once(self) -> int:
        emergencies = 0
        for target in self._service.targets():
            si = target.space_info()
            gauge = self._headroom.get(target.target_id)
            if gauge is None:
                gauge = self._headroom[target.target_id] = ValueRecorder(
                    "storage.allocate.headroom",
                    {"target": str(target.target_id)})
            gauge.set(max(0, si.capacity - si.used))
            if getattr(target, "emergency_recycling", False):
                compact = getattr(target.engine, "compact", None)
                if compact is not None:
                    compact()
                emergencies += 1
        return emergencies
