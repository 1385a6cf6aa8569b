"""tpu3fs_torch/ckpt — distributed training-checkpoint subsystem.

The port's own copy of ``tpu3fs/ckpt/``: pytrees of numpy arrays, tensors
and DTensors save into and restore out of the filesystem through the
normal client stack — striped batched chunk IO, meta atomic-rename commit,
QoS ``ckpt`` class, monitor recorders — no private storage path. Every
checksum runs on the client's device (one ``crc32c_many`` K2 launch a
batch); a restore hands leaves to their templates' devices.

- ``manifest``  — serde manifest, atomic-commit naming, resharding math
- ``saver``     — sharded parallel save, async commit, KV save session
- ``loader``    — resharding restore (exact byte-range reads, CRC verify)
- ``retention`` — keep-last-N/keep-every-K GC via trash, EC archival

``CheckpointManager`` bundles the three halves over one (MetaStore,
FileIoClient) pair.
"""

from __future__ import annotations

from typing import Callable, Optional

from tpu3fs_torch.ckpt.loader import CheckpointLoader
from tpu3fs_torch.ckpt.manifest import (
    MANIFEST_NAME,
    Manifest,
    LeafSpec,
    ShardSpec,
    step_dir,
    tmp_dir,
)
from tpu3fs_torch.ckpt.retention import CheckpointGC, RetentionPolicy
from tpu3fs_torch.ckpt.saver import (
    AsyncCheckpoint,
    CheckpointSaver,
    SaveSession,
)

__all__ = [
    "AsyncCheckpoint",
    "CheckpointGC",
    "CheckpointLoader",
    "CheckpointManager",
    "CheckpointSaver",
    "LeafSpec",
    "MANIFEST_NAME",
    "Manifest",
    "RetentionPolicy",
    "SaveSession",
    "ShardSpec",
    "step_dir",
    "tmp_dir",
]


class CheckpointManager:
    """Facade: save/restore/list/GC for one checkpoint root."""

    def __init__(
        self,
        meta,
        fio,
        *,
        root: str = "/ckpt",
        kv=None,
        client_id: str = "ckpt",
        layout=None,
        policy: Optional[RetentionPolicy] = None,
        trash_keep_s: int = 86400,
        session_ttl_s: float = 600.0,
        clock: Callable[[], float] = None,
    ):
        import time as _time

        clock = clock or _time.time
        self.root = root.rstrip("/") or "/ckpt"
        self.saver = CheckpointSaver(
            meta, fio, root=self.root, kv=kv, client_id=client_id,
            layout=layout, session_ttl_s=session_ttl_s, clock=clock)
        self.loader = CheckpointLoader(meta, fio, root=self.root)
        self.gc = CheckpointGC(
            meta, fio, root=self.root, policy=policy,
            trash_keep_s=trash_keep_s, client_id=f"{client_id}-gc",
            clock=clock)

    # -- save -------------------------------------------------------------
    def save(self, tree, step: int) -> Manifest:
        return self.saver.save(tree, step)

    def save_async(self, tree, step: int) -> AsyncCheckpoint:
        return self.saver.save_async(tree, step)

    # -- restore ----------------------------------------------------------
    def restore(self, step: int, like=None, *, verify: bool = True):
        return self.loader.restore(step, like, verify=verify)

    def restore_latest(self, like=None, *, verify: bool = True):
        step = self.loader.latest_step()
        if step is None:
            return None
        return self.loader.restore(step, like, verify=verify)

    def manifest(self, step: int) -> Manifest:
        return self.loader.manifest(step)

    def steps(self):
        return self.loader.steps()

    # -- retention --------------------------------------------------------
    def run_gc(self) -> int:
        return self.gc.run_once()

    def remove(self, step: int) -> None:
        self.gc.remove_step(step)

    def archive(self, step: int, layout) -> Manifest:
        return self.gc.archive_step(step, layout)
