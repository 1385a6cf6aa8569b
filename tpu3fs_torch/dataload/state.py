"""Resumable loader state: (seed, epoch, cursor) + save/restore paths.

Because the epoch order is a pure function of (seed, epoch) — the Feistel
permutation — and sharding is a pure function of (step, dp geometry), the
ENTIRE iterator state is four integers. A restored job replays none of
the consumed prefix and skips none of the remainder: resume exactness is
arithmetic, not bookkeeping.

Two composition paths:

- ``to_leaf()`` / ``from_leaf()``: the state as a tiny uint8 array leaf
  to embed in the training pytree handed to ``ckpt`` save — the loader
  cursor then commits ATOMICALLY with the model weights under the ckpt
  save session (same ``.tmp`` → rename, same manifest CRC), which is the
  property that makes "resume without sample repetition or loss" true
  end-to-end: state and weights cannot diverge by a crash between two
  separate writes.
- ``StateStore``: a standalone atomically-committed state file for
  loaders running outside a checkpoint cycle (eval jobs, packers).

The port's own copy of ``tpu3fs/dataload/state.py`` (host code).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpu3fs_torch.qos.core import TrafficClass, tagged
from tpu3fs_torch.rpc.serde import deserialize, serialize
from tpu3fs_torch.utils.result import Code, FsError
from tpu3fs_torch.utils.result import err as _err

STATE_FORMAT_VERSION = 1
_TMP_SUFFIX = ".tmp"


@dataclass
class DataloadState:
    """Position of the NEXT batch the loader will yield."""

    format_version: int = STATE_FORMAT_VERSION
    seed: int = 0
    epoch: int = 0
    step: int = 0            # global batches already consumed this epoch
    global_batch: int = 0
    num_samples: int = 0     # guard: shuffle domain must match on resume
    shuffle: bool = True

    def encode(self) -> bytes:
        return serialize(self, DataloadState)

    @staticmethod
    def decode(raw: bytes) -> "DataloadState":
        try:
            st = deserialize(bytes(raw), DataloadState)
        except Exception as e:
            raise _err(Code.DATALOAD_CORRUPT, f"state decode: {e!r}")
        if st.format_version > STATE_FORMAT_VERSION:
            raise _err(Code.DATALOAD_CORRUPT,
                       f"state format {st.format_version} > "
                       f"{STATE_FORMAT_VERSION}")
        return st

    # -- ckpt-pytree composition -----------------------------------------
    def to_leaf(self) -> np.ndarray:
        """The state as a uint8 array leaf for a checkpoint pytree."""
        return np.frombuffer(self.encode(), dtype=np.uint8).copy()

    @staticmethod
    def from_leaf(leaf) -> "DataloadState":
        return DataloadState.decode(np.asarray(leaf,
                                               dtype=np.uint8).tobytes())


class StateStore:
    """Standalone state file with the ``.tmp`` → rename commit."""

    def __init__(self, meta, fio, path: str, *,
                 client_id: str = "dataload"):
        self._meta = meta
        self._fio = fio
        self.path = path
        self._client_id = client_id

    def save(self, state: DataloadState) -> None:
        from tpu3fs_torch.meta.store import OpenFlags

        tmp = self.path + _TMP_SUFFIX
        raw = state.encode()
        with tagged(TrafficClass.DATALOAD):
            res = self._meta.create(
                tmp, flags=OpenFlags.WRITE | OpenFlags.CREATE
                | OpenFlags.TRUNC, client_id=self._client_id)
            try:
                n = self._fio.write(res.inode, 0, raw)
            except BaseException:
                try:
                    self._meta.close(res.inode.id, res.session_id)
                except FsError:
                    pass
                raise
            self._meta.close(res.inode.id, res.session_id,
                             length_hint=n, wrote=True)
            # POSIX-style rename: atomically replaces a previous state
            # file, so a crash leaves either the old or the new cursor
            self._meta.rename(tmp, self.path)

    def load(self) -> DataloadState:
        with tagged(TrafficClass.DATALOAD):
            inode = self._meta.stat(self.path)
            raw = self._fio.read(inode, 0, inode.length)
        return DataloadState.decode(raw)
