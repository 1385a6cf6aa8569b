"""Namespace scan + structured meta event log.

Re-expresses src/meta/event/{Event.cc,Scan.cc}: full-namespace iteration over
the raw KV layout (every inode / every dirent, streamed in key order without
loading the tree) for offline jobs — orphan detection, usage accounting,
backup walks — plus a structured event row the meta service appends to an
analytics trace log on each mutating op (the reference streams meta events
the same way its storage path streams StorageEventTrace rows).

The port's own copy of ``tpu3fs/meta/scan.py``, over the port's KV and
meta types, written through the port's ``analytics/trace.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Tuple

from tpu3fs_torch.analytics.trace import StructuredTraceLog
from tpu3fs_torch.kv.kv import IKVEngine, ITransaction, KeyPrefix, with_transaction
from tpu3fs_torch.meta.types import DirEntry, Inode
from tpu3fs_torch.rpc.serde import deserialize


@dataclass
class MetaEvent:
    """One mutating-op row (ref src/meta/event/Event.cc row types)."""

    ts: float = 0.0
    op: str = ""            # create/mkdir/remove/rename/...
    path: str = ""
    inode_id: int = 0
    uid: int = 0
    detail: str = ""


class MetaEventLog:
    """Append-only structured event stream (rides analytics.trace)."""

    def __init__(self, directory: str, *, flush_rows: int = 256):
        self._log = StructuredTraceLog(
            "meta_events", directory, flush_rows=flush_rows)

    def append(self, op: str, path: str, *, inode_id: int = 0,
               uid: int = 0, detail: str = "") -> None:
        self._log.append(MetaEvent(
            ts=time.time(), op=op, path=path,
            inode_id=inode_id, uid=uid, detail=detail))

    def flush(self) -> None:
        self._log.flush()

    @property
    def paths(self) -> List[str]:
        return self._log.paths


# -- namespace scans ---------------------------------------------------------

_SCAN_BATCH = 512


def _scan_prefix(engine: IKVEngine, prefix: bytes, decode) -> Iterator:
    """Iterate every value under a 4-byte prefix in key order, in bounded
    transaction batches so one scan never pins a huge snapshot."""
    cursor = prefix
    end = prefix + b"\xff" * 16
    while True:
        def op(txn: ITransaction):
            return txn.get_range(cursor, end, limit=_SCAN_BATCH,
                                 snapshot=True)

        pairs = with_transaction(engine, op, read_only=True)
        if not pairs:
            return
        for pair in pairs:
            yield decode(pair.value)
        cursor = pairs[-1].key + b"\x00"


def scan_inodes(engine: IKVEngine) -> Iterator[Inode]:
    """Every inode record, in id order (ref Scan.cc inode walk)."""
    return _scan_prefix(
        engine, KeyPrefix.INODE.value, lambda v: deserialize(v, Inode))


def scan_dirents(engine: IKVEngine) -> Iterator[DirEntry]:
    """Every directory entry, grouped by parent (key order)."""
    return _scan_prefix(
        engine, KeyPrefix.DIR_ENTRY.value, lambda v: deserialize(v, DirEntry))


def find_orphan_inodes(engine: IKVEngine) -> List[Inode]:
    """Inodes unreachable from any dirent (excluding the root): the
    namespace-integrity check admin_cli exposes (ref FindOrphanedChunks'
    meta-side sibling)."""
    referenced = {ent.inode_id for ent in scan_dirents(engine)}
    from tpu3fs_torch.meta.types import ROOT_INODE_ID

    return [
        ino for ino in scan_inodes(engine)
        if ino.id != ROOT_INODE_ID and ino.id not in referenced
        and ino.nlink > 0
    ]


def namespace_stats(engine: IKVEngine) -> dict:
    """One-pass usage accounting over the raw layout."""
    files = dirs = symlinks = 0
    total_length = 0
    for ino in scan_inodes(engine):
        if ino.is_file():
            files += 1
            total_length += ino.length
        elif ino.is_dir():
            dirs += 1
        else:
            symlinks += 1
    return {
        "files": files,
        "dirs": dirs,
        "symlinks": symlinks,
        "total_length": total_length,
    }
