"""Partition routing math — the ONE pure function set every party
shares (docs/metashard.md).

The port's own copy of ``tpu3fs/metashard/partition.py``,
unchanged but for its imports.

The namespace splits into a FIXED number of partitions (set at cluster
bootstrap; ownership moves, the count does not):

- **by-path ops** (create/stat/open/remove/list/...) partition on the
  DIRECTORY HASH of the parent path: every name under one directory maps
  to one partition, so a create storm into a directory serializes on one
  owner and two racing mutations of the same dirent always meet the same
  server. Distinct directories spread by hash.
- **by-inode ops** (close/sync/truncate/set_attr/batch_stat by id)
  partition on the INODE ID: the partitioned allocator bakes the owning
  partition into the high bits of every id it hands out
  (``partition_tag``), so ``partition_of_inode`` is arithmetic, not a
  lookup. ``ShardedMetaStore`` allocates a new file's inode id from the
  partition of the create op itself, so the create and every later
  by-inode op on that file land on the SAME partition.

Hashing is blake2b (stable across processes and Python runs — never
``hash()``, which is salted per-interpreter) over the normalized parent
path, mirroring ``MetaStore._split`` normalization so client and server
agree byte-for-byte.

Correctness does NOT depend on routing: all partitions read one shared
transactional KV, so a mis-routed op (stale table) is fenced by the
owner check and retried, never wrong. Ownership buys serialization
(per-directory mutations meet one server), cache locality, and load
spread — the reference's stateless-meta-over-FDB premise (PAPER.md §0)
is what makes this carve-up safe.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional

#: default partition count (mgmtd ``--meta-partitions`` overrides at
#: bootstrap; must stay fixed for the cluster's life because inode ids
#: bake their partition id in)
DEFAULT_PARTITIONS = 8

#: inode ids are 64-bit; the top 16 bits carry (partition_id + 1) for
#: ids from the partitioned allocator (0 = legacy/unpartitioned id)
PID_SHIFT = 48
_TAG_MASK = (1 << 16) - 1


def partition_tag(pid: int) -> int:
    """The high-bits tag the partitioned inode allocator stamps on ids
    it hands out for partition ``pid``."""
    return (pid + 1) << PID_SHIFT


def partition_of_inode(inode_id: int, nparts: int) -> int:
    """Partition owning by-inode ops for ``inode_id``. Tagged ids decode
    their baked partition; legacy ids (root, pre-metashard trees) spread
    by modulo so they still route deterministically."""
    if nparts <= 1:
        return 0
    tag = (inode_id >> PID_SHIFT) & _TAG_MASK
    if tag:
        return (tag - 1) % nparts
    return inode_id % nparts


def normalize_parts(path: str) -> List[str]:
    """`MetaStore._split` normalization without the length checks: the
    routing hash must agree with the server's resolution for every path
    the server would accept."""
    parts = [p for p in path.split("/") if p and p != "."]
    out: List[str] = []
    for p in parts:
        if p == "..":
            if out:
                out.pop()
        else:
            out.append(p)
    return out


def parent_dir(path: str) -> str:
    """Normalized parent-directory string of ``path`` ("/" for root or
    top-level names)."""
    parts = normalize_parts(path)
    return "/" + "/".join(parts[:-1]) if len(parts) > 1 else "/"


def partition_of_path(path: str, nparts: int) -> int:
    """Partition owning by-path ops on ``path``: directory hash over the
    normalized parent path. Pure and salt-free, so every client, server,
    and the CLI compute the same answer."""
    if nparts <= 1:
        return 0
    digest = hashlib.blake2b(parent_dir(path).encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "big") % nparts


def partition_of_dir(dir_path: str, nparts: int) -> int:
    """Partition owning the CONTENTS of ``dir_path`` (list/scan ops):
    the same hash ``partition_of_path`` applies to children of it."""
    if nparts <= 1:
        return 0
    parts = normalize_parts(dir_path)
    norm = "/" + "/".join(parts) if parts else "/"
    digest = hashlib.blake2b(norm.encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "big") % nparts


def owner_node(routing, pid: int) -> Optional[int]:
    """node_id owning partition ``pid`` per a RoutingInfo snapshot, or
    None when the table is absent/unassigned (single-meta compat)."""
    table = getattr(routing, "meta_partitions", None) or {}
    row = table.get(pid)
    return row.node_id if row is not None and row.node_id else None
