"""Metadata schema: inodes, directory entries, file layouts.

The port's own copy of ``tpu3fs/meta/types.py``,
unchanged but for its imports.

Re-expresses the reference's meta schema (src/fbs/meta/Service.h — Inode,
DirEntry, Layout with chain-table ref / chunk size / stripe; key layout
documented in docs/design_notes.md "File metadata on transactional key-value
store"): inodes under "INOD"+id, dirents under "DENT"+parent+name, so a
directory listing is one range scan and path resolution is point gets.

The Layout maps chunk index -> chain: a file stripes over ``stripe_size``
chains drawn from a chain table, starting at a seeded shuffle — the
data-parallel axis of the filesystem (SURVEY.md §0.2).
"""

from __future__ import annotations

import enum
import functools
import random
import struct
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tpu3fs_torch.kv.kv import KeyPrefix

ROOT_INODE_ID = 1

# permission bits (POSIX-style subset)
PERM_R, PERM_W, PERM_X = 4, 2, 1


class InodeType(enum.IntEnum):
    FILE = 1
    DIRECTORY = 2
    SYMLINK = 3


@dataclass
class Acl:
    uid: int = 0
    gid: int = 0
    perm: int = 0o755

    def check(self, uid: int, gid: int, want: int,
              groups: tuple = (), root: bool = False) -> bool:
        """want: bitmask of PERM_R/W/X. uid 0 (or root flag) bypasses."""
        if uid == 0 or root:
            return True
        if uid == self.uid:
            bits = (self.perm >> 6) & 7
        elif gid == self.gid or self.gid in groups:
            bits = (self.perm >> 3) & 7
        else:
            bits = self.perm & 7
        return (bits & want) == want

    def check_user(self, user, want: int) -> bool:
        """Acl check for a User carrying supplementary groups/root flag."""
        return self.check(user.uid, user.gid, want,
                          getattr(user, "groups", ()),
                          getattr(user, "root", False))


@functools.lru_cache(maxsize=4096)
def _shuffled_order(seed: int, n: int) -> tuple:
    """Deterministic stripe permutation, cached — chain_of_chunk is on the
    per-chunk IO path."""
    order = list(range(n))
    random.Random(seed).shuffle(order)
    return tuple(order)


@dataclass
class Layout:
    """Chunk -> chain placement for one file."""

    table_id: int = 1
    chains: List[int] = field(default_factory=list)  # stripe_size chain ids
    chunk_size: int = 1 << 20  # ref default kChunkSize=1MB (fbs/storage/Common.h:118)
    seed: int = 0

    @property
    def stripe_size(self) -> int:
        return len(self.chains)

    def chain_of_chunk(self, chunk_index: int) -> int:
        """Chunk i lives on a seed-shuffled round-robin chain of the stripe
        (ref docs/design_notes.md "Location of file chunks")."""
        order = _shuffled_order(self.seed, len(self.chains))
        return self.chains[order[chunk_index % len(self.chains)]]

    def chunk_of_offset(self, offset: int) -> int:
        return offset // self.chunk_size


@dataclass
class Inode:
    id: int
    type: InodeType
    acl: Acl
    nlink: int = 1
    atime: float = 0.0
    mtime: float = 0.0
    ctime: float = 0.0
    # FILE:
    layout: Optional[Layout] = None
    length: int = 0           # hint; precise on close/fsync (design_notes
                              # "Dynamic file attributes")
    length_hint_ver: int = 0
    # SYMLINK:
    symlink_target: str = ""
    # DIRECTORY:
    parent: int = 0
    locked_by: str = ""  # lockDirectory owner; "" = unlocked
    # extended attributes (ref FuseOps.cc setxattr/getxattr/listxattr/
    # removexattr in the lowlevel ops table, :2580-2613)
    xattrs: Dict[str, bytes] = field(default_factory=dict)

    @staticmethod
    def new_file(id: int, acl: Acl, layout: Layout) -> "Inode":
        now = time.time()
        return Inode(id, InodeType.FILE, acl, 1, now, now, now, layout=layout)

    @staticmethod
    def new_dir(id: int, acl: Acl, parent: int) -> "Inode":
        now = time.time()
        return Inode(id, InodeType.DIRECTORY, acl, 1, now, now, now, parent=parent)

    @staticmethod
    def new_symlink(id: int, acl: Acl, target: str) -> "Inode":
        now = time.time()
        return Inode(
            id, InodeType.SYMLINK, acl, 1, now, now, now, symlink_target=target
        )

    def is_file(self) -> bool:
        return self.type == InodeType.FILE

    def is_dir(self) -> bool:
        return self.type == InodeType.DIRECTORY

    def is_symlink(self) -> bool:
        return self.type == InodeType.SYMLINK


@dataclass
class DirEntry:
    parent: int
    name: str
    inode_id: int
    type: InodeType


@dataclass
class FileSession:
    """A write-open session (ref src/meta/store/FileSession.cc; "INOS" keys).

    Sessions make close/prune idempotent and let mgmtd-side client-session
    expiry reclaim writes of dead clients.
    """

    inode_id: int
    client_id: str
    session_id: str
    opened_at: float = 0.0
    # identity that opened the session: close is authorized against this
    # (the session is the capability granted at open; POSIX checks
    # permission at open, not close), 0 = dev mode / root
    uid: int = 0


# -- key codecs -------------------------------------------------------------

def inode_key(inode_id: int) -> bytes:
    return KeyPrefix.INODE.value + struct.pack(">Q", inode_id)


def dirent_key(parent: int, name: str) -> bytes:
    return KeyPrefix.DIR_ENTRY.value + struct.pack(">Q", parent) + name.encode()


def dirent_scan_range(parent: int) -> tuple:
    base = KeyPrefix.DIR_ENTRY.value + struct.pack(">Q", parent)
    return base, base + b"\xff" * 8


def session_key(inode_id: int, session_id: str) -> bytes:
    return (
        KeyPrefix.INODE_SESSION.value
        + struct.pack(">Q", inode_id)
        + session_id.encode()
    )


def session_scan_range(inode_id: Optional[int] = None) -> tuple:
    if inode_id is None:
        base = KeyPrefix.INODE_SESSION.value
        return base, base + b"\xff" * 9
    base = KeyPrefix.INODE_SESSION.value + struct.pack(">Q", inode_id)
    return base, base + b"\xff" * 8


def idempotent_key(client_id: str, request_id: str,
                   uid: Optional[int] = None) -> bytes:
    """With a uid, the cached result is scoped to that identity: a replay of
    another client's (client_id, request_id) by a different authenticated
    user misses the cache and goes through the normal authorization path
    instead of reading the cached inode."""
    scope = f"{client_id}/{request_id}" if uid is None else \
        f"{client_id}/{request_id}@{uid}"
    return KeyPrefix.IDEMPOTENT.value + scope.encode()


GC_PREFIX = b"GCQU"  # GC queue records (analogue of the ref's GC directories)


def gc_key(inode_id: int) -> bytes:
    return GC_PREFIX + struct.pack(">Q", inode_id)


def gc_scan_range() -> tuple:
    return GC_PREFIX, GC_PREFIX + b"\xff" * 8
