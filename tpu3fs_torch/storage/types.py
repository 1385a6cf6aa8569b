"""Storage wire/engine types: chunk ids, versions, checksums, update kinds.

The port's own copy of ``tpu3fs/storage/types.py``. ``Checksum.of`` and
``Checksum.of_many`` take a ``device`` and checksum through
``ops.crc32c.crc32c_many``: one K2 launch on the card, the plain version
on the CPU.

Re-expresses src/fbs/storage/Common.h: ChunkId, the committed/pending version
algebra (committed version v, pending u = v+1 — docs/design_notes.md "Data
replication"), CRC32C ChecksumInfo with combine() (Common.h:66-199), and
UpdateType (Common.h:51). Default chunk size 1 MiB (kChunkSize, Common.h:118).
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field

from tpu3fs_torch.ops.crc32c import crc32c_combine, crc32c_many

DEFAULT_CHUNK_SIZE = 1 << 20


class UpdateType(enum.IntEnum):
    WRITE = 1
    REMOVE = 2
    TRUNCATE = 3
    EXTEND = 4


@dataclass(frozen=True, order=True)
class ChunkId:
    """(file inode id, chunk index): prefix-scannable per file."""

    file_id: int
    index: int

    def to_bytes(self) -> bytes:
        return struct.pack(">QI", self.file_id, self.index)

    @staticmethod
    def from_bytes(raw: bytes) -> "ChunkId":
        f, i = struct.unpack(">QI", raw)
        return ChunkId(f, i)

    @staticmethod
    def file_prefix(file_id: int) -> bytes:
        return struct.pack(">Q", file_id)


@dataclass
class Checksum:
    """CRC32C checksum (ref ChecksumInfo, fbs/storage/Common.h:66-199)."""

    value: int = 0
    length: int = 0

    @staticmethod
    def of(data: bytes, device=None) -> "Checksum":
        return Checksum.of_many([data], device)[0]

    @staticmethod
    def of_many(bufs, device=None) -> "list":
        """Checksums of a sequence of buffers with ONE K2 launch on
        ``device`` (``crc32c_many``; the plain version on the CPU)."""
        return [Checksum(c, len(b))
                for c, b in zip(crc32c_many(bufs, device), bufs)]

    def combine(self, other: "Checksum") -> "Checksum":
        return Checksum(
            crc32c_combine(self.value, other.value, other.length),
            self.length + other.length,
        )

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Checksum)
            and self.value == other.value
            and self.length == other.length
        )


@dataclass
class ChunkMeta:
    """Per-chunk metadata as stored by the engine."""

    chunk_id: ChunkId
    chain_ver: int = 1
    committed_ver: int = 0
    pending_ver: int = 0          # 0 = no pending update
    length: int = 0               # committed content length
    checksum: Checksum = field(default_factory=Checksum)
    # staged pending block (valid while pending_ver != 0): lets the chain
    # checksum cross-check run without materializing chunk content back
    # into Python (ref StorageOperator.cc:464-482)
    pending_length: int = 0
    pending_checksum: Checksum = field(default_factory=Checksum)
    # opaque per-chunk tag promoted with the content at commit; the EC
    # stripe path stores the stripe's logical (pre-padding) byte length
    aux: int = 0


@dataclass
class SpaceInfo:
    capacity: int = 0
    used: int = 0
    chunk_count: int = 0
