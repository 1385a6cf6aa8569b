"""In-memory StorageClient double (ref src/client/storage/
StorageClientInMem.h:23-80): the full client surface backed by plain
per-chain dicts — no chains, no sockets, no engines. Consumers of the
client interface (FileIoClient, meta length settlement, tools) unit-test
against this double without standing up a fabric, exactly how the
reference uses its InMem client in meta unit tests.

The port's own copy of ``tpu3fs/client/inmem.py``, unchanged but for its
imports.

Semantics mirrored from the real client where they matter to consumers:
chunk-granular storage keyed by (chain_id, chunk_id), offset writes extend
chunks, reads clamp to the written length, remove/truncate/stat/space are
chunk-table operations. Chain/target routing, channels and retries do not
exist here by design — that is the point of the double.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from tpu3fs_torch.ops.crc32c import crc32c
from tpu3fs_torch.storage.craq import ReadReply, UpdateReply
from tpu3fs_torch.storage.types import ChunkId, Checksum, SpaceInfo
from tpu3fs_torch.utils.result import Code


class StorageClientInMem:
    """Drop-in for StorageClient in consumers that only move bytes."""

    def __init__(self, client_id: str = "inmem", *,
                 capacity: int = 1 << 40):
        self.client_id = client_id
        self._chunks: Dict[Tuple[int, Tuple], bytearray] = {}
        self._vers: Dict[Tuple[int, Tuple], int] = {}
        self._mu = threading.Lock()
        self._capacity = capacity

    # -- helpers -------------------------------------------------------------
    @staticmethod
    def _key(chain_id: int, chunk_id: ChunkId) -> Tuple[int, Tuple]:
        return (chain_id, (chunk_id.file_id, chunk_id.index))

    def _chain(self, chain_id: int):
        """Every chain exists and is a plain CR chain (consumers probe
        is_ec through this; the double has no EC plane)."""
        from tpu3fs_torch.mgmtd.types import ChainInfo

        return ChainInfo(chain_id=chain_id, chain_version=1, targets=[])

    def _reply(self, data: bytes) -> ReadReply:
        return ReadReply(Code.OK, data=data,
                         checksum=Checksum(value=crc32c(data)))

    # -- writes --------------------------------------------------------------
    def write_chunk(self, chain_id: int, chunk_id: ChunkId, offset: int,
                    data: bytes, *, chunk_size: int = 1 << 20) -> UpdateReply:
        if offset + len(data) > chunk_size:
            return UpdateReply(Code.INVALID_ARG, message="write past chunk")
        key = self._key(chain_id, chunk_id)
        with self._mu:
            buf = self._chunks.setdefault(key, bytearray())
            if len(buf) < offset + len(data):
                buf.extend(b"\x00" * (offset + len(data) - len(buf)))
            buf[offset:offset + len(data)] = data
            ver = self._vers.get(key, 0) + 1
            self._vers[key] = ver
            crc = crc32c(bytes(buf))
        return UpdateReply(Code.OK, update_ver=ver, commit_ver=ver,
                           checksum=Checksum(value=crc))

    def batch_write(self, writes: List[Tuple[int, ChunkId, int, bytes]], *,
                    chunk_size: int = 1 << 20) -> List[UpdateReply]:
        return [self.write_chunk(c, ck, off, d, chunk_size=chunk_size)
                for c, ck, off, d in writes]

    def remove_chunk(self, chain_id: int, chunk_id: ChunkId) -> bool:
        key = self._key(chain_id, chunk_id)
        with self._mu:
            self._vers.pop(key, None)
            return self._chunks.pop(key, None) is not None

    # -- reads ---------------------------------------------------------------
    def read_chunk(self, chain_id: int, chunk_id: ChunkId, offset: int = 0,
                   length: int = -1) -> ReadReply:
        key = self._key(chain_id, chunk_id)
        with self._mu:
            buf = self._chunks.get(key)
            if buf is None:
                return ReadReply(Code.CHUNK_NOT_FOUND)
            end = len(buf) if length < 0 else min(len(buf), offset + length)
            data = bytes(buf[offset:end])
        return self._reply(data)

    def batch_read(self, reqs) -> List[ReadReply]:
        return [self.read_chunk(r.chain_id, r.chunk_id, r.offset, r.length)
                for r in reqs]

    # -- metadata-facing surface ---------------------------------------------
    def query_last_chunk(self, chain_id: int, file_id: int
                         ) -> Tuple[int, int]:
        """(last index, last chunk's byte length); (-1, 0) when empty."""
        with self._mu:
            idxs = [ck[1] for (c, ck) in self._chunks
                    if c == chain_id and ck[0] == file_id]
            if not idxs:
                return -1, 0
            last = max(idxs)
            buf = self._chunks[(chain_id, (file_id, last))]
            return last, len(buf)

    def remove_file_chunks(self, chain_id: int, file_id: int) -> int:
        with self._mu:
            keys = [k for k in self._chunks
                    if k[0] == chain_id and k[1][0] == file_id]
            for k in keys:
                del self._chunks[k]
                self._vers.pop(k, None)
            return len(keys)

    def truncate_file_chunks(self, chain_id: int, file_id: int,
                             last_index: int, last_length: int) -> int:
        removed = 0
        with self._mu:
            for k in list(self._chunks):
                if k[0] != chain_id or k[1][0] != file_id:
                    continue
                if k[1][1] > last_index:
                    del self._chunks[k]
                    self._vers.pop(k, None)
                    removed += 1
                elif k[1][1] == last_index:
                    del self._chunks[k][last_length:]
        return removed

    def space_info(self) -> SpaceInfo:
        with self._mu:
            used = sum(len(b) for b in self._chunks.values())
            count = len(self._chunks)
        return SpaceInfo(capacity=self._capacity, used=used,
                         chunk_count=count)

    def close(self) -> None:
        pass
