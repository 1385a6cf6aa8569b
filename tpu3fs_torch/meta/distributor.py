"""Distributor: rendezvous-hash assignment of inodes to meta servers.

The port's own copy of ``tpu3fs/meta/distributor.py``, unchanged but for its
imports.

Re-expresses the reference's meta Distributor component
(src/meta/components/Distributor.h:29-60, Distributor.cc:320): meta servers
are stateless, but per-inode *serialized* work (dynamic file-length updates,
session pruning for one inode) is sharded so exactly one server owns each
inode at a time. Ownership is rendezvous (highest-random-weight) hashing over
the set of live servers, which minimizes reshuffling when membership changes.

Liveness is tracked through heartbeat records in the shared KV store under
the "METS" prefix (the reference keeps its server map under the "META" key
prefix, src/common/kv/KeyPrefix-def.h). A server whose record is older than
the timeout drops out of the hash ring on the next `active_servers` read.
"""

from __future__ import annotations

import hashlib
import struct
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

from tpu3fs_torch.kv.kv import IKVEngine, ITransaction, with_transaction
from tpu3fs_torch.rpc.serde import deserialize, serialize

_PREFIX = b"METS"


def _server_key(server_id: int) -> bytes:
    return _PREFIX + struct.pack("<q", server_id)


def _scan_range() -> tuple:
    return _PREFIX, _PREFIX + b"\xff" * 9


@dataclass
class ServerRecord:
    server_id: int = 0
    last_heartbeat: float = 0.0


def rendezvous_owner(server_ids: List[int], inode_id: int) -> Optional[int]:
    """Highest-random-weight choice of owner for one inode."""
    best, best_weight = None, b""
    for sid in sorted(server_ids):
        weight = hashlib.blake2b(
            struct.pack("<qq", sid, inode_id), digest_size=8
        ).digest()
        if best is None or weight > best_weight:
            best, best_weight = sid, weight
    return best


class Distributor:
    def __init__(
        self,
        engine: IKVEngine,
        server_id: int,
        *,
        timeout_s: float = 30.0,
        clock: Callable[[], float] = time.time,
    ):
        self._engine = engine
        self.server_id = server_id
        self._timeout_s = timeout_s
        self._clock = clock

    # -- membership ---------------------------------------------------------
    def heartbeat(self) -> None:
        now = self._clock()

        def op(txn: ITransaction) -> None:
            txn.set(
                _server_key(self.server_id),
                serialize(ServerRecord(self.server_id, now)),
            )

        with_transaction(self._engine, op)

    def leave(self) -> None:
        def op(txn: ITransaction) -> None:
            txn.clear(_server_key(self.server_id))

        with_transaction(self._engine, op)

    def active_servers(self) -> List[int]:
        now = self._clock()
        cutoff = now - self._timeout_s

        def op(txn: ITransaction) -> List[int]:
            begin, end = _scan_range()
            out = []
            for pair in txn.get_range(begin, end, limit=0):
                rec = deserialize(pair.value, ServerRecord)
                if rec.last_heartbeat >= cutoff:
                    out.append(rec.server_id)
            return out

        return with_transaction(self._engine, op)

    # -- ownership ----------------------------------------------------------
    def owner(self, inode_id: int) -> Optional[int]:
        return rendezvous_owner(self.active_servers(), inode_id)

    def is_owner(self, inode_id: int) -> bool:
        return self.owner(inode_id) == self.server_id
