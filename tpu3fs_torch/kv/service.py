"""Network KV service: the shared transactional store for meta/mgmtd.

The port's own copy of ``tpu3fs/kv/service.py``, unchanged but for its
imports.

Plays the role FoundationDB plays in the reference (src/fdb/FDBTransaction.h,
HybridKvEngine selecting mem vs fdb): meta servers are stateless and mgmtd
elects its primary by CAS, which only works if every server sees ONE
transactional KV. This service exposes the MVCC engine (kv/mem.py) over RPC
with FDB's client model: the client takes a snapshot version, reads at that
version, buffers writes locally, and submits one atomic commit carrying its
read set — the server validates conflicts and applies (optimistic
concurrency, same retry loop as local transactions).

Durability: an optional write-ahead log records every applied commit; on
restart the service replays it into a fresh engine (the reference gets this
from FDB itself). The WAL is BOUNDED: when it outgrows
max(compact_min_bytes, 4x the last snapshot), it is rewritten as one
snapshot record (the full live dump at the current version) — replay is
then snapshot + tail, and sustained commit load cannot grow the log or the
restart time without bound. The snapshot record carries the commit version
so versionstamp monotonicity survives restarts.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from tpu3fs_torch.kv.mem import MemKVEngine
from tpu3fs_torch.rpc.net import RpcServer, ServiceDef
from tpu3fs_torch.rpc.serde import deserialize, serialize
from tpu3fs_torch.utils.result import Code, FsError, Status

KV_SERVICE_ID = 5

_SNAPSHOT_TTL_S = 60.0


# -- wire schemas ------------------------------------------------------------

@dataclass
class SnapshotReq:
    client_id: str = ""


@dataclass
class SnapshotRsp:
    version: int = 0


@dataclass
class GetReq:
    key: bytes = b""
    version: int = 0


@dataclass
class GetRsp:
    found: bool = False
    value: bytes = b""


@dataclass
class RangeReq:
    begin: bytes = b""
    end: bytes = b""
    version: int = 0
    limit: int = 0
    reverse: bool = False


@dataclass
class RangePair:
    key: bytes = b""
    value: bytes = b""


@dataclass
class RangeRsp:
    pairs: List[RangePair] = field(default_factory=list)


@dataclass
class WriteEntry:
    key: bytes = b""
    value: bytes = b""
    tombstone: bool = False


@dataclass
class RangeEntry:
    begin: bytes = b""
    end: bytes = b""


@dataclass
class StampEntry:
    prefix: bytes = b""
    suffix: bytes = b""
    value: bytes = b""


@dataclass
class CommitReq:
    read_version: int = 0
    read_keys: List[bytes] = field(default_factory=list)
    read_ranges: List[RangeEntry] = field(default_factory=list)
    writes: List[WriteEntry] = field(default_factory=list)
    clear_ranges: List[RangeEntry] = field(default_factory=list)
    versionstamped: List[StampEntry] = field(default_factory=list)


@dataclass
class CommitRsp:
    version: int = 0


@dataclass
class ReleaseReq:
    version: int = 0


@dataclass
class EmptyMsg:
    pass


# -- WAL record --------------------------------------------------------------

@dataclass
class WalRecord:
    version: int = 0
    writes: List[WriteEntry] = field(default_factory=list)
    clear_ranges: List[RangeEntry] = field(default_factory=list)
    # true on the snapshot record a compaction writes: `writes` is the FULL
    # live dump at `version`, and replay fast-forwards the engine version
    snapshot: bool = False


class KvService:
    """Server half: MVCC engine + remote-snapshot pinning + WAL."""

    def __init__(self, engine: Optional[MemKVEngine] = None, *,
                 wal_path: Optional[str] = None,
                 snapshot_ttl_s: float = _SNAPSHOT_TTL_S,
                 compact_min_bytes: int = 4 << 20,
                 fsync: bool = False):
        # NOTE: set_snapshot_ttl supports hot config updates
        self.engine = engine or MemKVEngine()
        self._ttl = snapshot_ttl_s
        self._lock = threading.Lock()
        self._pins: Dict[int, Tuple[int, float]] = {}  # token -> (ver, dl)
        self._next_token = 1
        self._wal_path = wal_path
        self._wal = None
        self._fsync = fsync
        self._compact_min_bytes = compact_min_bytes
        self._wal_bytes = 0
        self._snap_bytes = 0
        # serializes commit_external + WAL append so file order == version
        # order (RpcServer dispatches concurrently)
        self._commit_lock = threading.Lock()
        if wal_path:
            valid = self._replay_wal(wal_path)
            # truncate any torn tail record BEFORE reopening for append, or
            # post-restart commits land after the garbage and are lost on
            # the next replay
            if (valid is not None and os.path.exists(wal_path)
                    and valid < os.path.getsize(wal_path)):
                with open(wal_path, "r+b") as f:
                    f.truncate(valid)
            self._wal = open(wal_path, "ab")
            self._wal_bytes = os.path.getsize(wal_path)
            self._snap_bytes = self._wal_bytes
        # snapshots below the floor may reference pruned MVCC history:
        # reject them with KV_TXN_TOO_OLD instead of silently misreading
        self._floor = self.engine.version

    # -- WAL ----------------------------------------------------------------
    def _replay_wal(self, path: str):
        """Replay; returns the byte length of the valid prefix (for
        truncating a torn tail) or None if the file doesn't exist."""
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            raw = f.read()
        pos = 0
        while pos + 4 <= len(raw):
            n = int.from_bytes(raw[pos:pos + 4], "big")
            if pos + 4 + n > len(raw):
                break  # torn tail record (write was never acked)
            try:
                rec = deserialize(raw[pos + 4:pos + 4 + n], WalRecord)
            except Exception:
                break  # corrupt tail
            writes = {
                w.key: (None if w.tombstone else w.value) for w in rec.writes
            }
            clears = [(r.begin, r.end) for r in rec.clear_ranges]
            self.engine.commit_external(
                self.engine.version, [], [], writes, clears, [])
            if rec.snapshot:
                # versionstamped keys must stay monotonic across restarts
                self.engine.restore_version_floor(rec.version)
            pos += 4 + n
        return pos

    def _wal_append(self, version: int,
                    writes: Dict[bytes, Optional[bytes]],
                    clears: List[Tuple[bytes, bytes]]) -> None:
        if self._wal is None:
            return
        rec = WalRecord(
            version=version,
            writes=[WriteEntry(k, v if v is not None else b"", v is None)
                    for k, v in writes.items()],
            clear_ranges=[RangeEntry(b, e) for b, e in clears],
        )
        raw = serialize(rec)
        self._wal.write(len(raw).to_bytes(4, "big") + raw)
        self._wal.flush()
        if self._fsync:
            os.fsync(self._wal.fileno())
        self._wal_bytes += 4 + len(raw)

    def _maybe_compact(self) -> None:
        """Caller holds _commit_lock. Rewrite the WAL as ONE snapshot
        record when it outgrows max(compact_min_bytes, 4x last snapshot):
        replay becomes snapshot + tail, and sustained commits cannot grow
        the log without bound (the role RocksDB compaction / FDB's own
        storage plays in the reference)."""
        if self._wal is None:
            return
        if self._wal_bytes <= max(self._compact_min_bytes,
                                  4 * self._snap_bytes):
            return
        version = self.engine.version
        pairs = self.engine.dump_at(version)
        rec = WalRecord(
            version=version,
            writes=[WriteEntry(k, v, False) for k, v in pairs],
            snapshot=True,
        )
        raw = serialize(rec)
        tmp = self._wal_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(len(raw).to_bytes(4, "big") + raw)
            f.flush()
            os.fsync(f.fileno())
        self._wal.close()
        os.replace(tmp, self._wal_path)   # atomic swap: old WAL or new, never half
        self._wal = open(self._wal_path, "ab")
        self._wal_bytes = os.path.getsize(self._wal_path)
        self._snap_bytes = self._wal_bytes

    # -- snapshot pinning ----------------------------------------------------
    def _sweep_pins(self, now: float) -> None:
        dead = [t for t, (_, dl) in self._pins.items() if dl < now]
        for t in dead:
            del self._pins[t]
            self.engine.unpin_version(("kvd", t))
        # raise the floor whenever no pin holds an older version — versions
        # below it may lose MVCC history to pruning, so reads/commits at
        # them must fail with KV_TXN_TOO_OLD rather than silently misread
        live = [v for v, _ in self._pins.values()]
        self._floor = max(self._floor,
                          min(live) if live else self.engine.version)

    def _check_version(self, version: int) -> None:
        # _floor is only raised by _sweep_pins under _lock; read it under the
        # same lock so a concurrent sweep orders strictly before or after
        with self._lock:
            floor = self._floor
        if version < floor:
            raise FsError(Status(
                Code.KV_TXN_TOO_OLD,
                f"snapshot {version} expired (floor {floor})"))

    # -- ops ------------------------------------------------------------------
    def snapshot(self, req: SnapshotReq) -> SnapshotRsp:
        now = time.monotonic()
        with self._lock:
            self._sweep_pins(now)
            token = self._next_token
            self._next_token += 1
            version = self.engine.version
            self._pins[token] = (version, now + self._ttl)
            self.engine.pin_version(("kvd", token), version)
        return SnapshotRsp(version=version)

    def get(self, req: GetReq) -> GetRsp:
        self._check_version(req.version)
        val = self.engine.read_at(req.key, req.version)
        # re-check AFTER the read: if a concurrent sweep raised the floor
        # past our version, a commit may have pruned the MVCC history this
        # read resolved against — fail loudly rather than return a silent
        # misread (sweep raises the floor before any prune can run, so a
        # read that passes the post-check saw intact history)
        self._check_version(req.version)
        return GetRsp(found=val is not None, value=val or b"")

    def get_range(self, req: RangeReq) -> RangeRsp:
        self._check_version(req.version)
        pairs = self.engine.range_at(req.begin, req.end, req.version)
        self._check_version(req.version)  # see get(): post-read floor check
        if req.reverse:
            pairs = list(reversed(pairs))
        if req.limit:
            pairs = pairs[:req.limit]
        return RangeRsp(pairs=[RangePair(k, v) for k, v in pairs])

    def commit(self, req: CommitReq) -> CommitRsp:
        writes = {
            w.key: (None if w.tombstone else w.value) for w in req.writes
        }
        clears = [(r.begin, r.end) for r in req.clear_ranges]
        stamps = [(s.prefix, s.suffix, s.value) for s in req.versionstamped]
        with self._commit_lock:
            # floor check must happen INSIDE _commit_lock: MVCC history is
            # only pruned by commit_external (serialized on this lock), so a
            # sweep that expires this txn's pin either raised the floor
            # before this check (we reject) or the commit-log entries the
            # conflict check needs are still intact (we commit safely) — no
            # window where a stale txn commits against pruned history
            self._check_version(req.read_version)
            version = self.engine.commit_external(
                req.read_version,
                list(req.read_keys),
                [(r.begin, r.end) for r in req.read_ranges],
                writes,
                clears,
                stamps,
            )
            if writes or clears or stamps:
                # WAL carries the fully-resolved write set (stamped keys
                # included), appended in commit-version order under the lock
                if stamps:
                    import struct as _struct

                    for order, (prefix, suffix, value) in enumerate(stamps):
                        stamp = _struct.pack(">QH", version, order)
                        writes[prefix + stamp + suffix] = value
                self._wal_append(version, writes, clears)
                self._maybe_compact()
        return CommitRsp(version=version)

    def release(self, req: ReleaseReq) -> EmptyMsg:
        # pins are keyed by token server-side; version-based release is a
        # best-effort early unpin of the oldest matching pin
        with self._lock:
            for t, (ver, _) in list(self._pins.items()):
                if ver == req.version:
                    del self._pins[t]
                    self.engine.unpin_version(("kvd", t))
                    break
        return EmptyMsg()

    def set_snapshot_ttl(self, ttl_s: float) -> None:
        self._ttl = float(ttl_s)

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()
            self._wal = None


def bind_kv_service(server: RpcServer, svc: KvService) -> ServiceDef:
    s = ServiceDef(KV_SERVICE_ID, "Kv")
    s.method(1, "snapshot", SnapshotReq, SnapshotRsp, svc.snapshot)
    s.method(2, "get", GetReq, GetRsp, svc.get)
    s.method(3, "getRange", RangeReq, RangeRsp, svc.get_range)
    s.method(4, "commit", CommitReq, CommitRsp, svc.commit)
    s.method(5, "release", ReleaseReq, EmptyMsg, svc.release)
    server.add_service(s)
    return s
