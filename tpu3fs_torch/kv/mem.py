"""In-memory MVCC KV engine emulating FoundationDB transaction semantics.

The port's own copy of ``tpu3fs/kv/mem.py``,
unchanged but for its imports.

Mirrors the reference's mem KV (src/common/kv/mem/{MemKV,MemKVEngine,
MemTransaction}.h): snapshot reads at the transaction's read version,
read-your-writes, half-open range scans, clear ranges, versionstamped keys,
and optimistic read/write conflict detection at commit — the full contract the
meta service depends on, so the meta suite runs unchanged against mem or a
real FDB-like engine.
"""

from __future__ import annotations

import bisect
import struct
import threading
from typing import Dict, List, Optional, Tuple

from tpu3fs_torch.kv.kv import IKVEngine, ITransaction, KVPair
from tpu3fs_torch.utils.result import Code, FsError, Status


class MemKVEngine(IKVEngine):
    def __init__(self):
        self._lock = threading.RLock()
        self._version = 0
        # MVCC store: key -> [(version, value-or-None)], append-ordered
        self._data: Dict[bytes, List[Tuple[int, Optional[bytes]]]] = {}
        self._sorted_keys: List[bytes] = []
        # commit log for conflict detection: (version, point_keys, ranges)
        self._commits: List[Tuple[int, List[bytes], List[Tuple[bytes, bytes]]]] = []
        # read versions of live transactions: lower-bounds pruning
        self._active: Dict[int, int] = {}
        self._commits_since_prune = 0

    # -- engine API --------------------------------------------------------
    def transaction(self) -> "MemTransaction":
        with self._lock:
            txn = MemTransaction(self, self._version)
            self._active[id(txn)] = self._version
            return txn

    def _finish_txn(self, txn: "MemTransaction") -> None:
        with self._lock:
            self._active.pop(id(txn), None)

    def _maybe_prune(self) -> None:
        """Drop commit-log entries and MVCC history no live transaction can
        see — long-running services (mgmtd lease/heartbeat loops) would
        otherwise grow without bound. Caller holds the lock."""
        self._commits_since_prune += 1
        if self._commits_since_prune < 256:
            return
        self._commits_since_prune = 0
        floor = min(self._active.values(), default=self._version)
        # conflict checks only scan commits with ver > a live read_version
        self._commits = [c for c in self._commits if c[0] > floor]
        dead_keys = []
        for key, history in self._data.items():
            # keep the newest entry at-or-below the floor + all newer entries
            cut = 0
            for i, (ver, _val) in enumerate(history):
                if ver <= floor:
                    cut = i
            if cut:
                del history[:cut]
            if len(history) == 1 and history[0][1] is None and history[0][0] <= floor:
                dead_keys.append(key)  # fully-pruned tombstone
        for key in dead_keys:
            del self._data[key]
            idx = bisect.bisect_left(self._sorted_keys, key)
            if idx < len(self._sorted_keys) and self._sorted_keys[idx] == key:
                del self._sorted_keys[idx]

    @property
    def version(self) -> int:
        return self._version

    def dump_at(self, version: int) -> List[Tuple[bytes, bytes]]:
        """All live (key, value) pairs at a snapshot version — feeds the
        network KV service's WAL compaction (replay = snapshot + tail)."""
        with self._lock:
            out = []
            for key in list(self._sorted_keys):
                val = self._resolve(key, version)
                if val is not None:
                    out.append((key, val))
            return out

    def restore_version_floor(self, version: int) -> None:
        """Fast-forward the version counter (never backwards): a restarted
        service replaying a compacted WAL must not reissue version numbers
        (versionstamped keys depend on monotonicity across restarts)."""
        with self._lock:
            self._version = max(self._version, version)

    # -- external transaction surface (shared by MemTransaction and the
    # network KV service: one conflict-check + atomic-apply path) ----------
    def pin_version(self, token, version: int) -> None:
        """Hold MVCC history >= version alive (remote snapshot in use)."""
        with self._lock:
            self._active[token] = version

    def unpin_version(self, token) -> None:
        with self._lock:
            self._active.pop(token, None)

    def read_at(self, key: bytes, version: int) -> Optional[bytes]:
        """Point read at an MVCC snapshot version."""
        with self._lock:
            return self._resolve(key, version)

    def range_at(
        self, begin: bytes, end: bytes, version: int
    ) -> List[Tuple[bytes, bytes]]:
        """[begin, end) live pairs at a snapshot version (unlimited)."""
        with self._lock:
            out = []
            for key in self._range_keys(begin, end):
                val = self._resolve(key, version)
                if val is not None:
                    out.append((key, val))
            return out

    def commit_external(
        self,
        read_version: int,
        read_keys: List[bytes],
        read_ranges: List[Tuple[bytes, bytes]],
        writes: Dict[bytes, Optional[bytes]],
        clear_ranges: List[Tuple[bytes, bytes]],
        versionstamped: List[Tuple[bytes, bytes, bytes]],
    ) -> int:
        """Validate the read set against commits after read_version and, if
        clean, apply the write set atomically. Returns the commit version;
        raises FsError(KV_CONFLICT) otherwise."""
        with self._lock:
            if self._check_conflicts(read_version, read_keys, read_ranges):
                raise FsError(Status(Code.KV_CONFLICT, "read-write conflict"))
            if not writes and not clear_ranges and not versionstamped:
                return self._version
            self._version += 1
            version = self._version
            all_writes = dict(writes)
            for order, (prefix, suffix, value) in enumerate(versionstamped):
                stamp = struct.pack(">QH", version, order)
                all_writes[prefix + stamp + suffix] = value
            self._apply(version, all_writes, clear_ranges)
            self._commits.append(
                (version, list(all_writes.keys()), list(clear_ranges))
            )
            self._maybe_prune()
            return version

    # -- internals used by MemTransaction ----------------------------------
    def _resolve(self, key: bytes, version: int) -> Optional[bytes]:
        history = self._data.get(key)
        if not history:
            return None
        for ver, val in reversed(history):
            if ver <= version:
                return val
        return None

    def _range_keys(self, begin: bytes, end: bytes) -> List[bytes]:
        lo = bisect.bisect_left(self._sorted_keys, begin)
        hi = bisect.bisect_left(self._sorted_keys, end)
        return self._sorted_keys[lo:hi]

    def _apply(self, version: int, writes: Dict[bytes, Optional[bytes]],
               clear_ranges: List[Tuple[bytes, bytes]]) -> None:
        for begin, end in clear_ranges:
            for key in self._range_keys(begin, end):
                self._data.setdefault(key, []).append((version, None))
        for key, value in writes.items():
            history = self._data.get(key)
            if history is None:
                self._data[key] = [(version, value)]
                bisect.insort(self._sorted_keys, key)
            else:
                history.append((version, value))
        # keys cleared by ranges might be new tombstones for unseen keys: not
        # needed — clearing nonexistent keys is a no-op.

    def _check_conflicts(
        self,
        read_version: int,
        read_keys: List[bytes],
        read_ranges: List[Tuple[bytes, bytes]],
    ) -> bool:
        point_set = set(read_keys)
        for ver, keys, ranges in reversed(self._commits):
            if ver <= read_version:
                break
            for k in keys:
                if k in point_set:
                    return True
                for begin, end in read_ranges:
                    if begin <= k < end:
                        return True
            for begin, end in ranges:
                for rk in read_keys:
                    if begin <= rk < end:
                        return True
                for rb, re_ in read_ranges:
                    if rb < end and begin < re_:
                        return True
        return False


class MemTransaction(ITransaction):
    def __init__(self, engine: MemKVEngine, read_version: int):
        self._engine = engine
        self._read_version = read_version
        self._writes: Dict[bytes, Optional[bytes]] = {}
        self._clear_ranges: List[Tuple[bytes, bytes]] = []
        self._read_keys: List[bytes] = []
        self._read_ranges: List[Tuple[bytes, bytes]] = []
        self._versionstamped: List[Tuple[bytes, bytes, bytes]] = []
        self._committed_version: Optional[int] = None
        self._done = False

    # -- reads -------------------------------------------------------------
    def _local_lookup(self, key: bytes):
        """-> (found_locally, value) honoring writes and clear ranges."""
        if key in self._writes:
            return True, self._writes[key]
        for begin, end in self._clear_ranges:
            if begin <= key < end:
                return True, None
        return False, None

    def get(self, key: bytes) -> Optional[bytes]:
        found, val = self._local_lookup(key)
        if found:
            return val
        self._read_keys.append(key)
        with self._engine._lock:
            return self._engine._resolve(key, self._read_version)

    def snapshot_get(self, key: bytes) -> Optional[bytes]:
        found, val = self._local_lookup(key)
        if found:
            return val
        with self._engine._lock:
            return self._engine._resolve(key, self._read_version)

    def get_range(
        self,
        begin: bytes,
        end: bytes,
        *,
        limit: int = 0,
        reverse: bool = False,
        snapshot: bool = False,
    ) -> List[KVPair]:
        if not snapshot:
            self._read_ranges.append((begin, end))
        with self._engine._lock:
            keys = self._engine._range_keys(begin, end)
            merged: Dict[bytes, Optional[bytes]] = {}
            for key in keys:
                merged[key] = self._engine._resolve(key, self._read_version)
        # overlay local effects
        for rb, re_ in self._clear_ranges:
            for key in list(merged):
                if rb <= key < re_:
                    merged[key] = None
        for key, val in self._writes.items():
            if begin <= key < end:
                merged[key] = val
        items = sorted(
            (k for k, v in merged.items() if v is not None), reverse=reverse
        )
        if limit:
            items = items[:limit]
        return [KVPair(k, merged[k]) for k in items]

    def add_read_conflict(self, key: bytes) -> None:
        self._read_keys.append(key)

    # -- writes ------------------------------------------------------------
    def set(self, key: bytes, value: bytes) -> None:
        assert not self._done
        self._writes[key] = bytes(value)

    def set_versionstamped_key(self, prefix: bytes, suffix: bytes, value: bytes) -> None:
        assert not self._done
        self._versionstamped.append((bytes(prefix), bytes(suffix), bytes(value)))

    def clear(self, key: bytes) -> None:
        assert not self._done
        self._writes[key] = None

    def clear_range(self, begin: bytes, end: bytes) -> None:
        assert not self._done
        # drop overlapping buffered writes, then record the range
        for key in [k for k in self._writes if begin <= k < end]:
            del self._writes[key]
        self._clear_ranges.append((begin, end))

    # -- commit ------------------------------------------------------------
    def commit(self) -> None:
        assert not self._done
        self._done = True
        eng = self._engine
        with eng._lock:
            eng._active.pop(id(self), None)
            self._committed_version = eng.commit_external(
                self._read_version,
                self._read_keys,
                self._read_ranges,
                self._writes,
                self._clear_ranges,
                self._versionstamped,
            )

    def cancel(self) -> None:
        self._done = True
        self._engine._finish_txn(self)

    @property
    def committed_version(self) -> Optional[int]:
        return self._committed_version
