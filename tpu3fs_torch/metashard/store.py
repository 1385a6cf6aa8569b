"""ShardedMetaStore: the partitioned metadata plane's server-side store
(docs/metashard.md).

The port's own copy of ``tpu3fs/metashard/store.py``, unchanged but for its
imports.

A MetaStore whose ops carry a PARTITION identity:

- every by-path op computes its partition (``partition_of_path``) and
  every by-inode op decodes its partition from the inode id
  (``partition_of_inode``), then FENCES against the owner view — a meta
  server that does not own the op's partition answers
  META_WRONG_PARTITION (retryable; the client refreshes routing and
  re-routes) instead of racing the real owner;
- new inodes are allocated FROM the op's partition: the partitioned
  allocator bakes ``partition_tag(pid)`` into the id's high bits, so a
  create and every later by-inode op on that file (close/sync/truncate)
  land on the SAME partition;
- cross-partition rename/hardlink route through the two-phase
  coordinator (twophase.py) instead of the base single-txn paths;
- per-partition op counts accumulate for the mgmtd heartbeat (the
  ``load`` column of ``admin_cli meta-partitions``).

Correctness never depends on the fence: all partitions share ONE
transactional KV, so the base MetaStore paths stay sound even mis-routed
— ownership buys serialization locality and load spread, exactly the
reference's stateless-meta-over-FDB premise (PAPER.md §0). A
ShardedMetaStore with no ``owner_view`` owns everything (single-process
deployments, tests, the recovery resolver).
"""

from __future__ import annotations

import contextlib
import contextvars
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Set

from tpu3fs_torch.metashard import metrics

from tpu3fs_torch.kv.kv import IKVEngine, ITransaction, with_transaction
from tpu3fs_torch.meta.store import InodeIdAllocator, MetaStore
from tpu3fs_torch.metashard.partition import (
    DEFAULT_PARTITIONS,
    partition_of_dir,
    partition_of_inode,
    partition_of_path,
    partition_tag,
)
from tpu3fs_torch.metashard.twophase import (
    TwoPhaseCoordinator,
    resolve_intents,
)
from tpu3fs_torch.utils.result import Code
from tpu3fs_torch.utils.result import err as _err

#: the partition the CURRENT op allocates inode ids from — a contextvar
#: because allocation happens deep inside base-class txn bodies
#: (_create_in_txn / mkdirs) that this module wraps, not rewrites
_ALLOC_PID: contextvars.ContextVar = contextvars.ContextVar(
    "tpu3fs_alloc_pid", default=None)

_PART_COUNTER_PREFIX = b"INOC"  # per-partition inode id counters


class PartitionedInodeAllocator:
    """Block allocator handing out partition-tagged inode ids. The op's
    partition arrives via ``_ALLOC_PID`` (set by ShardedMetaStore's op
    wrappers); with none set it falls back to the legacy untagged
    allocator so the base MetaStore keeps working standalone."""

    def __init__(self, engine: IKVEngine, block: int = 64):
        self._engine = engine
        self._block = block
        self._legacy = InodeIdAllocator(engine, block)
        self._lock = threading.Lock()
        self._next: Dict[int, int] = {}
        self._limit: Dict[int, int] = {}

    def allocate(self) -> int:
        pid = _ALLOC_PID.get()
        if pid is None:
            return self._legacy.allocate()
        with self._lock:
            if self._next.get(pid, 0) >= self._limit.get(pid, 0):
                key = _PART_COUNTER_PREFIX + struct.pack(">H", pid)

                def grab(txn: ITransaction) -> int:
                    raw = txn.get(key)
                    cur = int(raw) if raw else 1
                    txn.set(key, str(cur + self._block).encode())
                    return cur

                self._next[pid] = with_transaction(self._engine, grab)
                self._limit[pid] = self._next[pid] + self._block
            out = self._next[pid]
            self._next[pid] += 1
            return partition_tag(pid) | out


class ShardedMetaStore(MetaStore):
    """MetaStore facade with partition fencing, partition-tagged inode
    allocation and two-phase cross-partition rename/hardlink.

    ``owner_view``: callable returning the set of partition ids THIS
    process currently owns (meta_main refreshes it from RoutingInfo), or
    None to own everything. ``peer_prepare(pid, intent, path)`` /
    ``peer_finish(pid, txn_id)`` route two-phase participant work through
    the owning peer (MetaRpcClient in real clusters); absent, phases run
    locally against the shared KV.
    """

    def __init__(self, engine: IKVEngine, chain_allocator=None, *,
                 nparts: int = DEFAULT_PARTITIONS,
                 owner_view: Optional[Callable[[], Optional[Set[int]]]] = None,
                 peer_prepare: Optional[Callable] = None,
                 peer_finish: Optional[Callable] = None,
                 intent_ttl_s: float = 5.0,
                 **kw):
        super().__init__(engine, chain_allocator, **kw)
        self.nparts = max(1, nparts)
        self._owner_view = owner_view
        self._ids = PartitionedInodeAllocator(engine)
        self._twophase = TwoPhaseCoordinator(
            self, peer_prepare=peer_prepare, peer_finish=peer_finish,
            ttl_s=intent_ttl_s)
        self._load_lock = threading.Lock()
        self._op_counts: Dict[int, int] = {}

    # -- partition identity --------------------------------------------------
    def pid_of_path(self, path: str) -> int:
        return partition_of_path(path, self.nparts)

    def pid_of_dir(self, dir_path: str) -> int:
        return partition_of_dir(dir_path, self.nparts)

    def pid_of_inode(self, inode_id: int) -> int:
        return partition_of_inode(inode_id, self.nparts)

    def owned_partitions(self) -> Optional[Set[int]]:
        return self._owner_view() if self._owner_view is not None else None

    @contextlib.contextmanager
    def _op(self, pid: int):
        """Fence + account + time + bind the allocation partition for one
        op — the single site feeding ``meta.partition_op_us``."""
        owned = self.owned_partitions()
        if owned is not None and pid not in owned:
            metrics.wrong_partition.add()
            raise _err(Code.META_WRONG_PARTITION,
                       f"partition {pid} not owned (owned: {sorted(owned)})")
        with self._load_lock:
            self._op_counts[pid] = self._op_counts.get(pid, 0) + 1
        token = _ALLOC_PID.set(pid)
        t0 = time.perf_counter()
        try:
            yield pid
        finally:
            _ALLOC_PID.reset(token)
            metrics.partition_op_us(pid).record(
                (time.perf_counter() - t0) * 1e6)

    def snapshot_loads(self) -> Dict[int, int]:
        """Ops per partition since the last snapshot (drained — the meta
        heartbeat turns consecutive snapshots into ops/s for mgmtd)."""
        with self._load_lock:
            out, self._op_counts = self._op_counts, {}
            return out

    # -- by-path ops: fence on the parent-directory hash ---------------------
    def stat(self, path, user=None, **kw):
        args = (user,) if user is not None else ()
        with self._op(self.pid_of_path(path)):
            return super().stat(path, *args, **kw)

    def create(self, path, *a, **kw):
        with self._op(self.pid_of_path(path)):
            return super().create(path, *a, **kw)

    def open(self, path, *a, **kw):
        with self._op(self.pid_of_path(path)):
            return super().open(path, *a, **kw)

    def mkdirs(self, path, *a, **kw):
        with self._op(self.pid_of_path(path)):
            return super().mkdirs(path, *a, **kw)

    def symlink(self, path, *a, **kw):
        with self._op(self.pid_of_path(path)):
            return super().symlink(path, *a, **kw)

    def remove(self, path, *a, **kw):
        with self._op(self.pid_of_path(path)):
            return super().remove(path, *a, **kw)

    def set_attr(self, path, *a, **kw):
        with self._op(self.pid_of_path(path)):
            return super().set_attr(path, *a, **kw)

    def list_dir(self, path, *a, **kw):
        with self._op(self.pid_of_dir(path)):
            return super().list_dir(path, *a, **kw)

    # -- by-inode ops: fence on the id's baked partition ---------------------
    def close(self, inode_id, *a, **kw):
        with self._op(self.pid_of_inode(inode_id)):
            return super().close(inode_id, *a, **kw)

    def sync(self, inode_id, *a, **kw):
        with self._op(self.pid_of_inode(inode_id)):
            return super().sync(inode_id, *a, **kw)

    def truncate(self, path, *a, **kw):
        with self._op(self.pid_of_path(path)):
            return super().truncate(path, *a, **kw)

    # -- batched ops: group per partition, merge per-item results in order ---
    def _grouped(self, keys: List[int]):
        """index groups by partition id, preserving item order."""
        groups: Dict[int, List[int]] = {}
        for i, pid in enumerate(keys):
            groups.setdefault(pid, []).append(i)
        return groups

    def batch_create(self, items, *a, **kw):
        pids = [self.pid_of_path(it.path) for it in items]
        results: List[object] = [None] * len(items)
        for pid, idxs in self._grouped(pids).items():
            with self._op(pid):
                sub = super().batch_create([items[i] for i in idxs], *a, **kw)
            for i, res in zip(idxs, sub):
                results[i] = res
        return results

    def batch_mkdirs(self, paths, *a, **kw):
        pids = [self.pid_of_path(p) for p in paths]
        results: List[object] = [None] * len(paths)
        for pid, idxs in self._grouped(pids).items():
            with self._op(pid):
                sub = super().batch_mkdirs([paths[i] for i in idxs], *a, **kw)
            for i, res in zip(idxs, sub):
                results[i] = res
        return results

    def batch_stat(self, inode_ids, *a, **kw):
        pids = [self.pid_of_inode(i) for i in inode_ids]
        results: List[object] = [None] * len(inode_ids)
        for pid, idxs in self._grouped(pids).items():
            with self._op(pid):
                sub = super().batch_stat([inode_ids[i] for i in idxs],
                                         *a, **kw)
            for i, res in zip(idxs, sub):
                results[i] = res
        return results

    def batch_stat_by_path(self, paths, *a, **kw):
        pids = [self.pid_of_path(p) for p in paths]
        results: List[object] = [None] * len(paths)
        for pid, idxs in self._grouped(pids).items():
            with self._op(pid):
                sub = super().batch_stat_by_path([paths[i] for i in idxs],
                                                 *a, **kw)
            for i, res in zip(idxs, sub):
                results[i] = res
        return results

    def batch_set_attr(self, paths=None, *a, **kw):
        inode_ids = kw.pop("inode_ids", None)
        if paths is not None:
            keys, by_path = list(paths), True
            pids = [self.pid_of_path(p) for p in keys]
        else:
            keys, by_path = list(inode_ids or []), False
            pids = [self.pid_of_inode(i) for i in keys]
        results: List[object] = [None] * len(keys)
        for pid, idxs in self._grouped(pids).items():
            sub_keys = [keys[i] for i in idxs]
            with self._op(pid):
                if by_path:
                    sub = super().batch_set_attr(sub_keys, *a, **kw)
                else:
                    sub = super().batch_set_attr(None, *a,
                                                 inode_ids=sub_keys, **kw)
            for i, res in zip(idxs, sub):
                results[i] = res
        return results

    def batch_close(self, items, *a, **kw):
        pids = [self.pid_of_inode(it.inode_id) for it in items]
        results: List[object] = [None] * len(items)
        for pid, idxs in self._grouped(pids).items():
            with self._op(pid):
                sub = super().batch_close([items[i] for i in idxs], *a, **kw)
            for i, res in zip(idxs, sub):
                results[i] = res
        return results

    # -- cross-partition ops: two-phase --------------------------------------
    def rename(self, src, dst, *a, **kw):
        src_pid = self.pid_of_path(src)
        dst_pid = self.pid_of_path(dst)
        if src_pid == dst_pid:
            with self._op(src_pid):
                return super().rename(src, dst, *a, **kw)
        user = a[0] if a else kw.get("user", None)
        if user is None:
            from tpu3fs_torch.meta.store import ROOT_USER
            user = ROOT_USER
        # the src owner coordinates (it serializes the dirent that must
        # die exactly once); the dst side is the prepared participant
        with self._op(src_pid):
            return self._twophase.rename(src, dst, user, src_pid, dst_pid)

    def hard_link(self, src, dst, *a, **kw):
        user = a[0] if a else kw.get("user", None)
        if user is None:
            from tpu3fs_torch.meta.store import ROOT_USER
            user = ROOT_USER
        dst_pid = self.pid_of_path(dst)
        # the participant partition is the INODE's (nlink lives there),
        # resolved after the walk — but the coordinator fence is by dst
        # path, where the new dirent lands and the client routes to
        with self._op(dst_pid):
            src_inode = super().stat(src, user, follow=False)
            src_pid = self.pid_of_inode(src_inode.id)
            if src_pid == dst_pid:
                return super().hard_link(src, dst, user)
            return self._twophase.hard_link(src, dst, user,
                                            src_pid, dst_pid)

    # -- two-phase participant + recovery surface ----------------------------
    def twophase_prepare(self, intent, dst_path: str, user) -> None:
        """The renamePrepare RPC handler body: phase B on this (the
        participant) partition's owner."""
        pid = (intent.dst_pid if intent.kind == "rename" else intent.src_pid)
        with self._op(pid):
            if intent.kind == "rename":
                self._twophase.prepare_rename(intent, dst_path, user)
            else:
                self._twophase.prepare_hardlink(intent)

    def twophase_finish(self, txn_id: str) -> None:
        self._twophase._finish(txn_id)

    def resolve_intents(self, **kw) -> int:
        """Converge dangling two-phase records (twophase.resolve_intents);
        meta_main's resolver loop calls this with its owned pids."""
        return resolve_intents(self, **kw)
