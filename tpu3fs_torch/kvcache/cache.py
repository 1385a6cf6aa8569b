"""KVCache fs tier for LLM inference over the cluster (ref README.md:17,
45-51).

The reference positions 3FS as a DRAM-alternative KV cache: decoder-layer
key/value tensors of previous tokens are cached in files, read back at up to
40 GiB/s, and reclaimed by a GC whose remove-op IOPS the README charts. The
reference implements this as a usage pattern over the normal file API — so
does this build. This module is the durable tier of the serving stack
(docs/kvcache.md): ``tier.TieredKVCache`` puts a host-RAM hot tier in front
of it and ``blocks.PrefixBlockStore`` a content-addressed prefix-hash
keyspace on top.

- entries live under a cache root, sharded two hex levels deep (256×256
  dirs) so directory listings stay short at billions of entries;
- put() writes value bytes through the striped chunk path and closes with
  the write session so lengths settle;
- get()/batch_get() are chunk-batched reads (batch_read groups chunk IOs by
  node exactly like the training data loaders do);
- touch-on-get refreshes an entry's mtime so the GC is an LRU — BATCHED
  (MetaStore.batch_set_attr): a 64-key batch_get refreshes all its hits in
  one metadata transaction, not 64 round trips;
- all IO is tagged ``TrafficClass.KVCACHE`` (foreground-weighted,
  share-bounded — qos/core.py);
- KVCacheGC reclaims in two modes: TTL round-robin shard scans, and a
  capacity-target pass evicting oldest-touched entries until the tier fits
  a bytes budget. Both respect pin leases (leases.py) — the remove-op
  counter mirrors the README's GC IOPS chart.

Arrays and tensors ride along via put_array/get_array
(layout.encode_array: dtype+shape header, zero parsing beyond a 16-byte
prefix) so inference servers can copy the result straight to the card.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

from tpu3fs_torch.client.file_io import FileIoClient
from tpu3fs_torch.kvcache.layout import (
    decode_array,
    encode_array,
    lease_active,
    shard_path,
)
from tpu3fs_torch.meta.store import MetaStore, OpenFlags
from tpu3fs_torch.monitor.recorder import CounterRecorder, LatencyRecorder
from tpu3fs_torch.qos.core import TrafficClass, tagged
from tpu3fs_torch.utils.result import Code, FsError


def _shard_path(root: str, key: str) -> str:
    # back-compat alias (tests and older callers import it from here)
    return shard_path(root, key)


class KVCacheClient:
    """Typed cache surface over (MetaStore, FileIoClient)."""

    def __init__(
        self,
        meta: MetaStore,
        fio: FileIoClient,
        *,
        root: str = "/kvcache",
        client_id: str = "kvcache",
        touch_on_get: bool = True,
        inode_cache: int = 0,
        touch_coalesce_s: float = 0.0,
        tenant: str = "",
    ):
        """inode_cache > 0 enables a bounded client-side inode cache of
        that many entries: repeat gets skip the stat walk and touch by
        inode id (walk-free batch_set_attr), so a hot serving set pays
        only its storage reads. ONLY sound for immutable, staleness-
        detectable namespaces — content-addressed block entries, whose
        array-header magic turns a GC'd entry's zero-hole read into
        KVCACHE_STALE (blocks.py invalidates and re-stats). Leave 0 for
        mutable byte-API use: a cached inode cannot see another client's
        overwrite lengths.

        touch_coalesce_s > 0 takes the LRU touch off the read critical
        path: touched ids accumulate client-side and drain as ONE
        batch_set_attr at most once per interval (flush_touches() forces
        it). The GC's mtime axis lags by at most the interval — pair it
        with a GC ttl comfortably above it (any sane TTL is)."""
        self._meta = meta
        self._fio = fio
        self.root = root.rstrip("/") or "/kvcache"
        self._client_id = client_id
        # owning tenant (tpu3fs_torch/tenant): every op runs under this scope
        # (so the wire carries it and quotas charge it) — set explicitly
        # because the write-back flusher calls batch_put from a
        # background thread that inherits NO producer context
        self._tenant = tenant or ""
        self._touch_on_get = touch_on_get
        self._dir_lock = threading.Lock()
        self._dirs_made: set = set()
        self._ino_lock = threading.Lock()
        self._ino_cap = int(inode_cache)
        self._inodes: "OrderedDict[str, object]" = OrderedDict()
        self._touch_coalesce_s = float(touch_coalesce_s)
        self._touch_lock = threading.Lock()
        self._pending_ids: set = set()
        self._pending_paths: set = set()
        self._last_touch_flush = time.monotonic()
        self._hits = CounterRecorder("kvcache.hits")
        self._misses = CounterRecorder("kvcache.misses")
        self._read_bytes = CounterRecorder("kvcache.read_bytes")
        self._write_bytes = CounterRecorder("kvcache.write_bytes")
        self._get_rec = LatencyRecorder("kvcache.get")
        self._put_rec = LatencyRecorder("kvcache.put")

    # -- plumbing -----------------------------------------------------------
    def _tenant_ctx(self):
        from tpu3fs_torch.tenant.identity import tenant_scope

        return tenant_scope(self._tenant)

    def _charge_resident(self, nbytes: int) -> None:
        """Per-tenant kvcache resident-bytes estimate (tpu3fs_torch/tenant):
        incremental from the writer; the GC daemon's scans set the
        authoritative figure (bin/kvcache_gc_main.py)."""
        from tpu3fs_torch.tenant.identity import current_tenant
        from tpu3fs_torch.tenant.quota import registry

        tenant = self._tenant or current_tenant()
        if tenant:
            registry().charge_kvcache(tenant, nbytes)

    def _check_resident_budget(self) -> None:
        """Writer-side kvcache budget gate: a tenant whose resident bytes
        exceed its quota sheds TENANT_THROTTLED before creating more
        entries — eviction (GC capacity pass) is what brings it back
        under (docs/tenancy.md)."""
        from tpu3fs_torch.tenant.identity import current_tenant
        from tpu3fs_torch.tenant.quota import registry
        from tpu3fs_torch.utils.result import Status

        tenant = self._tenant or current_tenant()
        if tenant and registry().kvcache_over(tenant):
            registry().shed_kvcache(tenant)
            raise FsError(Status(
                Code.TENANT_THROTTLED,
                f"retry_after_ms=1000 (tenant {tenant} over its kvcache "
                f"resident budget)"))

    def _ensure_dir(self, path: str) -> None:
        parent = path.rsplit("/", 1)[0]
        with self._dir_lock:
            if parent in self._dirs_made:
                return
        try:
            self._meta.mkdirs(parent, recursive=True)
        except FsError as e:
            if e.code != Code.META_EXISTS:
                raise
        with self._dir_lock:
            self._dirs_made.add(parent)

    def _ensure_dirs(self, paths: Sequence[str]) -> None:
        """Directory fan-in for the drain: ONE batch_mkdirs RPC (fanned
        per meta partition by the routed client) for every uncached
        parent, instead of one serial mkdirs round trip each — the other
        meta-bound half of the write-back flush number."""
        parents: List[str] = []
        with self._dir_lock:
            seen = set()
            for p in paths:
                parent = p.rsplit("/", 1)[0]
                if parent not in self._dirs_made and parent not in seen:
                    seen.add(parent)
                    parents.append(parent)
        if not parents:
            return
        batched = getattr(self._meta, "batch_mkdirs", None)
        if batched is None:
            for parent in parents:
                self._ensure_dir(parent + "/x")
            return
        for parent, res in zip(parents,
                               batched(parents, recursive=True,
                                       exist_ok=True)):
            if isinstance(res, FsError) and res.code != Code.META_EXISTS:
                raise res
        with self._dir_lock:
            self._dirs_made.update(parents)

    def _touch(self, paths: Sequence[str], now: float,
               inode_ids: Optional[Sequence[int]] = None) -> None:
        """LRU refresh, batched; losing a race to GC is harmless. With
        inode ids the touch is walk-free; with coalescing it leaves the
        read critical path entirely (one drain per interval). The one
        exception guard for every touch path (get/batch_get used to
        differ): FsError from concurrent removes, TypeError from meta
        doubles without time kwargs."""
        if self._touch_coalesce_s > 0:
            with self._touch_lock:
                if inode_ids is not None:
                    self._pending_ids.update(inode_ids)
                else:
                    self._pending_paths.update(paths)
                if (time.monotonic() - self._last_touch_flush
                        < self._touch_coalesce_s):
                    return
            self.flush_touches(now)
            return
        self._touch_now(paths, now, inode_ids)

    def flush_touches(self, now: Optional[float] = None) -> None:
        """Drain coalesced touches as one batched settle."""
        now = time.time() if now is None else now
        with self._touch_lock:
            ids, self._pending_ids = self._pending_ids, set()
            paths, self._pending_paths = self._pending_paths, set()
            self._last_touch_flush = time.monotonic()
        if ids:
            self._touch_now([], now, sorted(ids))
        if paths:
            self._touch_now(sorted(paths), now)

    def _touch_now(self, paths: Sequence[str], now: float,
                   inode_ids: Optional[Sequence[int]] = None) -> None:
        batched = getattr(self._meta, "batch_set_attr", None)
        if batched is not None and inode_ids is not None:
            try:
                batched(inode_ids=list(inode_ids), mtime=now)
                return
            except TypeError:  # meta without id addressing: use paths
                pass
            except FsError:
                return
        try:
            if batched is not None:
                batched(paths, mtime=now)
            else:  # minimal meta double: per-path fallback
                for p in paths:
                    self._meta.set_attr(p, mtime=now)
        except (FsError, TypeError):
            pass

    # -- inode cache (immutable namespaces only; see __init__) --------------
    def _cached_inode(self, key: str):
        if self._ino_cap <= 0:
            return None
        with self._ino_lock:
            ino = self._inodes.get(key)
            if ino is not None:
                self._inodes.move_to_end(key)
            return ino

    def _cache_inode(self, key: str, inode) -> None:
        if self._ino_cap <= 0:
            return
        with self._ino_lock:
            self._inodes[key] = inode
            self._inodes.move_to_end(key)
            while len(self._inodes) > self._ino_cap:
                self._inodes.popitem(last=False)

    def invalidate(self, key: Optional[str] = None) -> None:
        """Drop cached inode state (one key, or all with None) — blocks.py
        calls this on a KVCACHE_STALE decode before re-statting."""
        with self._ino_lock:
            if key is None:
                self._inodes.clear()
            else:
                self._inodes.pop(key, None)

    # -- byte API -----------------------------------------------------------
    def put(self, key: str, value: bytes) -> None:
        with self._put_rec.record(), tagged(TrafficClass.KVCACHE), \
                self._tenant_ctx():
            self._check_resident_budget()
            path = shard_path(self.root, key)
            self._ensure_dir(path)
            res = self._meta.create(
                path, flags=OpenFlags.WRITE | OpenFlags.CREATE
                | OpenFlags.TRUNC,
                client_id=self._client_id,
            )
            try:
                n = self._fio.write(res.inode, 0, value)
            except BaseException:
                # failed write must not leak the open write session
                try:
                    self._meta.close(res.inode.id, res.session_id)
                except FsError:
                    pass
                raise
            settled = self._meta.close(res.inode.id, res.session_id,
                                       length_hint=n, wrote=True)
            self._cache_inode(key, settled)
            self._write_bytes.add(n)
            self._charge_resident(n)

    def batch_put(self, items) -> None:
        """Write many (key, value) entries as ONE node-grouped striped
        batch (FileIoClient.batch_write_files) and settle the sessions in
        one batch_close — the write-back flusher's drain path, mirroring
        batch_get's shape. Creates fan IN too: one batch_create RPC for
        the whole drain (O(len/64) server transactions) instead of N
        serial create round trips — the meta-bound half of the write-back
        flush number. Raises on the first failed entry."""
        from tpu3fs_torch.meta.store import BatchCloseItem, BatchCreateItem

        items = list(items)
        if not items:
            return
        with self._put_rec.record(), tagged(TrafficClass.KVCACHE), \
                self._tenant_ctx():
            self._check_resident_budget()
            opened: List[Tuple[str, object]] = []
            try:
                paths = [shard_path(self.root, key) for key, _ in items]
                self._ensure_dirs(paths)
                batch_create = getattr(self._meta, "batch_create", None)
                if batch_create is not None:
                    flags = (OpenFlags.WRITE | OpenFlags.CREATE
                             | OpenFlags.TRUNC)
                    created = batch_create([
                        BatchCreateItem(path=p, flags=flags,
                                        client_id=self._client_id)
                        for p in paths])
                    for (key, _), res in zip(items, created):
                        if isinstance(res, FsError):
                            raise res
                        opened.append((key, res))
                else:
                    for (key, _), path in zip(items, paths):
                        opened.append((key, self._meta.create(
                            path, flags=OpenFlags.WRITE | OpenFlags.CREATE
                            | OpenFlags.TRUNC,
                            client_id=self._client_id)))
                counts = self._fio.batch_write_files(
                    [(res.inode, 0, value)
                     for (_, res), (_, value) in zip(opened, items)])
            except BaseException:
                for _, res in opened:
                    try:
                        self._meta.close(res.inode.id, res.session_id)
                    except FsError:
                        pass
                raise
            closes = [BatchCloseItem(
                inode_id=res.inode.id, session_id=res.session_id,
                length_hint=n, client_id=self._client_id, wrote=1)
                for (_, res), n in zip(opened, counts)]
            batch_close = getattr(self._meta, "batch_close", None)
            settled = (batch_close(closes) if batch_close is not None else
                       [self._meta.close(c.inode_id, c.session_id,
                                         length_hint=c.length_hint,
                                         wrote=True) for c in closes])
            for (key, _), res, n in zip(opened, settled, counts):
                if isinstance(res, FsError):
                    raise res
                self._cache_inode(key, res)
                self._write_bytes.add(n)
                self._charge_resident(n)

    def get(self, key: str) -> Optional[bytes]:
        with self._get_rec.record() as op, tagged(TrafficClass.KVCACHE), \
                self._tenant_ctx():
            path = shard_path(self.root, key)
            inode = self._cached_inode(key)
            if inode is None:
                try:
                    inode = self._meta.stat(path)
                except FsError:
                    self._misses.add()
                    op.fail()
                    return None
                self._cache_inode(key, inode)
            data = self._fio.read(inode, 0, inode.length)
            self._hits.add()
            self._read_bytes.add(len(data))
            if self._touch_on_get:
                self._touch([path], time.time(), inode_ids=[inode.id])
            return data

    def get_cached(self, key: str) -> Optional[bytes]:
        """Read ONLY via an already-cached inode — zero metadata round
        trips, None when the inode is not cached. The serving host's
        serve-through path (tpu3fs_torch/serving/service.py): a peer asking for
        a block this process recently wrote can be answered for one
        storage read with no meta traffic. The caller MUST staleness-check
        the payload (layout.zero_hole) — a GC'd entry reads back as an
        all-zero hole through a cached inode."""
        inode = self._cached_inode(key)
        if inode is None:
            return None
        with tagged(TrafficClass.KVCACHE), self._tenant_ctx():
            try:
                data = self._fio.read(inode, 0, inode.length)
            except FsError:
                self.invalidate(key)
                return None
            self._read_bytes.add(len(data))
            return data

    def batch_get(self, keys: Sequence[str]) -> List[Optional[bytes]]:
        """Stat all keys, then read every hit as ONE node-grouped chunk
        batch (StorageClient.batch_read underneath) and refresh every
        hit's mtime as ONE batched touch."""
        with tagged(TrafficClass.KVCACHE), self._tenant_ctx():
            paths = [shard_path(self.root, k) for k in keys]
            inodes: List[object] = [self._cached_inode(k) for k in keys]
            unknown = [i for i, ino in enumerate(inodes) if ino is None]
            if unknown:
                fresh = self._meta.batch_stat_by_path(
                    [paths[i] for i in unknown])
                for i, ino in zip(unknown, fresh):
                    inodes[i] = ino
                    if ino is not None:
                        self._cache_inode(keys[i], ino)
            hits = [(i, ino) for i, ino in enumerate(inodes)
                    if ino is not None]
            self._misses.add(len(keys) - len(hits))
            out: List[Optional[bytes]] = [None] * len(keys)
            if not hits:
                return out
            blobs = self._fio.batch_read_files(
                [(ino, 0, ino.length) for _, ino in hits])
            for (i, ino), blob in zip(hits, blobs):
                out[i] = blob
                self._hits.add()
                self._read_bytes.add(len(blob))
            if self._touch_on_get:
                self._touch([paths[i] for i, _ in hits], time.time(),
                            inode_ids=[ino.id for _, ino in hits])
            return out

    def remove(self, key: str) -> bool:
        path = shard_path(self.root, key)
        self.invalidate(key)
        try:
            with tagged(TrafficClass.KVCACHE):
                self._meta.remove(path)
            return True
        except FsError:
            return False

    def contains(self, key: str) -> bool:
        try:
            self._meta.stat(shard_path(self.root, key))
            return True
        except FsError:
            return False

    def batch_contains(self, keys: Sequence[str]) -> List[bool]:
        """Presence of many keys via one batched stat — the prefix-match
        probe (blocks.match_prefix) where per-key stats would make prefix
        lookup O(chain length) round trips."""
        paths = [shard_path(self.root, k) for k in keys]
        with tagged(TrafficClass.KVCACHE):
            inodes = self._meta.batch_stat_by_path(paths)
        return [ino is not None for ino in inodes]

    # -- array API (decoder-layer KV tensors) -------------------------------
    def put_array(self, key: str, array) -> None:
        self.put(key, encode_array(array))

    def get_array(self, key: str):
        raw = self.get(key)
        if raw is None:
            return None
        return decode_array(raw)


class KVCacheGC:
    """Garbage collector (ref README.md:48 — GC remove-op IOPS), two modes:

    - ``run_once()``: TTL scan — shard directories round-robin, removing
      entries whose mtime is older than ttl_s. Each pass visits at most
      max_shards shards so it never monopolizes the metadata service.
    - ``capacity_pass()``: capacity-target LRU eviction — scan the tier,
      and while it exceeds ``capacity_bytes``, remove entries in
      oldest-touched order (touch-on-get makes mtime the LRU axis).

    Both modes skip entries under an active pin lease (leases.py): an
    inference session holding a lease on its prefix blocks can never lose
    them mid-decode, however old or over-budget the tier is. Removals go
    through the normal remove path (chunks reclaimed by meta GC scan).
    """

    def __init__(
        self,
        meta: MetaStore,
        *,
        root: str = "/kvcache",
        ttl_s: float = 3600.0,
        max_shards: int = 64,
        capacity_bytes: Optional[int] = None,
        client_id: str = "kvcache-gc",
    ):
        self._meta = meta
        self.root = root.rstrip("/") or "/kvcache"
        self.ttl_s = ttl_s
        self.max_shards = max_shards
        self.capacity_bytes = capacity_bytes
        self._client_id = client_id
        self._cursor: Tuple[int, int] = (0, 0)
        self._removes = CounterRecorder("kvcache.gc.removes")
        self._scans = CounterRecorder("kvcache.gc.scans")
        self._lease_skips = CounterRecorder("kvcache.gc.lease_skips")

    def _list(self, path: str) -> List[str]:
        try:
            return [e.name for e in self._meta.list_dir(path)]
        except FsError:
            return []

    def _try_remove(self, path: str) -> bool:
        try:
            self._meta.remove(path)
            self._removes.add()
            return True
        except FsError:
            return False  # concurrent remove/touch: next pass decides

    def run_once(self, now: Optional[float] = None) -> int:
        """Scan up to max_shards leaf dirs; returns entries removed.

        Sub-shard lists are fetched lazily per top dir as the cursor reaches
        it, so a pass costs 1 (root) + tops-touched + leafs-visited list_dir
        calls — never a full enumeration of the whole shard tree up front."""
        now = time.time() if now is None else now
        removed = 0
        tops = sorted(self._list(self.root))
        if not tops:
            return 0
        ti = self._cursor[0] % len(tops)
        si = self._cursor[1]
        visited = 0
        tops_touched = 0
        seen_leafs = set()  # each leaf scanned at most once per pass
        wrapped = False
        while (visited < self.max_shards and tops_touched <= len(tops)
               and not wrapped):
            top = tops[ti]
            subs = sorted(self._list(f"{self.root}/{top}"))
            while si < len(subs) and visited < self.max_shards:
                key = (top, subs[si])
                if key in seen_leafs:
                    wrapped = True  # full cycle: stop, cursor stays here
                    break
                seen_leafs.add(key)
                leaf = f"{self.root}/{top}/{subs[si]}"
                si += 1
                visited += 1
                self._scans.add()
                for name in self._list(leaf):
                    path = f"{leaf}/{name}"
                    try:
                        inode = self._meta.stat(path)
                    except FsError:
                        continue
                    if now - inode.mtime < self.ttl_s:
                        continue
                    if lease_active(inode, now):
                        self._lease_skips.add()
                        continue
                    if self._try_remove(path):
                        removed += 1
            if not wrapped and si >= len(subs):
                ti = (ti + 1) % len(tops)
                si = 0
                tops_touched += 1
        self._cursor = (ti, si)
        return removed

    def scan_entries(self, now: Optional[float] = None):
        """Full-tier enumeration -> [(mtime, length, leased, path)] —
        shared by capacity_pass and the admin CLI stats view."""
        now = time.time() if now is None else now
        out = []
        for top in self._list(self.root):
            for sub in self._list(f"{self.root}/{top}"):
                leaf = f"{self.root}/{top}/{sub}"
                for name in self._list(leaf):
                    path = f"{leaf}/{name}"
                    try:
                        inode = self._meta.stat(path)
                    except FsError:
                        continue
                    out.append((inode.mtime, inode.length,
                                lease_active(inode, now), path))
        return out

    def capacity_pass(self, now: Optional[float] = None,
                      capacity_bytes: Optional[int] = None) -> int:
        """Evict oldest-touched unleased entries until the tier's total
        bytes fit the budget; returns entries removed. A tier that cannot
        fit (everything leased) stops at the leased floor rather than
        violating a lease."""
        budget = self.capacity_bytes if capacity_bytes is None \
            else capacity_bytes
        if budget is None:
            return 0
        now = time.time() if now is None else now
        entries = self.scan_entries(now)
        total = sum(length for _, length, _, _ in entries)
        if total <= budget:
            return 0
        removed = 0
        for mtime, length, leased, path in sorted(entries):
            if total <= budget:
                break
            if leased:
                self._lease_skips.add()
                continue
            if self._try_remove(path):
                total -= length
                removed += 1
        return removed
