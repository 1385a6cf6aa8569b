"""Two-tier serving cache: bounded host-RAM hot tier over the fs tier.

The serving-path arithmetic: a decode step needs its prefix KV in device
memory in single-digit milliseconds; the fs tier answers in
storage-round-trip time. So reads go through a HOST-RAM LRU first —

- **hits are RAM-only**: no metadata stat, no storage RPC, nothing on the
  wire (the property tests/test_kvcache.py pins);
- **misses fill as ONE striped batch** (`KVCacheClient.batch_get` →
  `batch_read_files` → the PR 3 pipelined node-grouped fan-out), then
  land in the tier for the session's next step;
- **puts write back**: the value is visible to readers immediately (tier
  + dirty buffer) and a background flush thread pushes it through the fs
  tier. The dirty buffer is BOUNDED (``dirty_max_bytes``): a producer
  outrunning storage blocks at the bound instead of growing host memory
  without limit. Durability-sensitive callers pass
  ``write_through=True`` and get the synchronous fs put.

Consistency is client-local, like the readahead prefetcher: one process's
tier does not see another process's overwrites until the entry ages out
of the tier. Content-addressed block keys (blocks.py) sidestep this
entirely — a key's value never changes, so staleness cannot be observed.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Optional, Sequence

from tpu3fs_torch.kvcache.cache import KVCacheClient
from tpu3fs_torch.kvcache.layout import decode_array, encode_array
from tpu3fs_torch.monitor.recorder import CounterRecorder, ValueRecorder
from tpu3fs_torch.utils.result import Code, FsError, Status


class HostTier:
    """Thread-safe bounded-bytes LRU of value buffers.

    With a ``refcount_of`` callable installed (the serving fleet's
    shared-block refcounts, tpu3fs_torch/serving/fleet.py), eviction prefers
    UNSHARED entries: a viral shared prefix (many live decode chains
    reference its blocks) should outlive the unshared tail blocks of a
    single finished request, whatever pure recency says. The scan is
    bounded (``evict_scan``) so eviction stays O(1)-ish; when every
    scanned entry is shared, plain LRU applies — capacity wins over
    sharing, never the reverse."""

    def __init__(self, capacity_bytes: int, *, evict_scan: int = 8):
        self.capacity_bytes = int(capacity_bytes)
        self.evict_scan = max(1, int(evict_scan))
        #: optional key -> live-chain refcount (entries with count > 1
        #: are "shared"); installed by FleetKVCache
        self.refcount_of = None
        self._mu = threading.Lock()
        self._entries: "OrderedDict[str, bytes]" = OrderedDict()
        self._bytes = 0

    def get(self, key: str) -> Optional[bytes]:
        with self._mu:
            v = self._entries.get(key)
            if v is not None:
                self._entries.move_to_end(key)
            return v

    def contains(self, key: str) -> bool:
        with self._mu:
            return key in self._entries

    def put(self, key: str, value) -> int:
        """Insert (LRU-most); returns entries evicted to fit. A value
        larger than the whole tier is not cached at all (evicting
        everything for one entry would thrash the hot set)."""
        n = len(value)
        if n > self.capacity_bytes:
            return 0
        evicted = 0
        with self._mu:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            self._entries[key] = value
            self._bytes += n
            while self._bytes > self.capacity_bytes and self._entries:
                v = self._evict_one_locked()
                self._bytes -= len(v)
                evicted += 1
        return evicted

    def _evict_one_locked(self) -> bytes:
        """Pop one victim (value returned for byte accounting): the first
        UNSHARED entry within the scan window from the LRU end, else the
        plain LRU head."""
        rc = self.refcount_of
        if rc is not None:
            for i, key in enumerate(self._entries):
                if i >= self.evict_scan:
                    break
                try:
                    shared = rc(key) > 1
                except Exception:
                    shared = False
                if not shared:
                    return self._entries.pop(key)
        _, v = self._entries.popitem(last=False)
        return v

    def remove(self, key: str) -> bool:
        with self._mu:
            v = self._entries.pop(key, None)
            if v is None:
                return False
            self._bytes -= len(v)
            return True

    def clear(self) -> None:
        with self._mu:
            self._entries.clear()
            self._bytes = 0

    @property
    def bytes(self) -> int:
        with self._mu:
            return self._bytes

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)


class TieredKVCache:
    """Host-RAM hot tier + bounded write-back buffer over a
    ``KVCacheClient`` fs tier. Same get/put surface, so the prefix-block
    store (blocks.py) runs on either."""

    def __init__(self, cache: KVCacheClient, *,
                 capacity_bytes: int = 256 << 20,
                 dirty_max_bytes: int = 64 << 20,
                 write_through: bool = False,
                 flush_batch: int = 16,
                 flush_error_budget: int = 16):
        self._fs = cache
        self.tier = HostTier(capacity_bytes)
        self.write_through = write_through
        self.dirty_max_bytes = int(dirty_max_bytes)
        self._flush_batch = max(1, flush_batch)
        # error budget: after this many CONSECUTIVE failed flush cycles
        # the buffer is POISONED — put() raises KVCACHE_FLUSH_POISONED to
        # the producer instead of buffering (and eventually blocking)
        # silently forever against a dead storage tier. One successful
        # flush clears the poison (carried follow-up from PR 5).
        self.flush_error_budget = max(1, int(flush_error_budget))
        self._flush_fail_streak = 0
        self._mu = threading.Lock()
        self._cond = threading.Condition(self._mu)
        self._dirty: "OrderedDict[str, bytes]" = OrderedDict()
        self._dirty_bytes = 0
        self._stop = threading.Event()
        self._host_hits = CounterRecorder("kvcache.host_hits")
        self._host_misses = CounterRecorder("kvcache.host_misses")
        self._fill_bytes = CounterRecorder("kvcache.fill_bytes")
        self._evictions = CounterRecorder("kvcache.host_evictions")
        self._flush_bytes = CounterRecorder("kvcache.flush_bytes")
        self._flush_err = CounterRecorder("kvcache.flush_err")
        self._dirty_gauge = ValueRecorder("kvcache.dirty_bytes")
        # host-tier residency gauge (memory observability: admin_cli top
        # + the bounded-memory assertions in tests/test_kvcache.py)
        self._host_gauge = ValueRecorder("kvcache.host_bytes")
        self._flusher = threading.Thread(
            target=self._flush_loop, daemon=True, name="kvcache-flush")
        self._flusher.start()

    def _note_host(self) -> None:
        self._host_gauge.set(self.tier.bytes)

    @property
    def root(self) -> str:
        return self._fs.root

    @property
    def fs(self) -> KVCacheClient:
        return self._fs

    # -- reads --------------------------------------------------------------
    def _local(self, key: str) -> Optional[bytes]:
        """Tier, then dirty buffer: a dirty value evicted from the tier
        must still be readable (read-your-writes) without touching fs."""
        v = self.tier.get(key)
        if v is not None:
            return v
        with self._mu:
            return self._dirty.get(key)

    def get(self, key: str) -> Optional[bytes]:
        v = self._local(key)
        if v is not None:
            self._host_hits.add()
            return v
        self._host_misses.add()
        v = self._miss_fill(key)
        if v is not None:
            self._fill(key, v)
        return v

    def batch_get(self, keys: Sequence[str]) -> List[Optional[bytes]]:
        """Host hits served from RAM; ALL misses fetched as one striped
        fs batch (one node-grouped batch_read_files underneath)."""
        out: List[Optional[bytes]] = [None] * len(keys)
        missing: List[int] = []
        for i, key in enumerate(keys):
            v = self._local(key)
            if v is not None:
                out[i] = v
                self._host_hits.add()
            else:
                missing.append(i)
        if missing:
            self._host_misses.add(len(missing))
            got = self._miss_fill_batch([keys[i] for i in missing])
            for i, blob in zip(missing, got):
                out[i] = blob
                if blob is not None:
                    self._fill(keys[i], blob)
        return out

    # -- miss path (the serving fleet's interposition point) ----------------
    def _miss_fill(self, key: str) -> Optional[bytes]:
        """Resolve ONE host-tier miss from below. The base class goes
        straight to the fs tier; FleetKVCache
        (tpu3fs_torch/serving/fleet.py) overrides this with single-flight
        -> peer host tier -> storage."""
        return self._fs.get(key)

    def _miss_fill_batch(self, keys: Sequence[str]) -> List[Optional[bytes]]:
        """Batch analogue of ``_miss_fill`` (same override point)."""
        return self._fs.batch_get(keys)

    def _fill(self, key: str, value) -> None:
        self._fill_bytes.add(len(value))
        self._evictions.add(self.tier.put(key, value))
        self._note_host()

    # -- writes -------------------------------------------------------------
    def put(self, key: str, value: bytes,
            write_through: Optional[bool] = None) -> None:
        """Visible to this client's readers immediately; durable in the fs
        tier synchronously (write_through) or via the background flusher.
        The dirty buffer blocks at dirty_max_bytes — bounded host memory
        under a stalled storage tier, like the loader's backpressure."""
        wt = self.write_through if write_through is None else write_through
        if wt:
            self._fs.put(key, value)
            self._evictions.add(self.tier.put(key, value))
            return
        if self.flush_poisoned:
            # the flusher burned its whole error budget: surface the
            # storage failure to the producer NOW instead of buffering
            # toward the dirty bound and stalling silently (write_through
            # still works — its errors surface synchronously anyway)
            raise FsError(Status(
                Code.KVCACHE_FLUSH_POISONED,
                f"write-back flusher failed {self._flush_fail_streak} "
                f"consecutive cycles (budget {self.flush_error_budget})"))
        with self._cond:
            while (not self._stop.is_set() and self._dirty
                   and self._dirty_bytes + len(value)
                   > self.dirty_max_bytes):
                self._cond.wait(0.5)
            old = self._dirty.pop(key, None)
            if old is not None:
                self._dirty_bytes -= len(old)
            self._dirty[key] = value
            self._dirty_bytes += len(value)
            self._dirty_gauge.set(self._dirty_bytes)
            self._cond.notify_all()
        self._evictions.add(self.tier.put(key, value))
        self._note_host()

    def batch_put(self, items, write_through: Optional[bool] = None) -> None:
        """Store many (key, value) entries in one drain: write-through
        rides ``KVCacheClient.batch_put`` (ONE batch_create + ONE striped
        batch write + ONE batch_close for the whole drain — never N serial
        create round trips); write-back lands everything in the dirty
        buffer and lets the flusher drain it batched the same way."""
        items = list(items)
        if not items:
            return
        wt = self.write_through if write_through is None else write_through
        if wt:
            batched = getattr(self._fs, "batch_put", None)
            if batched is not None and len(items) > 1:
                batched(items)
            else:
                for key, value in items:
                    self._fs.put(key, value)
            for key, value in items:
                self._evictions.add(self.tier.put(key, value))
            self._note_host()
            return
        for key, value in items:
            self.put(key, value, write_through=False)

    def peek(self, key: str) -> Optional[bytes]:
        """Local-only read (tier + dirty buffer): the serving host's
        peerRead answers from here — a peer miss must never recurse into
        THIS process's storage-fill path."""
        return self._local(key)

    def remove(self, key: str) -> bool:
        """Drops the local copies and the fs entry. Racing an in-flight
        flush of the same key can leave the fs entry behind (any cache
        remove races its writers); it then ages out by TTL GC."""
        self.tier.remove(key)
        with self._cond:
            old = self._dirty.pop(key, None)
            if old is not None:
                self._dirty_bytes -= len(old)
                self._dirty_gauge.set(self._dirty_bytes)
                self._cond.notify_all()
        return self._fs.remove(key)

    def invalidate(self, key: Optional[str] = None) -> None:
        """Drop local copies + the fs tier's cached inode state (the
        stale-block recovery path, blocks.py)."""
        if key is None:
            self.tier.clear()
        else:
            self.tier.remove(key)
        inval = getattr(self._fs, "invalidate", None)
        if inval is not None:
            inval(key)

    # -- presence -----------------------------------------------------------
    def contains(self, key: str) -> bool:
        return self._local(key) is not None or self._fs.contains(key)

    def batch_contains(self, keys: Sequence[str]) -> List[bool]:
        out = [self._local(k) is not None for k in keys]
        missing = [i for i, hit in enumerate(out) if not hit]
        if missing:
            got = self._fs.batch_contains([keys[i] for i in missing])
            for i, hit in zip(missing, got):
                out[i] = hit
        return out

    # -- arrays -------------------------------------------------------------
    def put_array(self, key: str, array,
                  write_through: Optional[bool] = None) -> None:
        self.put(key, encode_array(array), write_through)

    def get_array(self, key: str):
        raw = self.get(key)
        if raw is None:
            return None
        return decode_array(raw)

    # -- write-back machinery ----------------------------------------------
    def dirty_bytes(self) -> int:
        with self._mu:
            return self._dirty_bytes

    def _flush_loop(self) -> None:
        while not self._stop.is_set():
            with self._cond:
                while not self._dirty and not self._stop.is_set():
                    self._cond.wait(0.2)
                if self._stop.is_set():
                    return
                batch = list(self._dirty.items())[:self._flush_batch]
            self._flush_items(batch)

    @property
    def flush_poisoned(self) -> bool:
        """True once the flusher's consecutive-failure streak reached the
        budget; cleared by the next successful flush cycle."""
        return self._flush_fail_streak >= self.flush_error_budget

    def _retire(self, key, value) -> None:
        with self._cond:
            if self._dirty.get(key) is value:
                del self._dirty[key]
                self._dirty_bytes -= len(value)
                self._dirty_gauge.set(self._dirty_bytes)
                self._cond.notify_all()

    def _flush_items(self, batch) -> None:
        """Write a snapshot through the fs tier, then retire exactly the
        values that were flushed: the entry stays readable in the dirty
        buffer DURING the put (no visibility hole if the tier evicted
        it), and a concurrent overwrite (different value object under the
        same key) survives for the next cycle. The whole batch drains as
        ONE batched striped write (KVCacheClient.batch_put riding the
        pipelined write path) when the fs tier supports it; a failed
        batch falls back to per-key puts so one bad entry cannot wedge
        the rest. Every all-failed cycle burns one unit of the error
        budget (see flush_error_budget); any success resets it."""
        batch_put = getattr(self._fs, "batch_put", None)
        if batch_put is not None and len(batch) > 1:
            try:
                batch_put(batch)
                for key, value in batch:
                    self._flush_bytes.add(len(value))
                    self._retire(key, value)
                self._flush_fail_streak = 0
                return
            except FsError:
                pass  # per-key fallback isolates the failing entry
        flushed_any = False
        for key, value in batch:
            try:
                self._fs.put(key, value)
                self._flush_bytes.add(len(value))
            except FsError:
                self._flush_err.add()
                self._stop.wait(0.05)  # storage unhappy: back off, retry
                continue
            flushed_any = True
            self._retire(key, value)
        if flushed_any:
            self._flush_fail_streak = 0
        else:
            self._flush_fail_streak += 1
            if self.flush_poisoned:
                # poisoned: stop hammering a dead tier at full tilt; one
                # retry cycle per interval keeps probing for recovery
                self._stop.wait(0.2)

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until the dirty buffer drains (True) or timeout."""
        import time as _time

        deadline = _time.monotonic() + timeout
        with self._cond:
            while self._dirty:
                left = deadline - _time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(min(0.2, left))
        return True

    def close(self, flush: bool = True) -> None:
        if flush:
            self.flush()
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        self._flusher.join(timeout=10)
