"""Readahead prefetcher for FileIoClient: sequential-run detection plus a
bounded async prefetch cache.

The client-side analogue of the kernel page cache's readahead window over
the served read path (the reference leans on FUSE/kernel readahead for its
sequential loads; USRBIO and our RPC clients bypass the kernel, so they
need their own): when a file descriptor's reads advance sequentially, the
NEXT window is fetched in the background over the same node-grouped
batch-read pipeline, so the network/server round trip overlaps the
caller's compute instead of stalling it.

Correctness contract:
- consistency is CLIENT-LOCAL: windows are invalidated by THIS client's
  write/truncate/remove (FileIoClient calls invalidate); writes from other
  clients are not seen until the entry is evicted or invalidated — same
  staleness class as the FUSE attr cache, documented in docs/readpath.md.
- memory is bounded: a global LRU cap (max_cache_bytes) across all inodes,
  plus at most max_inflight fetches in flight; adversarial access patterns
  (random offsets, many files) never arm the window, so they cache
  nothing.
- shuffled access does not thrash: arming requires BOTH a sequential run
  (min_run) and a mostly-sequential recent history per inode (the jump
  fraction over a sliding window stays under 1/2). A shuffled/random
  reader — e.g. the dataload loader's SORTED per-batch extents, where
  occasional records happen to be file-adjacent — sees jumps dominate its
  window and never arms, so no 4 MiB windows are fetched for reads that
  will not come back. A genuinely sequential reader re-arms within ~one
  window of reads after a seek.
- QoS: a prefetch runs under the TRAFFIC CLASS of the read that armed it
  (captured at schedule time, restored in the worker via qos.tagged), so
  background-class readers cannot smuggle foreground-priced readahead.

The port's own copy of ``tpu3fs/client/prefetch.py``. A window is fetched
through the file client's device, so a degraded window's decodes are K1
launches on the ``prefetch`` worker threads. A fetch that raises installs
nothing (the reader's own read then goes the normal path, with the same
kernels, and raises there); ``failures`` counts such fetches. ``close``
joins the workers with a bound.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from tpu3fs_torch.monitor.recorder import CounterRecorder


@dataclass
class PrefetchConfig:
    window_bytes: int = 4 << 20    # bytes fetched per readahead trigger
    min_run: int = 2               # sequential reads before arming
    max_cache_bytes: int = 64 << 20
    max_inflight: int = 2
    workers: int = 2


class ReadaheadPrefetcher:
    """Sequential-run detector + bounded async window cache.

    fetch(inode, offset, size) -> bytes is the uncached read (supplied by
    FileIoClient); it runs on background workers only.
    """

    #: sliding-window length (reads) for the jump-fraction thrash guard
    _HIST_WINDOW = 16

    def __init__(self, fetch: Callable, config: Optional[PrefetchConfig] = None):
        self._fetch = fetch
        self.config = config or PrefetchConfig()
        self._mu = threading.Lock()
        # inode id -> [(start, bytes)] sorted by start (few windows/inode)
        self._windows: Dict[int, List[Tuple[int, bytes]]] = {}
        # LRU order of (inode_id, start) keys; total byte accounting
        self._lru: List[Tuple[int, int]] = []
        self._bytes = 0
        # inode id -> (next expected offset, run length)
        self._runs: Dict[int, Tuple[int, int]] = {}
        # inode id -> (jumps, total) over a sliding read window: the
        # thrash guard (see module docstring). Halved when total reaches
        # _HIST_WINDOW so old history decays instead of pinning a verdict.
        self._hist: Dict[int, Tuple[int, int]] = {}
        # invalidation generation per inode: a fetch completing after its
        # inode was invalidated must NOT install a stale window
        self._gen: Dict[int, int] = {}
        # (inode_id, start) -> (end, Event, gen): windows being fetched.
        # lookup() WAITS on a covering in-flight window instead of
        # missing — that is what turns readahead into a double buffer
        # (window K+1 fetches while the caller consumes window K); a
        # fire-and-forget cache would lose every race against a fast
        # sequential reader and readahead would never pay. The gen stamp
        # keeps STALE fetches (invalidated while in flight) from being
        # waited on or from blocking a fresh schedule of the same window.
        self._inflight: Dict[Tuple[int, int], Tuple[int, object, int]] = {}
        self._pool = None
        self.hits = CounterRecorder("prefetch.hits")
        self.misses = CounterRecorder("prefetch.misses")
        self.prefetched_bytes = CounterRecorder("prefetch.bytes")
        self.invalidations = CounterRecorder("prefetch.invalidations")
        self.failures = CounterRecorder("prefetch.failures")

    # -- cache lookup --------------------------------------------------------
    def _lookup_locked(self, inode_id, offset, size) -> Optional[bytes]:
        for start, blob in self._windows.get(inode_id, ()):
            if start <= offset and offset + size <= start + len(blob):
                key = (inode_id, start)
                if key in self._lru:  # LRU refresh
                    self._lru.remove(key)
                    self._lru.append(key)
                lo = offset - start
                return blob[lo:lo + size]
        return None

    def lookup(self, inode_id: int, offset: int, size: int,
               wait_s: float = 30.0) -> Optional[bytes]:
        """Serve [offset, offset+size) if one cached window fully contains
        it (no partial stitching — windows are large and runs sequential,
        so split ranges are rare and fall through to the normal path). A
        covering IN-FLIGHT window is waited for: the fetch was issued a
        whole window ago, so the wait is the pipelined remainder, not a
        fresh round trip."""
        if size <= 0:
            return None
        with self._mu:
            blob = self._lookup_locked(inode_id, offset, size)
            if blob is not None:
                self.hits.add()
                return blob
            ev = None
            cur_gen = self._gen.get(inode_id, 0)
            for (ino, start), (end, event, gen) in self._inflight.items():
                if ino == inode_id and gen == cur_gen \
                        and start <= offset and offset + size <= end:
                    ev = event
                    break
        if ev is not None:
            ev.wait(wait_s)
            with self._mu:
                blob = self._lookup_locked(inode_id, offset, size)
            if blob is not None:
                self.hits.add()
                return blob
        self.misses.add()
        return None

    # -- run detection + scheduling ------------------------------------------
    def record_read(self, inode, offset: int, size: int) -> None:
        """Note a served read; arm and schedule readahead when the access
        pattern is sequential. Called AFTER the read was served (cache hit
        or not) with the caller's thread still tagged with its class."""
        if size <= 0:
            return
        cfg = self.config
        end = offset + size
        with self._mu:
            expected, run = self._runs.get(inode.id, (None, 0))
            sequential = expected == offset
            run = run + 1 if sequential else 1
            self._runs[inode.id] = (end, run)
            # thrash guard: a JUMP is any read that breaks the expected
            # sequence (the first-ever read of an inode is neither). Arm
            # only while jumps stay a strict minority of the recent
            # window — a shuffled reader whose sorted batches contain the
            # odd adjacent pair can satisfy min_run, but never this.
            jumps, total = self._hist.get(inode.id, (0, 0))
            total += 1
            if expected is not None and not sequential:
                jumps += 1
            if total >= self._HIST_WINDOW:
                jumps //= 2
                total //= 2
            self._hist[inode.id] = (jumps, total)
            if run < cfg.min_run or jumps * 2 > total:
                return
            # the next window begins where cached/in-flight coverage of
            # the current position ends — back-to-back windows, no overlap
            gen = self._gen.get(inode.id, 0)
            start = end
            for wstart, blob in self._windows.get(inode.id, ()):
                if wstart <= start < wstart + len(blob):
                    start = wstart + len(blob)
            live = 0
            for (ino, wstart), (wend, _ev, wgen) in self._inflight.items():
                if ino == inode.id and wgen != gen:
                    continue  # doomed stale fetch: ignore entirely
                live += 1
                if ino == inode.id and wstart <= start < wend:
                    start = wend
            length = getattr(inode, "length", 0) or 0
            if length and start >= length:
                return
            window = cfg.window_bytes
            if length:
                window = min(window, length - start)
            if window <= 0:
                return
            key = (inode.id, start)
            cur = self._inflight.get(key)
            if (cur is not None and cur[2] == gen) or \
                    live >= cfg.max_inflight:
                return
            import threading as _threading

            event = _threading.Event()
            self._inflight[key] = (start + window, event, gen)
        from tpu3fs_torch.qos.core import current_class
        from tpu3fs_torch.tenant.identity import current_tenant

        self._submit(inode, start, window, gen, current_class(),
                     current_tenant(), event)

    def _submit(self, inode, start, window, gen, tclass, tenant,
                event) -> None:
        import contextlib

        from tpu3fs_torch.qos.core import tagged
        from tpu3fs_torch.tenant.identity import tenant_scope

        def job() -> None:
            key = (inode.id, start)
            with self._mu:
                doomed = self._gen.get(inode.id, 0) != gen
            if doomed:
                # invalidated while queued: abort BEFORE fetching, or a
                # stale window would hog a worker at the head of the
                # queue while fresh windows starve behind it
                blob = None
            else:
                try:
                    from tpu3fs_torch.analytics import spans as _spans

                    ctx = (tagged(tclass) if tclass is not None
                           else contextlib.nullcontext())
                    # trace DETACHED: a readahead completes long after the
                    # arming reader's op span closed — its RPCs must not
                    # append to (or re-sample) that finished trace. The
                    # TENANT is carried like the class: readahead is IO on
                    # the arming reader's behalf, so its quota pays
                    with ctx, tenant_scope(tenant), \
                            _spans.trace_scope(None):
                        blob = self._fetch(inode, start, window)
                except BaseException:
                    blob = None  # best-effort: a failed readahead serves
                    # nobody
                    self.failures.add()
            with self._mu:
                cur = self._inflight.get(key)
                if cur is not None and cur[1] is event:
                    # pop OUR entry only: a stale fetch must not evict a
                    # fresh reschedule of the same window
                    del self._inflight[key]
                if blob is not None and self._gen.get(inode.id, 0) == gen:
                    self._install_locked(inode.id, start, bytes(blob))
                    installed = True
                else:
                    installed = False  # invalidated while in flight: drop
            event.set()  # AFTER install: waiters re-check and hit
            if installed:
                self.prefetched_bytes.add(window)

        pool = self._ensure_pool()
        try:
            pool.submit(job, block=False)
        except Exception:
            with self._mu:  # queue full: skip this window
                key = (inode.id, start)
                cur = self._inflight.get(key)
                if cur is not None and cur[1] is event:
                    del self._inflight[key]
            event.set()

    def _ensure_pool(self):
        with self._mu:
            if self._pool is None:
                from tpu3fs_torch.utils.executor import WorkerPool

                self._pool = WorkerPool("prefetch",
                                        num_workers=self.config.workers,
                                        queue_cap=16)
            return self._pool

    def _install_locked(self, inode_id: int, start: int, blob: bytes) -> None:
        wins = self._windows.setdefault(inode_id, [])
        wins.append((start, blob))
        wins.sort(key=lambda w: w[0])
        key = (inode_id, start)
        if key in self._lru:
            self._lru.remove(key)
        self._lru.append(key)
        self._bytes += len(blob)
        while self._bytes > self.config.max_cache_bytes and self._lru:
            old_ino, old_start = self._lru.pop(0)
            old = self._windows.get(old_ino, [])
            for i, (s, b) in enumerate(old):
                if s == old_start:
                    self._bytes -= len(b)
                    del old[i]
                    break
            if not old:
                self._windows.pop(old_ino, None)

    # -- invalidation --------------------------------------------------------
    def invalidate(self, inode_id: int) -> None:
        """Drop every cached/in-flight window of the inode (called on
        write/truncate/remove through this client)."""
        with self._mu:
            self._gen[inode_id] = self._gen.get(inode_id, 0) + 1
            self._runs.pop(inode_id, None)
            self._hist.pop(inode_id, None)
            wins = self._windows.pop(inode_id, None)
            if wins:
                for start, blob in wins:
                    self._bytes -= len(blob)
                    try:
                        self._lru.remove((inode_id, start))
                    except ValueError:
                        pass
                self.invalidations.add()

    def invalidate_all(self) -> None:
        with self._mu:
            for ino in list(self._windows):
                self._gen[ino] = self._gen.get(ino, 0) + 1
            self._windows.clear()
            self._lru.clear()
            self._runs.clear()
            self._hist.clear()
            self._bytes = 0

    def cached_bytes(self) -> int:
        with self._mu:
            return self._bytes

    def close(self) -> None:
        """Stop the readahead workers: a window in flight finishes, then
        each worker is joined with a bound."""
        with self._mu:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)
