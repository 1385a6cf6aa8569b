"""Size-classed reusable buffer pool for the transport receive path.

The port's own copy of ``tpu3fs/utils/bufpool.py``,
unchanged but for its imports.

The registered-buffer-pool role of the reference (src/common/net/
RDMABuf.h:434 — a pool of pre-registered buffers RDMA operations land in;
BufferPool in net/Buffer.h): here the "registration" being amortized is
CPython allocation churn — every RPC frame used to allocate a fresh
bytearray. Buffers are leased with acquire() and either released back
(inline frames, whose fields are copied out during serde decode) or
detached (bulk frames, whose memoryview segments escape to the caller and
keep the buffer alive via the view; GC reclaims it).

Release discipline: releasing a buffer that still has exported memoryviews
would hand two frames the same memory — the caller must release ONLY when
no views escaped. The transport upholds this by releasing inline frames
after packet decode and never releasing bulk frames.
"""

from __future__ import annotations

import threading
from typing import Dict, List


def _alloc(n: int):
    """An UNINITIALIZED writable buffer of n bytes. numpy.empty skips the
    page-zeroing a fresh bytearray pays — receive buffers are filled by
    recv_into before any byte is read, so zeroing was pure memory traffic
    (measured ~13% of served-read client time at 256 KiB chunks)."""
    try:
        import numpy as np

        return np.empty(n, dtype=np.uint8)
    except ImportError:  # minimal envs: correctness over the zeroing cost
        return bytearray(n)


def _class_of(n: int) -> int:
    """Smallest power-of-two >= n (min 4 KiB) — the pooling size class."""
    size = 4096
    while size < n:
        size <<= 1
    return size


class BufferPool:
    """Bounded per-class freelists of reusable bytearrays."""

    def __init__(self, *, max_per_class: int = 32,
                 max_class_bytes: int = 8 << 20):
        self._free: Dict[int, List[bytearray]] = {}
        self._mu = threading.Lock()
        self._max_per_class = max_per_class
        # buffers above this size are allocated fresh and never pooled:
        # one 64 MiB frame must not pin 64 MiB of freelist forever
        self._max_class_bytes = max_class_bytes
        self.hits = 0
        self.misses = 0
        # lease accounting for the mem.bufpool_* gauges: acquires minus
        # releases. Detached bulk frames are never release()d by design
        # (their memoryviews own the buffer, GC reclaims), so outstanding
        # counts them until collected — a leak DETECTOR, not a leak.
        self.acquired = 0
        self.released = 0

    def acquire(self, n: int):
        """A writable buffer of len >= n (callers track their own exact
        length). May be a numpy uint8 array (uninitialized — see _alloc)
        or a bytearray; both support len/memoryview/recv_into."""
        cls = _class_of(n)
        if cls > self._max_class_bytes:
            with self._mu:
                self.misses += 1
                self.acquired += 1
            return _alloc(n)
        with self._mu:
            free = self._free.get(cls)
            self.acquired += 1
            if free:
                self.hits += 1
                return free.pop()
            self.misses += 1
        return _alloc(cls)

    def release(self, buf) -> None:
        """Return a lease. ONLY for buffers with no escaped memoryviews."""
        with self._mu:
            self.released += 1
        cls = len(buf)
        # non-class-sized buffers were allocated fresh (oversize path)
        if cls > self._max_class_bytes or cls & (cls - 1):
            return
        with self._mu:
            free = self._free.setdefault(cls, [])
            if len(free) < self._max_per_class:
                free.append(buf)

    def stats(self) -> dict:
        with self._mu:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "outstanding": self.acquired - self.released,
                "pooled_bytes": sum(
                    cls * len(v) for cls, v in self._free.items()),
            }


# shared process-wide pool for the RPC receive path
GLOBAL_POOL = BufferPool()
