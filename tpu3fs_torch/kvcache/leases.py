"""Pin leases: active decodes are never GC'd out from under themselves.

An inference session serving a long decode holds its prompt's prefix
blocks for seconds to minutes. TTL and capacity GC must not reclaim those
entries mid-decode — so a session PINS the keys it depends on. A pin is a
``kvcache.lease`` xattr on the entry (layout.encode_lease: expire
timestamp + owner), which makes it:

- durable and cross-process: any GC (in-process, admin CLI, a daemon on
  another machine) sees the lease on the stat() it already does — the
  check costs no extra metadata round trip;
- self-expiring: a crashed session's pins age out with the lease TTL, so
  abandoned leases can never wedge eviction permanently;
- re-entrant on content-addressed keys: two sessions sharing a prefix
  both pin the same entries; the later expiry wins (renewing extends,
  never shortens, another owner's protection).

``pin()`` returns a ``Lease`` handle; ``unpin()`` (or the context
manager) releases only pins this lease still owns — it never strips a
longer-lived lease another session stacked on the same block.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import List, Optional, Sequence

from tpu3fs_torch.kvcache.layout import (
    LEASE_XATTR,
    decode_lease,
    encode_lease,
    shard_path,
)
from tpu3fs_torch.monitor.recorder import ValueRecorder
from tpu3fs_torch.qos.core import TrafficClass, tagged
from tpu3fs_torch.utils.result import FsError


class Lease:
    """One session's pins: the keys it protects and their expiry."""

    def __init__(self, owner: str, keys: List[str], expire_ts: float):
        self.owner = owner
        self.keys = keys
        self.expire_ts = expire_ts

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # the manager that minted this lease releases it
        self._manager.unpin(self)
        return False


class LeaseManager:
    """Pin/unpin entry leases for one cache root."""

    def __init__(self, meta, *, root: str = "/kvcache",
                 default_ttl_s: float = 300.0,
                 owner: Optional[str] = None):
        self._meta = meta
        self.root = root.rstrip("/") or "/kvcache"
        self.default_ttl_s = default_ttl_s
        self.owner = owner or f"kvlease-{uuid.uuid4().hex[:8]}"
        self._lock = threading.Lock()
        self._active = 0
        self._gauge = ValueRecorder("kvcache.leases")

    def _bump(self, delta: int) -> None:
        with self._lock:
            self._active += delta
            self._gauge.set(self._active)

    @property
    def active(self) -> int:
        with self._lock:
            return self._active

    def pin(self, keys: Sequence[str],
            ttl_s: Optional[float] = None) -> Lease:
        """Pin existing entries for ttl_s; missing keys are skipped (the
        caller's match_prefix already told it what exists). Pinning a key
        another session pinned EXTENDS the protection window when this
        lease outlives the old one, and leaves the longer lease alone
        otherwise."""
        ttl = self.default_ttl_s if ttl_s is None else ttl_s
        expire = time.time() + ttl
        pinned: List[str] = []
        with tagged(TrafficClass.KVCACHE):
            for key in keys:
                path = shard_path(self.root, key)
                try:
                    cur = self._lease_of(path)
                    if cur is not None and cur[0] > expire:
                        pinned.append(key)  # already better protected
                        continue
                    self._meta.set_xattr(
                        path, LEASE_XATTR, encode_lease(expire, self.owner))
                    pinned.append(key)
                except FsError:
                    continue  # missing entry: nothing to protect
        lease = Lease(self.owner, pinned, expire)
        lease._manager = self
        self._bump(len(pinned))
        return lease

    def renew(self, lease: Lease, ttl_s: Optional[float] = None) -> None:
        """Extend a live lease (long decodes renew well before expiry)."""
        ttl = self.default_ttl_s if ttl_s is None else ttl_s
        expire = time.time() + ttl
        with tagged(TrafficClass.KVCACHE):
            for key in lease.keys:
                try:
                    self._meta.set_xattr(
                        shard_path(self.root, key), LEASE_XATTR,
                        encode_lease(expire, self.owner))
                except FsError:
                    continue  # entry gone (expired lease + GC): skip
        lease.expire_ts = expire

    def unpin(self, lease: Lease) -> int:
        """Release a lease's pins; returns pins actually removed. Only
        strips the xattr while it still carries THIS lease's protection —
        a longer or foreign lease stacked on a shared block survives."""
        released = 0
        with tagged(TrafficClass.KVCACHE):
            for key in lease.keys:
                path = shard_path(self.root, key)
                try:
                    cur = self._lease_of(path)
                    if cur is None:
                        continue
                    expire, owner = cur
                    if owner == self.owner and expire <= lease.expire_ts:
                        self._meta.remove_xattr(path, LEASE_XATTR)
                        released += 1
                except FsError:
                    continue
        self._bump(-len(lease.keys))
        lease.keys = []
        return released

    def _lease_of(self, path: str):
        try:
            raw = self._meta.get_xattr(path, LEASE_XATTR)
        except FsError:
            return None
        return decode_lease(raw)
