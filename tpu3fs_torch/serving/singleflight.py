"""Request coalescing for the fleet serving tier, at both scopes.

``SingleFlight`` is the classic in-process collapse: the first caller of
a key becomes the LEADER and runs the fill; every concurrent caller of
the same key blocks on the leader's call and shares its result (or its
exception — a failed fill fails every waiter identically, it does not
retry K times). One storage fill serves all K concurrent waiters —
tests/test_serving.py asserts exactly one underlying RPC.

``FillClaims`` is the cluster half: a bounded-TTL intent table each
serving host exposes over ``fillClaim``/``fillRelease``. Before a
storage fill, a process claims the key at the key's rendezvous-hash HOME
host; a denied claim means some other process is already filling, so the
would-be filler polls the holder's host tier (peerRead) instead of
issuing a duplicate storage fill. Claims are leases, not locks: a
crashed filler's claim simply expires (ttl_ms) and the next miss fills —
correctness never depends on a release arriving.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple


class _Call:
    __slots__ = ("done", "result", "exc")

    def __init__(self):
        self.done = threading.Event()
        self.result = None
        self.exc: Optional[BaseException] = None


class SingleFlight:
    """Per-key leader election for concurrent fills of the same key."""

    def __init__(self):
        self._mu = threading.Lock()
        self._calls: Dict[str, _Call] = {}

    def do(self, key: str, fn: Callable[[], object],
           timeout_s: float = 60.0) -> Tuple[object, bool]:
        """-> (result, was_leader). Waiters re-raise the leader's
        exception; a waiter timing out falls back to running the fill
        itself (liveness beats perfect dedup)."""
        with self._mu:
            call = self._calls.get(key)
            leader = call is None
            if leader:
                call = _Call()
                self._calls[key] = call
        if not leader:
            if call.done.wait(timeout_s):
                if call.exc is not None:
                    raise call.exc
                return call.result, False
            return fn(), False  # leader wedged past timeout: self-serve
        try:
            call.result = fn()
            return call.result, True
        except BaseException as e:
            call.exc = e
            raise
        finally:
            with self._mu:
                self._calls.pop(key, None)
            call.done.set()


class FillClaims:
    """TTL-leased fill-intent table (the cluster-wide single-flight
    half, served over the Serving RPC surface)."""

    def __init__(self, ttl_ms: int = 2000,
                 clock: Callable[[], float] = time.monotonic):
        self.ttl_ms = max(1, int(ttl_ms))
        self._clock = clock
        self._mu = threading.Lock()
        self._claims: Dict[str, Tuple[int, float]] = {}  # key -> (owner, exp)

    def claim(self, key: str, owner: int,
              ttl_ms: Optional[int] = None) -> Tuple[bool, int]:
        """-> (granted, holder). Re-claiming your own live claim renews
        it (granted); an expired claim is free for the taking."""
        ttl = (self.ttl_ms if ttl_ms is None else max(1, int(ttl_ms)))
        now = self._clock()
        with self._mu:
            held = self._claims.get(key)
            if held is not None and held[0] != owner and held[1] > now:
                return False, held[0]
            self._claims[key] = (owner, now + ttl / 1000.0)
            return True, owner

    def release(self, key: str, owner: int) -> bool:
        with self._mu:
            held = self._claims.get(key)
            if held is None or held[0] != owner:
                return False
            del self._claims[key]
            return True

    def prune(self) -> int:
        now = self._clock()
        with self._mu:
            dead = [k for k, (_, exp) in self._claims.items() if exp <= now]
            for k in dead:
                del self._claims[k]
            return len(dead)

    def held(self) -> int:
        now = self._clock()
        with self._mu:
            return sum(1 for _, exp in self._claims.values() if exp > now)
