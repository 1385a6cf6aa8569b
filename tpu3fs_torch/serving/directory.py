"""Gossip-light peer directory over RoutingInfo.serving.

Discovery is the routing snapshot: serving processes register their
endpoint with mgmtd (``servingRegister``, TTL-leased) and every client's
normal routing refresh carries the full directory — no extra gossip
protocol, exactly how chain tables already travel.

Selection is rendezvous hashing (highest-random-weight): every process
ranks the SAME owner order for a key without coordination, so the
fleet's fills for one block converge on one peer's host tier (which is
what makes peer-fill hit), and an endpoint joining or leaving remaps
only its own 1/N of the keyspace — no global reshuffle of everyone's
hot sets.

Health gates ride the PR 9 registry: a breaker-open peer
(``allow`` False) or a latency outlier (``suspect``) is skipped
INSTANTLY — next-ranked peer if any, else the storage path. The skip of
a top-ranked owner is a demotion (serving.demotions).
"""

from __future__ import annotations

import hashlib
import struct
from typing import Callable, List, Optional, Tuple

_NODE = struct.Struct("<Q")


def _weight(key: str, node_id: int) -> bytes:
    h = hashlib.blake2b(_NODE.pack(node_id), digest_size=8)
    h.update(key.encode())
    return h.digest()


class PeerDirectory:
    """Rendezvous-ranked, health-gated view of RoutingInfo.serving."""

    def __init__(self, routing: Callable[[], object], self_node_id: int,
                 *, health=None):
        self._routing = routing
        self.self_node_id = int(self_node_id)
        self._health = health

    # -- membership ---------------------------------------------------------
    def endpoints(self) -> List[object]:
        """Registered peers, self excluded (a process never peer-fills
        from itself — its own tier already missed)."""
        ri = self._routing()
        serving = getattr(ri, "serving", None) or {}
        return [ep for ep in serving.values()
                if ep.node_id != self.self_node_id]

    def ranked(self, key: str) -> List[object]:
        """Peers in rendezvous order (best owner first)."""
        return sorted(self.endpoints(),
                      key=lambda ep: _weight(key, ep.node_id),
                      reverse=True)

    # -- selection ----------------------------------------------------------
    def _healthy(self, node_id: int) -> bool:
        h = self._health
        if h is None:
            return True
        return h.allow(node_id) and not h.suspect(node_id)

    def pick(self, key: str) -> Tuple[Optional[object], bool]:
        """-> (endpoint or None, demoted): the best-ranked HEALTHY peer.
        ``demoted`` is True when a better-ranked peer was skipped on
        health (breaker open / latency outlier) — the instant-demotion
        event the serving recorders count."""
        demoted = False
        for ep in self.ranked(key):
            if self._healthy(ep.node_id):
                return ep, demoted
            demoted = True
        return None, demoted

    def claim_home(self, key: str) -> Optional[int]:
        """Node id owning the key's fill-intent claims: rendezvous over
        peers AND self (every prospective filler must rank the same home,
        so the claim table for a key lives in exactly one place)."""
        ri = self._routing()
        serving = getattr(ri, "serving", None) or {}
        ids = set(serving.keys()) | {self.self_node_id}
        if not ids:
            return None
        return max(ids, key=lambda nid: _weight(key, nid))

    def endpoint_of(self, node_id: int) -> Optional[object]:
        ri = self._routing()
        serving = getattr(ri, "serving", None) or {}
        return serving.get(node_id)
