"""TEST-ONLY planted-bug registry.

The port's own copy of ``tpu3fs/chaos/bugs.py``,
unchanged but for its imports.

The chaos search (tpu3fs/chaos/search.py) must demonstrably FIND bugs,
not just run green — so known-fixed bugs can be re-introduced behind a
flag here and the search proven to catch them within a bounded seed
budget (ISSUE 14 acceptance; the shrunk schedule then ships in
``tests/chaos_seeds/``).

Armed via ``arm()``/``disarm()`` or the ``TPU3FS_CHAOS_BUG`` env var
(comma-separated names, read once at import). Production code guards its
hook sites with ``bug_fire(name)`` which is two attribute loads and a
set-membership test when nothing is armed — and bugs only FIRE while the
cluster fault plane has rules configured (the "crash window"): a planted
bug needs a chaos schedule to trigger it, which is exactly what makes
the search a search.

Known bugs:

- ``commit_skip`` — the PR-2-era crash-window shape: a chain-internal
  hop ACKs a batch update upstream without durably committing it
  locally (storage/craq.py). The head commits and acks the client; the
  replica silently stays at the old committed version. Caught by the
  ``replica_versions`` invariant checker (and by ``crc_oracle`` when a
  read lands on the stale replica).

- ``chain_parity_skip`` — the chain-encode hop bug shape: a data hop of
  the pipelined chain encode installs its shard but forwards the parity
  accumulator UNCHANGED — contribution AND partial-CRC composition both
  dropped (the realistic "forgot to accumulate" bug), so the tail's
  validated install passes and consistently-WRONG parity commits
  cleanly. Invisible to clean reads (data shards only); caught by
  ``crc_oracle`` the moment a kill forces a degraded decode through the
  bad parity (or a rebuild re-materializes a data shard from it).

- ``rename_orphan_intent`` — the two-phase meta bug shape: the crash
  resolver (tpu3fs/metashard/twophase.py resolve_intents) rolls a
  dangling rename intent FORWARD without the points-at-recorded-inode
  guard on the src-dirent clear. A crashed coordinator leaves the
  intent; meanwhile the src name is legitimately reused (remove +
  create); the buggy replay then clears the NEW file's dirent — its
  inode survives with no name (orphan) and the namespace silently
  shrinks. Caught by the ``meta_intents`` invariant checker (post-storm
  namespace audit: every live inode reachable, every intent resolved
  exactly once).

- ``peer_fill_stale`` — the serving-tier staleness bug shape: a peer's
  serve-through path (tpu3fs/serving/service.py _serve_through) answers
  ``peerRead`` with the raw cached-inode read WITHOUT the zero-hole
  staleness check — a block whose entry the GC already evicted reads
  back as an all-zero hole through the stale inode and ships to the
  requester as KV content (zeros-as-KV). The correct path detects the
  hole, invalidates, and re-probes meta (KVCACHE_STALE semantics: a
  stale block must surface as a MISS, never as fabricated bytes).
  Caught by the ``kvcache_stale`` checker on the serving sidecar's
  read records.

- ``native_commit_skip_crc`` — the native-write-path bug shape: the C++
  head fast path (native/rpc_net.cpp) commits and acks a chain write
  WITHOUT cross-checking the successor's checksum against the staged
  CRC — the one guard that catches a payload corrupted in flight or a
  replica staging divergent bytes (ref StorageOperator.cc :464-482).
  Armed state is pushed into the .so each target scan
  (storage/native_fastpath.py -> fastpath_set_skip_crc). With the check
  skipped, a corrupted forward commits DIFFERENT bytes on head and
  successor while both report OK. Caught by the ``replica_crc``
  invariant checker (post-storm: committed replicas of every chunk must
  agree on CRC), and by ``crc_oracle`` when a read lands on the
  divergent replica.

- ``lease_fence_skip`` — the split-brain fencing bug shape: a storage
  node partitioned away from mgmtd must judge its own lease fence
  (T/2 of mgmtd silence, docs/design_notes.md "Failure detection") and
  both STOP acking head writes and demote its targets' local state to
  ONLINE so the chain state machine resyncs it on return. With the bug
  armed the fence check lies (``StorageService._fence_expired`` reports
  False forever), so a partitioned head keeps acking while mgmtd
  promotes a successor, and on heal it rejoins claiming UPTODATE —
  skipping resync with writes it never saw. Caught by the
  ``replica_versions`` invariant checker (the stale replica's committed
  versions diverge from the serving side) and by ``crc_oracle`` when a
  read lands on the stale replica. Fires inside partition windows
  (``partition_begin``/``partition_end``), not only fault-plane windows
  — partitions are schedule events, not drop rules.
"""

from __future__ import annotations

import os
import threading
from typing import Set

_lock = threading.Lock()
_armed: Set[str] = set(
    n.strip() for n in os.environ.get("TPU3FS_CHAOS_BUG", "").split(",")
    if n.strip()
)

#: names production hook sites are allowed to ask about (a typo'd
#: arm()/hook pair must fail loudly, not silently never fire)
KNOWN_BUGS = frozenset({
    "commit_skip", "chain_parity_skip", "peer_fill_stale",
    "rename_orphan_intent", "native_commit_skip_crc", "lease_fence_skip",
})

#: open partition windows (chaos ``partition`` events). Partitions are
#: explicit schedule events, NOT fault-plane rules — so ``bug_fire`` must
#: also count an open partition as a crash window, else a bug whose
#: trigger IS the partition (lease_fence_skip) could never fire.
_partition_depth = 0


def partition_begin() -> None:
    global _partition_depth
    with _lock:
        _partition_depth += 1


def partition_end() -> None:
    global _partition_depth
    with _lock:
        _partition_depth = max(0, _partition_depth - 1)


def partition_window_open() -> bool:
    return _partition_depth > 0


def arm(name: str) -> None:
    if name not in KNOWN_BUGS:
        raise ValueError(f"unknown planted bug {name!r} "
                         f"(known: {sorted(KNOWN_BUGS)})")
    with _lock:
        _armed.add(name)


def disarm(name: str = "") -> None:
    """Disarm one bug (or all, with no argument)."""
    with _lock:
        if name:
            _armed.discard(name)
        else:
            _armed.clear()


def armed(name: str) -> bool:
    return name in _armed


def bug_fire(name: str) -> bool:
    """The production hook: True iff ``name`` is armed AND a crash window
    is open — the cluster fault plane has rules configured, or a chaos
    partition event is in flight. Near zero cost disarmed."""
    if name not in _armed:
        return False
    if _partition_depth > 0:
        return True
    from tpu3fs_torch.utils.fault_injection import plane

    return plane().active
