"""Static idempotency / hedge-safety classification of every RPC method.

The port's own copy of ``tpu3fs/rpc/idempotency.py``,
unchanged but for its imports.

Hedged reads issue the SAME request to a second replica and take the
first reply — only safe when executing a request twice (possibly with
both executions landing) is indistinguishable from executing it once.
That property is STATIC, so it lives in one table that
``tools/check_rpc_registry.py`` enforces against every bound service
method (tier-1): a new method without a classification fails CI, and a
method the hedging client uses that is not classified idempotent fails
CI — hedging can never silently grow onto a mutating RPC.

Classification values:

- ``idempotent``: repeat execution is free of side effects (committed
  reads, stats, routing fetches). HEDGE-SAFE.
- ``mutating``: repeat execution changes state or double-charges a
  resource. Never hedged; subject to breaker fail-fast instead
  (rpc/health.py). CRAQ writes are exactly-once per (client, channel,
  seqnum) — replay-SAFE for retries — but hedging one would consume two
  update-queue slots and two chain pipelines for one logical update, so
  they classify mutating on purpose.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

IDEMPOTENT = "idempotent"
MUTATING = "mutating"

#: (service name, method name) -> classification. check_rpc_registry
#: verifies this table covers every bound method and carries no stale
#: rows, so it IS the registry.
CLASSIFICATION: Dict[Tuple[str, str], str] = {
    # -- StorageSerde -----------------------------------------------------
    ("StorageSerde", "write"): MUTATING,
    ("StorageSerde", "update"): MUTATING,
    ("StorageSerde", "read"): IDEMPOTENT,
    ("StorageSerde", "dumpChunkMeta"): IDEMPOTENT,
    ("StorageSerde", "syncDone"): MUTATING,
    ("StorageSerde", "removeChunk"): MUTATING,
    ("StorageSerde", "removeFileChunks"): MUTATING,
    ("StorageSerde", "queryLastChunk"): IDEMPOTENT,
    ("StorageSerde", "truncateChunks"): MUTATING,
    ("StorageSerde", "spaceInfo"): IDEMPOTENT,
    ("StorageSerde", "batchRead"): IDEMPOTENT,
    ("StorageSerde", "batchWrite"): MUTATING,
    ("StorageSerde", "writeShard"): MUTATING,
    ("StorageSerde", "batchWriteShard"): MUTATING,
    ("StorageSerde", "batchUpdate"): MUTATING,
    ("StorageSerde", "statChunks"): IDEMPOTENT,
    ("StorageSerde", "pruneClientChannels"): MUTATING,
    ("StorageSerde", "offlineTarget"): MUTATING,
    ("StorageSerde", "readRebuild"): IDEMPOTENT,
    ("StorageSerde", "dumpPendingChunkMeta"): IDEMPOTENT,
    ("StorageSerde", "batchReadRebuild"): IDEMPOTENT,
    ("StorageSerde", "chainEncodeWrite"): MUTATING,
    # -- MetaSerde --------------------------------------------------------
    ("MetaSerde", "statFs"): IDEMPOTENT,
    ("MetaSerde", "stat"): IDEMPOTENT,
    ("MetaSerde", "create"): MUTATING,
    ("MetaSerde", "mkdirs"): MUTATING,
    ("MetaSerde", "symlink"): MUTATING,
    ("MetaSerde", "hardLink"): MUTATING,
    ("MetaSerde", "remove"): MUTATING,
    ("MetaSerde", "open"): MUTATING,   # allocates a session
    ("MetaSerde", "sync"): MUTATING,
    ("MetaSerde", "close"): MUTATING,
    ("MetaSerde", "rename"): MUTATING,
    ("MetaSerde", "list"): IDEMPOTENT,
    ("MetaSerde", "truncate"): MUTATING,
    ("MetaSerde", "getRealPath"): IDEMPOTENT,
    ("MetaSerde", "setAttr"): MUTATING,
    ("MetaSerde", "pruneSession"): MUTATING,
    ("MetaSerde", "batchStat"): IDEMPOTENT,
    ("MetaSerde", "authenticate"): IDEMPOTENT,
    ("MetaSerde", "setXattr"): MUTATING,
    ("MetaSerde", "getXattr"): IDEMPOTENT,
    ("MetaSerde", "listXattrs"): IDEMPOTENT,
    ("MetaSerde", "removeXattr"): MUTATING,
    ("MetaSerde", "batchClose"): MUTATING,
    ("MetaSerde", "batchSetAttr"): MUTATING,
    ("MetaSerde", "batchCreate"): MUTATING,
    ("MetaSerde", "batchMkdirs"): MUTATING,
    # two-phase participant plane (tpu3fs/metashard/twophase.py): all
    # MUTATING for hedging purposes, all REPLAY-SAFE by construction —
    # the crash resolver re-drives them blindly (check 9).
    ("MetaSerde", "renamePrepare"): MUTATING,
    ("MetaSerde", "renameFinish"): MUTATING,
    ("MetaSerde", "renameResolve"): MUTATING,
    # -- Mgmtd ------------------------------------------------------------
    ("Mgmtd", "heartbeat"): MUTATING,   # versioned: replay rejected anyway
    ("Mgmtd", "getRoutingInfo"): IDEMPOTENT,
    ("Mgmtd", "registerNode"): MUTATING,
    ("Mgmtd", "createTarget"): MUTATING,
    ("Mgmtd", "uploadChain"): MUTATING,
    ("Mgmtd", "uploadChainTable"): MUTATING,
    ("Mgmtd", "setConfig"): MUTATING,
    ("Mgmtd", "getConfig"): IDEMPOTENT,
    ("Mgmtd", "tick"): MUTATING,
    # elasticity / migration control plane (docs/placement.md). The
    # chain mutations and job reports are MUTATING for hedging purposes
    # but REPLAY-SAFE by construction (see REPLAY_SAFE_MUTATIONS below):
    # the crash-resumed migration worker re-executes them blindly.
    ("Mgmtd", "addChainTarget"): MUTATING,
    ("Mgmtd", "dropChainTarget"): MUTATING,
    ("Mgmtd", "setNodeTags"): MUTATING,
    ("Mgmtd", "migrationSubmit"): MUTATING,
    ("Mgmtd", "migrationList"): IDEMPOTENT,
    ("Mgmtd", "migrationClaim"): MUTATING,
    ("Mgmtd", "migrationReport"): MUTATING,
    # serving-endpoint directory (tpu3fs/serving): TTL-leased rows in
    # RoutingInfo.serving; registration renewal is replay-safe by
    # construction (same host/port re-register is version-silent) but
    # classifies MUTATING like registerNode
    ("Mgmtd", "servingRegister"): MUTATING,
    ("Mgmtd", "servingUnregister"): MUTATING,
    # -- Usrbio (shm-ring control plane; the DATA rides StorageSerde) -----
    ("Usrbio", "usrbioHandshake"): IDEMPOTENT,
    ("Usrbio", "usrbioRegister"): MUTATING,    # spawns a ring worker
    ("Usrbio", "usrbioDeregister"): MUTATING,
    # -- Core -------------------------------------------------------------
    ("Core", "echo"): IDEMPOTENT,
    ("Core", "renderConfig"): IDEMPOTENT,
    ("Core", "hotUpdateConfig"): MUTATING,
    ("Core", "shutdown"): MUTATING,
    ("Core", "getConfig"): IDEMPOTENT,
    ("Core", "getLastConfigUpdateRecord"): IDEMPOTENT,
    ("Core", "flightDump"): MUTATING,   # writes a dump file per call
    # -- Kv ---------------------------------------------------------------
    ("Kv", "snapshot"): MUTATING,   # allocates a read-snapshot lease
    ("Kv", "get"): IDEMPOTENT,
    ("Kv", "getRange"): IDEMPOTENT,
    ("Kv", "commit"): MUTATING,
    ("Kv", "release"): MUTATING,
    # -- KvRepl (raft internals: term/log state machines) -----------------
    ("KvRepl", "appendEntries"): MUTATING,
    ("KvRepl", "requestVote"): MUTATING,
    ("KvRepl", "installSnapshot"): MUTATING,
    ("KvRepl", "status"): IDEMPOTENT,
    ("KvRepl", "reconfig"): MUTATING,
    # -- MonitorCollector -------------------------------------------------
    ("MonitorCollector", "write"): MUTATING,   # double-counts samples
    ("MonitorCollector", "query"): IDEMPOTENT,
    ("MonitorCollector", "aggQuery"): IDEMPOTENT,
    # sloStatus may run an evaluation pass, but evaluation is a pure
    # function of (rules, aggregates, clock) — replaying it is safe
    ("MonitorCollector", "sloStatus"): IDEMPOTENT,
    # -- SimpleExample ----------------------------------------------------
    ("SimpleExample", "write"): MUTATING,
    ("SimpleExample", "read"): IDEMPOTENT,
    # -- Serving (fleet KVCache peer-fill, tpu3fs/serving) ----------------
    # peerRead is a committed-state read of a peer's host tier (and its
    # serve-through is a plain storage read) — hedge-safe, and the fleet
    # fill path DOES hedge it against the storage fill.
    ("Serving", "peerRead"): IDEMPOTENT,
    ("Serving", "fillClaim"): MUTATING,     # takes/renews a fill lease
    ("Serving", "fillRelease"): MUTATING,
    ("Serving", "servingStats"): IDEMPOTENT,
    ("Serving", "servingLoad"): MUTATING,   # runs a workload leg
}

#: messenger-level method names the hedging client may back up with a
#: second replica request, mapped to the wire method they resolve to.
#: check_rpc_registry asserts every target classifies IDEMPOTENT.
HEDGE_SAFE_MESSENGER_METHODS: Dict[str, Tuple[str, str]] = {
    "read": ("StorageSerde", "read"),
    "batch_read": ("StorageSerde", "batchRead"),
}

#: MUTATING methods whose blind RE-EXECUTION (not hedging — serial
#: replay after a crash, same arguments) converges instead of
#: double-applying, each with the mechanism that makes it so. The
#: crash-resumed migration worker re-runs its current phase from the
#: top, so every mutation it issues must appear here or classify
#: idempotent — check_rpc_registry check 8 enforces exactly that
#: against migration/service.py's RESUME_REEXECUTED_METHODS.
REPLAY_SAFE_MUTATIONS: Dict[Tuple[str, str], str] = {
    ("StorageSerde", "update"): "version-guarded: a full-replace at an "
        "already-committed update_ver answers CHUNK_STALE_UPDATE -> OK",
    ("StorageSerde", "batchUpdate"): "same per-op stale-update dedupe as "
        "update",
    ("StorageSerde", "batchWrite"): "exactly-once per (client, channel, "
        "seqnum): replays answer from the channel table",
    ("StorageSerde", "syncDone"): "sets local_state UPTODATE; repeat is "
        "a no-op",
    ("StorageSerde", "removeChunk"): "removing an absent chunk returns "
        "false, changes nothing",
    ("StorageSerde", "batchWriteShard"): "stripe-version dedupe: an "
        "install at an already-committed version answers OK (same "
        "content) or CHUNK_STALE_UPDATE (superseded) — never "
        "double-applies (craq._triage_shard_install)",
    ("Mgmtd", "addChainTarget"): "already-a-member is a committed "
        "PREPARE: explicit no-op",
    ("Mgmtd", "dropChainTarget"): "already-dropped is a committed "
        "CUTOVER: explicit no-op",
    ("Mgmtd", "migrationClaim"): "claim lease CAS: re-claiming your own "
        "(or a lapsed) claim just renews it",
    ("Mgmtd", "migrationReport"): "phases only move forward; re-reporting "
        "a passed phase is a no-op",
    ("Mgmtd", "migrationSubmit"): "one active job per chain: a replayed "
        "submit for a chain already being reshaped answers "
        "MIGRATION_CONFLICT; the auto re-plan loop re-derives its plan "
        "from live routing, so an already-evacuated node yields an "
        "empty plan (no-op)",
    # metashard two-phase plane (twophase.TWOPHASE_REEXECUTED_METHODS;
    # check 9 holds each entry to this table or idempotent)
    ("MetaSerde", "renamePrepare"): "prepare-record guard: the record is "
        "written in the SAME txn as the effect, so a replayed prepare "
        "sees the record and returns without re-applying",
    ("MetaSerde", "renameFinish"): "clears the prepare record; an absent "
        "record is an explicit no-op",
    ("MetaSerde", "renameResolve"): "resolver mutations are guarded "
        "(dirent cleared only while it still points at the intent's "
        "inode; nlink undone only behind a live prepare record) — "
        "re-resolving converges to the same state",
}


def classify(service: str, method: str) -> Optional[str]:
    """Classification for one bound method, or None when unclassified
    (which the static registry check turns into a CI failure)."""
    return CLASSIFICATION.get((service, method))


def hedge_safe(service: str, method: str) -> bool:
    return CLASSIFICATION.get((service, method)) == IDEMPOTENT
