"""Static tenant-quota enforcement classification of every RPC method.

The port's own copy of ``tpu3fs/tenant/enforcement.py``,
unchanged but for its imports.

Tenant quotas (tenant/quota.py) are charged at admission — but WHICH
admission, and on WHAT axis, is a static property of each method, so it
lives in one table that ``tools/check_rpc_registry.py`` enforces against
every bound service method (check 6, the idempotency-table pattern): a
new method without a classification fails CI, and a data-plane method
(one whose untagged QoS classification is foreground read/write) can
never silently classify EXEMPT and dodge quota enforcement.

Classification values:

- ``bytes``: charged ops + payload bytes against the tenant's
  iops/bytes_per_s buckets. Storage data-plane methods enforce INSIDE
  the service (craq read/write admission, where the true payload sizes
  are known and the in-process fabric path is covered); everything else
  enforces at RPC dispatch using the frame size.
- ``iops``: charged ops only (metadata ops: the payload is not the
  resource being protected).
- ``exempt``: control-plane traffic (heartbeats, routing, config,
  cluster internals). Never quota-charged — throttling a heartbeat
  under a tenant's quota would convert one tenant's flood into a
  cluster-membership incident. Exempt methods still RESOLVE a tenant
  (identity.resolved_tenant) so spans and recorders stay attributed.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

BYTES = "bytes"
IOPS = "iops"
EXEMPT = "exempt"

#: (service name, method name) -> classification. check_rpc_registry
#: verifies this table covers every bound method and carries no stale
#: rows, so it IS the registry.
ENFORCEMENT: Dict[Tuple[str, str], str] = {
    # -- StorageSerde (enforced in-service: craq._admit_read/_admit_write
    #    charge the tenant buckets with true payload sizes) --------------
    ("StorageSerde", "write"): BYTES,
    ("StorageSerde", "update"): BYTES,       # chain-internal: head charged
    ("StorageSerde", "read"): BYTES,
    ("StorageSerde", "dumpChunkMeta"): EXEMPT,
    ("StorageSerde", "syncDone"): EXEMPT,
    ("StorageSerde", "removeChunk"): IOPS,
    ("StorageSerde", "removeFileChunks"): IOPS,
    ("StorageSerde", "queryLastChunk"): IOPS,
    ("StorageSerde", "truncateChunks"): IOPS,
    ("StorageSerde", "spaceInfo"): EXEMPT,
    ("StorageSerde", "batchRead"): BYTES,
    ("StorageSerde", "batchWrite"): BYTES,
    ("StorageSerde", "writeShard"): BYTES,
    ("StorageSerde", "batchWriteShard"): BYTES,
    ("StorageSerde", "batchUpdate"): BYTES,  # chain-internal: head charged
    ("StorageSerde", "statChunks"): IOPS,
    ("StorageSerde", "pruneClientChannels"): EXEMPT,
    ("StorageSerde", "offlineTarget"): EXEMPT,
    # EC recovery reads go through the byte-charging read gate, which
    # skips tenant buckets for background classes (system work)
    ("StorageSerde", "readRebuild"): BYTES,
    ("StorageSerde", "dumpPendingChunkMeta"): EXEMPT,
    ("StorageSerde", "batchReadRebuild"): BYTES,
    # chain-encode: the head hop charges the whole batch; chain-internal
    # hops pass free like update/batchUpdate (charged at entry)
    ("StorageSerde", "chainEncodeWrite"): BYTES,
    # -- MetaSerde (enforced at RPC dispatch: iops buckets) ---------------
    ("MetaSerde", "statFs"): IOPS,
    ("MetaSerde", "stat"): IOPS,
    ("MetaSerde", "create"): IOPS,
    ("MetaSerde", "mkdirs"): IOPS,
    ("MetaSerde", "symlink"): IOPS,
    ("MetaSerde", "hardLink"): IOPS,
    ("MetaSerde", "remove"): IOPS,
    ("MetaSerde", "open"): IOPS,
    ("MetaSerde", "sync"): IOPS,
    ("MetaSerde", "close"): IOPS,
    ("MetaSerde", "rename"): IOPS,
    ("MetaSerde", "list"): IOPS,
    ("MetaSerde", "truncate"): IOPS,
    ("MetaSerde", "getRealPath"): IOPS,
    ("MetaSerde", "setAttr"): IOPS,
    ("MetaSerde", "pruneSession"): EXEMPT,
    ("MetaSerde", "batchStat"): IOPS,
    ("MetaSerde", "authenticate"): EXEMPT,   # the op that NAMES a tenant
    ("MetaSerde", "setXattr"): IOPS,
    ("MetaSerde", "getXattr"): IOPS,
    ("MetaSerde", "listXattrs"): IOPS,
    ("MetaSerde", "removeXattr"): IOPS,
    ("MetaSerde", "batchClose"): IOPS,
    ("MetaSerde", "batchSetAttr"): IOPS,
    ("MetaSerde", "batchCreate"): IOPS,
    ("MetaSerde", "batchMkdirs"): IOPS,
    # two-phase participant plane (tpu3fs/metashard): server-to-server
    # internals riding the coordinator's already-charged op — like chain
    # forwarding, charging them again would double-bill the rename
    ("MetaSerde", "renamePrepare"): EXEMPT,
    ("MetaSerde", "renameFinish"): EXEMPT,
    ("MetaSerde", "renameResolve"): EXEMPT,
    # -- Usrbio ring registration: control plane (the data plane rides
    #    StorageSerde methods, which keep their bytes/iops classification
    #    and are charged at ring dequeue through dispatch_packet) --------
    ("Usrbio", "usrbioHandshake"): EXEMPT,
    ("Usrbio", "usrbioRegister"): EXEMPT,
    ("Usrbio", "usrbioDeregister"): EXEMPT,
    # -- Mgmtd / Core / Kv / internals: control plane ---------------------
    ("Mgmtd", "heartbeat"): EXEMPT,
    ("Mgmtd", "getRoutingInfo"): EXEMPT,
    ("Mgmtd", "registerNode"): EXEMPT,
    ("Mgmtd", "createTarget"): EXEMPT,
    ("Mgmtd", "uploadChain"): EXEMPT,
    ("Mgmtd", "uploadChainTable"): EXEMPT,
    ("Mgmtd", "setConfig"): EXEMPT,
    ("Mgmtd", "getConfig"): EXEMPT,
    ("Mgmtd", "tick"): EXEMPT,
    # elasticity / migration control plane: operator + worker traffic;
    # the DATA the workers move is charged/classified where it flows
    # (StorageSerde methods under the migration/ec_rebuild classes,
    # which are BACKGROUND — system work, never tenant-charged)
    ("Mgmtd", "addChainTarget"): EXEMPT,
    ("Mgmtd", "dropChainTarget"): EXEMPT,
    ("Mgmtd", "setNodeTags"): EXEMPT,
    ("Mgmtd", "migrationSubmit"): EXEMPT,
    ("Mgmtd", "migrationList"): EXEMPT,
    ("Mgmtd", "migrationClaim"): EXEMPT,
    ("Mgmtd", "migrationReport"): EXEMPT,
    ("Mgmtd", "servingRegister"): EXEMPT,
    ("Mgmtd", "servingUnregister"): EXEMPT,
    ("Core", "echo"): EXEMPT,
    ("Core", "renderConfig"): EXEMPT,
    ("Core", "hotUpdateConfig"): EXEMPT,
    ("Core", "shutdown"): EXEMPT,
    ("Core", "getConfig"): EXEMPT,
    ("Core", "getLastConfigUpdateRecord"): EXEMPT,
    ("Core", "flightDump"): EXEMPT,
    ("Kv", "snapshot"): EXEMPT,
    ("Kv", "get"): EXEMPT,
    ("Kv", "getRange"): EXEMPT,
    ("Kv", "commit"): EXEMPT,
    ("Kv", "release"): EXEMPT,
    ("KvRepl", "appendEntries"): EXEMPT,
    ("KvRepl", "requestVote"): EXEMPT,
    ("KvRepl", "installSnapshot"): EXEMPT,
    ("KvRepl", "status"): EXEMPT,
    ("KvRepl", "reconfig"): EXEMPT,
    ("MonitorCollector", "write"): EXEMPT,   # every binary's own push loop
    ("MonitorCollector", "query"): EXEMPT,
    ("MonitorCollector", "aggQuery"): EXEMPT,   # operator/SLO surface
    ("MonitorCollector", "sloStatus"): EXEMPT,
    # -- SimpleExample ----------------------------------------------------
    ("SimpleExample", "write"): BYTES,
    ("SimpleExample", "read"): BYTES,
    # -- Serving (fleet KVCache peer-fill, tpu3fs/serving) ----------------
    # peerRead dispatch charges IOPS only: the REQUESTER charges the
    # peer-filled payload bytes against its own tenant with the true
    # size (FleetKVCache._admit_peer_bytes, ops+bytes+resident gate), so
    # every byte is charged exactly once and a peer fill can never
    # launder a tenant's bytes through another process's quota.
    ("Serving", "peerRead"): IOPS,
    ("Serving", "fillClaim"): EXEMPT,       # fill-intent lease, tiny frames
    ("Serving", "fillRelease"): EXEMPT,
    ("Serving", "servingStats"): EXEMPT,
    # bench/driver workload surface: the cache ops it runs charge
    # through the normal kvcache client paths underneath
    ("Serving", "servingLoad"): EXEMPT,
}


def enforcement_of(service: str, method: str) -> Optional[str]:
    """Classification for one bound method, or None when unclassified
    (which the static registry check turns into a CI failure)."""
    return ENFORCEMENT.get((service, method))


def quota_enforced(service: str, method: str) -> bool:
    return ENFORCEMENT.get((service, method)) in (BYTES, IOPS)
