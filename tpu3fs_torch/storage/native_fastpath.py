"""Wire the native transport's storage fast paths to a service.

The port's own copy of ``tpu3fs/storage/native_fastpath.py``. Every
function pointer handed to the transport (the engine bridge) is taken from
the port's own engine library (``hostbuild``), never from another loaded
copy of the same C ABI (the JAX package's ``native/*.so`` may share the
process, each loaded ``RTLD_LOCAL``).

The C++ transport (hostsrc/rpc_net.cpp) can serve StorageSerde.batchRead
and single target-addressed reads end to end — decode, chunk-engine
read, encode, writev — without ever entering Python, IF it knows which targets are native-engined and
currently readable. This module maintains that registry from the Python
side, where the authoritative state (routing snapshots, local target
states) lives.

The registry is a positive allowlist rebuilt on every call: a target is
registered only while it (a) runs the native chunk engine, (b) is
locally UPTODATE, and (c) is publicly readable in the current routing
snapshot of its chain. Everything else is dropped, and any op the C++
side cannot match exactly falls back to the Python dispatch — so a stale
registry entry can at worst serve committed bytes from a replica that
routing just demoted, the same window the Python path has between two
routing polls. The storage app calls sync_read_fastpath() from its
target-scan loop (bin/storage_main.py), bounding that window to
one scan interval.

WRITE PATHS (ABI v5): three more registries ride the same sync —

- the TAIL write-chain registry (chain-internal batchUpdate served as
  one stage+commit engine crossing);
- the HEAD chain registry: client-entry ``write``/``batchWrite`` decoded,
  admission/tenant-gated, engine-staged with CRC32C, chain-forwarded to
  the successor over a pooled C connection, checksum cross-checked and
  committed — all by the GIL-free C++ workers. Python dispatch stays the
  conservative fallback, selected per-request exactly like the read fast
  path falls back today (SYNCING successors, version skew, duplicate
  chunks, KVCACHE-class writes, near-full creates);
- the shared exactly-once channel table + per-chunk interlock: when a
  head chain registers, the service's Python ``_ChannelTable`` is
  swapped for the C-side table (``NativeChannelTable``) and the Python
  write paths additionally take the C chunk locks, so a retry replayed
  across the fast-path/fallback boundary still applies exactly once and
  a native-served and a fallback-served write to one chunk can never
  interleave between stage and commit.

Head eligibility is strict on purpose: CR chain (not EC), every member
SERVING, the local target IS the head, no other writer-chain member
local (the forward must leave the node — a local successor would
re-enter locks the C worker holds), no ICI replicator, and the
successor's node resolvable to a host:port. ``TPU3FS_NATIVE_WRITE=0``
is the A/B lever (byte-identity harness, benches). While the cluster
fault plane carries a rule that could fire on this node's Python write
path, head serving stands down for the sync interval — the C workers
cannot evaluate plane rules per request, and a chaos schedule that
arms ``storage.update`` must keep injecting.

Ref: the reference's read AND write paths are native end to end by
construction (src/storage/service/StorageOperator.cc + AioReadWorker.h,
UpdateWorker.h); this is the same property, recovered via fn-pointer
bridges between the two .so's.
"""

from __future__ import annotations

import ctypes
import os

from tpu3fs_torch.mgmtd.types import LocalTargetState, PublicTargetState

#: StorageSerde methods the C++ transport may serve below Python, with
#: the wire method id the C side hardcodes for each
#: (the JAX package's tools/check_rpc_registry.py check 10 round-trips
#: its copy of this table against the bound tables and the
#: QoS/idempotency/tenant classifications).
NATIVE_SERVED_METHODS = {
    "read": 3,
    "batchRead": 11,
    "write": 1,
    "batchWrite": 12,
    "batchUpdate": 15,
}

#: fault points a plane rule could fire on the PYTHON write path; any
#: matching armed rule stands the native head path down (see module doc)
_WRITE_FAULT_POINTS = (
    "storage.update",
    "rpc.dispatch.StorageSerde.write",
    "rpc.dispatch.StorageSerde.batchWrite",
)


def native_write_enabled() -> bool:
    """The A/B lever: TPU3FS_NATIVE_WRITE=0 keeps head writes on the
    Python dispatch (read every sync, so flipping mid-run takes effect
    at the next target scan)."""
    return os.environ.get("TPU3FS_NATIVE_WRITE", "1") != "0"


def _native_engine_handle(target):
    """(ce_open handle, the port's engine library) when this target runs
    the port's native engine, else (None, None): the bridge's function
    pointers and handles come from one library, the port's own."""
    from tpu3fs_torch.storage.native_engine import NativeChunkEngine

    eng = getattr(target, "engine", None)
    if isinstance(eng, NativeChunkEngine) and eng._h:
        return eng._h, eng._lib
    return None, None


def _write_faults_armed(node_id: int) -> bool:
    """True while the cluster fault plane holds a rule that could fire on
    this node's Python write path."""
    from tpu3fs_torch.utils.fault_injection import plane

    for r in plane().snapshot():
        if r["node"] not in (0, node_id):
            continue
        if r["times"] >= 0 and r["fired"] >= r["times"]:
            continue  # exhausted rule cannot fire again
        if any(p.startswith(r["point"]) for p in _WRITE_FAULT_POINTS):
            return True
    return False


class NativeChannelTable:
    """craq._ChannelTable facade over the C transport's shared slot table.

    ONE table serves both paths: the native head workers consult it below
    the GIL and the Python dispatch consults the same slots through these
    wrappers, so a client retry replayed across the fast-path/fallback
    boundary still deduplicates. Replies are stored as their serde
    encoding — exactly the bytes the C fast path splices into its batch
    replies — and decoded back on a Python-side hit."""

    def __init__(self, server):
        self._server = server

    def check(self, req):
        from tpu3fs_torch.rpc.serde import deserialize
        from tpu3fs_torch.storage.craq import UpdateReply
        from tpu3fs_torch.utils.result import Code

        if not req.client_id or req.channel_id == 0:
            return None
        rc, blob = self._server.chan_check(
            req.client_id, req.channel_id, req.seqnum)
        if rc == 1:
            return deserialize(blob, UpdateReply)
        if rc == 2:
            return UpdateReply(Code.CHUNK_STALE_UPDATE,
                               message="stale seqnum")
        return None

    def store(self, req, reply) -> None:
        from tpu3fs_torch.rpc.serde import serialize

        if not req.client_id or req.channel_id == 0:
            return
        self._server.chan_store(req.client_id, req.channel_id, req.seqnum,
                                serialize(reply))

    def prune_client(self, client_id: str) -> int:
        return self._server.chan_prune(client_id)

    def __len__(self) -> int:
        return self._server.chan_len()


class _WriteStatsBridge:
    """Publish the C-side fast-path counters into the monitor registry:
    each sync samples the monotonic totals and adds the delta, so ``admin_cli
    top``/the collector see the native paths next to the Python recorders.
    The port publishes the read path's hits and fallbacks too
    (``fastpath.read_served``, ``fastpath.read_fallbacks``), which the JAX
    package's bridge leaves out."""

    def __init__(self, node_id: int):
        from tpu3fs_torch.monitor.recorder import CounterRecorder

        tags = {"node": str(node_id)}
        self._recs = [CounterRecorder(name, tags) for name in (
            "fastpath.write_served", "fastpath.write_fallbacks",
            "fastpath.forward_us", "fastpath.read_served",
            "fastpath.read_fallbacks")]
        self._last = (0,) * len(self._recs)

    def publish(self, server) -> None:
        cur = server.fastpath_write_stats() + server.fastpath_stats()
        last, self._last = self._last, cur
        for rec, c, p in zip(self._recs, cur, last):
            if c > p:
                rec.add(c - p)


def install_native_channels(svc, server) -> None:
    """Swap the service's Python channel table for the shared C table,
    migrating live slots so retries in flight across the swap still
    dedupe (the Python table is in-memory too, so this loses nothing a
    process restart wouldn't)."""
    from tpu3fs_torch.rpc.serde import serialize

    cur = svc._channels
    if isinstance(cur, NativeChannelTable):
        return
    for client_id, channel_id, seq, reply in cur.snapshot_slots():
        server.chan_store(client_id, channel_id, seq, serialize(reply))
    svc._channels = NativeChannelTable(server)


def _head_chain_entry(svc, routing, chain, target, h):
    """The fastpath_sync_head registry tuple for an eligible head chain,
    or None (see module doc for the eligibility rules)."""
    if chain.is_ec or svc._ici is not None:
        return None
    if not chain.targets or not all(
            t.public_state == PublicTargetState.SERVING
            for t in chain.targets):
        return None
    if chain.targets[0].target_id != target.target_id:
        return None  # not the head
    local_ids = {t.target_id for t in svc.targets()}
    if any(t.target_id in local_ids for t in chain.targets[1:]):
        return None  # forward would re-enter this node
    succ_host, succ_port = "", 0
    if len(chain.targets) > 1:
        node = routing.node_of_target(chain.targets[1].target_id)
        if node is None or not node.host:
            return None  # successor unroutable: Python ladder handles it
        succ_host, succ_port = node.host, int(node.port)
    return (h, target.target_id, chain.chain_version, target.chunk_size,
            bool(getattr(target, "reject_create", False)),
            succ_host, succ_port)


def _sync_head(server, svc, wanted_head: dict, lib) -> int:
    """Install the head-chain registry + the cross-path seams (channel
    table swap, chunk-lock interlock, skip-crc planted-bug arm)."""
    from tpu3fs_torch.chaos.bugs import bug_fire

    # planted chaos bug native_commit_skip_crc (chaos/bugs.py):
    # synced every scan so the chaos drive's arm/disarm takes effect
    server.fastpath_set_skip_crc(bug_fire("native_commit_skip_crc"))
    if wanted_head and (not native_write_enabled()
                        or _write_faults_armed(svc.node_id)
                        or svc.stopped):
        wanted_head = {}
    stage_fn = commit_fn = None
    if wanted_head and lib is not None:
        stage_fn = ctypes.cast(lib.ce_batch_update, ctypes.c_void_p)
        commit_fn = ctypes.cast(lib.ce_batch_commit, ctypes.c_void_p)
    else:
        wanted_head = {}
    if wanted_head:
        # seams BEFORE enabling: from the first native-served write, the
        # Python paths must already share the channel table + interlock
        svc._native_lock_fns = (server.chunk_lock, server.chunk_unlock)
        install_native_channels(svc, server)
        # interlock for the union while the old registry drains, exact
        # set once the new one is live (dropping a chain from the Python
        # interlock while a C worker still serves it would race)
        prev = svc._native_write_chains
        svc._native_write_chains = frozenset(prev | set(wanted_head))
    server.fastpath_sync_head(stage_fn, commit_fn, wanted_head)
    svc._native_write_chains = frozenset(wanted_head)
    bridge = getattr(svc, "_native_write_stats", None)
    if bridge is None:
        bridge = svc._native_write_stats = _WriteStatsBridge(svc.node_id)
    bridge.publish(server)
    return len(wanted_head)


def sync_read_fastpath(server, svc) -> int:
    """Rebuild `server`'s fast-path registry from `svc`'s current state;
    -> number of registered targets (0 when the server has no fast path,
    e.g. the Python transport)."""
    if getattr(server, "fastpath_sync", None) is None:
        return 0
    try:
        routing = svc._routing()
    except Exception:
        routing = None
    wanted = {}
    wanted_write = {}
    wanted_head = {}
    batch_read_fn = None
    batch_write_fn = None
    head_lib = None
    local_ids = {t.target_id for t in svc.targets()}
    for target in svc.targets():
        h, lib = _native_engine_handle(target)
        if h is None:
            continue
        if target.local_state != LocalTargetState.UPTODATE:
            continue
        chain = routing.chains.get(target.chain_id) if routing else None
        if chain is None:
            continue
        ct = next((t for t in chain.targets
                   if t.target_id == target.target_id), None)
        if ct is None or not ct.public_state.can_read:
            continue
        wanted[target.target_id] = (h, target.chain_id, target.chunk_size)
        if batch_read_fn is None:
            batch_read_fn = ctypes.cast(lib.ce_batch_read, ctypes.c_void_p)
            batch_write_fn = ctypes.cast(lib.ce_batch_write,
                                         ctypes.c_void_p)
            head_lib = lib
        # write-chain registration (the chain-internal batchUpdate hop):
        # this target must be the TAIL of a fully-SERVING CR chain, and no
        # earlier writer-chain member may be local (the Python dispatch
        # picks the FIRST local writer — the fast path must answer for
        # exactly the target Python would have picked). Any SYNCING member
        # changes forward semantics (full-replace installs), so those
        # chains stay on the Python path entirely.
        if (not chain.is_ec
                and all(t.public_state == PublicTargetState.SERVING
                        for t in chain.targets)
                and chain.targets[-1].target_id == target.target_id
                and not any(t.target_id in local_ids
                            for t in chain.targets[:-1])):
            wanted_write[target.chain_id] = (
                h, target.target_id, chain.chain_version, target.chunk_size)
        # head-chain registration (client-entry write/batchWrite served
        # end to end in C: admission, stage+CRC, forward, cross-check,
        # commit); eligibility rules in the module doc
        entry = _head_chain_entry(svc, routing, chain, target, h)
        if entry is not None:
            wanted_head[target.chain_id] = entry
    server.fastpath_sync(batch_read_fn, wanted)
    if batch_write_fn is not None:
        server.fastpath_sync_write(batch_write_fn, wanted_write)
    _sync_head(server, svc, wanted_head, head_lib)
    # local offlining promises IMMEDIATE refusal (craq offline_target):
    # hand the service an invalidator so the C++ registry drops the
    # target in the same call, not at the next scan
    svc.set_fastpath_invalidator(
        lambda tid: (server.fastpath_del_target(tid)
                     if tid is not None else server.fastpath_sync(None, {})))
    return len(wanted)
