"""A storage tier built by hand, for the storage parity tests.

``Tier(pkg, ...)`` builds one package's storage services (the JAX
package's ``tpu3fs`` or the port's ``tpu3fs_torch``) over a hand-made
``RoutingInfo``, one target of each chain per node, wired by a
direct-dispatch messenger modelled on ``Fabric.send`` and marked
``in_process`` as the fabric is, so both packages take the same forward
paths. Both get the same node, target and chain ids, so ``run_sequence``,
one seeded request sequence, gives replies and stored bytes that can be
compared with tolerance 0.

The role of mgmtd is played by hand: ``fail_node`` offlines a node's
targets in routing, ``rejoin_node`` brings them back SYNCING (wiped or
stale), and ``promote_synced`` makes a target that got ``sync_done``
SERVING again; each bumps the routing and chain versions.
"""

from __future__ import annotations

import importlib
from dataclasses import replace

import numpy as np

FIRST_NODE = 10
FIRST_TARGET = 1000
CR_CHAIN = 900_001
EC_CHAIN = 900_002
# service methods whose payload is an argument tuple (Fabric.send)
_TUPLE_ARGS = {"stat_chunks", "remove_chunk", "remove_file_chunks",
               "query_last_chunk", "truncate_file_chunks"}
_METHODS = _TUPLE_ARGS | {
    "write", "write_shard", "update", "read", "read_rebuild",
    "batch_read_rebuild", "batch_read", "batch_write", "batch_update",
    "batch_write_shard", "chain_encode", "dump_chunkmeta",
    "dump_pending_chunkmeta", "sync_done"}


class Tier:
    in_process = True  # direct dispatch, as the fabric's messenger

    def __init__(self, pkg: str, nodes: int, chains, *, device=None):
        """``chains``: (chain_id, node indices, ec_k, ec_m, target chunk
        size) per chain; ``device`` goes to every service and target (the
        port only)."""
        self.pkg = pkg
        mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
        self.T = mod("mgmtd.types")
        self.craq = mod("storage.craq")
        self.types = mod("storage.types")
        self.result = mod("utils.result")
        self.resync = mod("storage.resync")
        self.ec_resync = mod("storage.ec_resync")
        self.target_mod = mod("storage.target")
        self.kw = {} if device is None else {"device": device}
        T = self.T
        self.routing = T.RoutingInfo(version=1)
        self.services = {}
        self.down = set()
        self.synced = set()
        for i in range(nodes):
            nid = FIRST_NODE + i
            self.routing.nodes[nid] = T.NodeInfo(
                nid, T.NodeType.STORAGE,
                status=T.NodeStatus.HEARTBEAT_CONNECTED)
            self.services[nid] = self.craq.StorageService(
                nid, lambda: self.routing, self.send, **self.kw)
        self.chunk_size = {}
        tid = FIRST_TARGET
        for chain_id, node_idx, k, m, chunk_size in chains:
            tids = []
            for ni in node_idx:
                nid = FIRST_NODE + ni
                self.routing.targets[tid] = T.TargetInfo(
                    tid, node_id=nid, chain_id=chain_id,
                    public_state=T.PublicTargetState.SERVING,
                    local_state=T.LocalTargetState.UPTODATE)
                self.services[nid].add_target(self.target_mod.StorageTarget(
                    tid, chain_id, chunk_size=chunk_size, **self.kw))
                tids.append(tid)
                tid += 1
            self.routing.chains[chain_id] = T.ChainInfo(
                chain_id, 1, [T.ChainTarget(t) for t in tids], list(tids),
                ec_k=k, ec_m=m)
            self.chunk_size[chain_id] = chunk_size

    # -- the messenger -----------------------------------------------------
    def send(self, node_id: int, method: str, payload):
        R = self.result
        if node_id in self.down or node_id not in self.services:
            raise R.FsError(R.Status(R.Code.RPC_CONNECT_FAILED,
                                     f"node {node_id} down"))
        if method not in _METHODS:
            raise R.FsError(R.Status(R.Code.RPC_METHOD_NOT_FOUND, method))
        if method == "sync_done":
            self.synced.add(payload)
        fn = getattr(self.services[node_id], method)
        return fn(*payload) if method in _TUPLE_ARGS else fn(payload)

    # -- mgmtd's part --------------------------------------------------------
    def node_of(self, target_id: int) -> int:
        return self.routing.targets[target_id].node_id

    def service_of(self, target_id: int):
        return self.services[self.node_of(target_id)]

    def _set_state(self, target_id: int, state) -> None:
        info = self.routing.targets[target_id]
        info.public_state = state
        chain = self.routing.chains[info.chain_id]
        ct = next(t for t in chain.targets if t.target_id == target_id)
        ct.public_state = state
        if state != self.T.PublicTargetState.SERVING:
            # a failed or recovering member goes to the chain's end
            chain.targets.remove(ct)
            chain.targets.append(ct)
        chain.chain_version += 1
        self.routing.version += 1

    def fail_node(self, node_id: int) -> None:
        self.down.add(node_id)
        for tid, info in self.routing.targets.items():
            if info.node_id == node_id:
                self._set_state(tid, self.T.PublicTargetState.OFFLINE)

    def rejoin_node(self, node_id: int, wipe: bool) -> None:
        """The node is back; ``wipe`` gives its targets empty engines (a
        replaced disk). Its targets are SYNCING until promoted."""
        self.down.discard(node_id)
        svc = self.services[node_id]
        for tid, info in self.routing.targets.items():
            if info.node_id != node_id:
                continue
            if wipe:
                old = svc.drop_target(tid)
                svc.add_target(self.target_mod.StorageTarget(
                    tid, old.chain_id, chunk_size=old.chunk_size, **self.kw))
            self._set_state(tid, self.T.PublicTargetState.SYNCING)

    def promote_synced(self) -> list:
        done = sorted(self.synced)
        for tid in done:
            self._set_state(tid, self.T.PublicTargetState.SERVING)
        self.synced.clear()
        return done

    def chain(self, chain_id: int):
        return self.routing.chains[chain_id]

    def close(self) -> None:
        for svc in self.services.values():
            svc.stop_workers()

    # -- what the tier holds -------------------------------------------------
    def stored(self) -> dict:
        """target id -> [(chunk id, committed ver, pending ver, length,
        checksum, pending length, pending checksum, aux, committed
        bytes)], every target of every node."""
        out = {}
        for svc in self.services.values():
            for target in svc.targets():
                eng = target.engine
                rows = []
                for meta in eng.all_metadata():
                    data = (eng.read(meta.chunk_id)
                            if meta.committed_ver else b"")
                    rows.append((
                        (meta.chunk_id.file_id, meta.chunk_id.index),
                        meta.committed_ver, meta.pending_ver, meta.length,
                        meta.checksum.value, meta.pending_length,
                        meta.pending_checksum.value, meta.aux, data))
                out[target.target_id] = rows
        return out


def _reply(r) -> tuple:
    """The comparable fields of an UpdateReply or ReadReply."""
    fields = [int(r.code), getattr(r, "update_ver", 0), r.commit_ver,
              r.checksum.value, r.checksum.length]
    if hasattr(r, "data"):
        fields.append(bytes(r.data))
    return tuple(fields)


def payloads(rng, n: int, size: int, step: int) -> list:
    """n random payloads of size, size - step - 1, ... bytes (at least 1)."""
    return [rng.integers(0, 256, max(1, size - step * i - (i > 0)),
                         dtype=np.uint8).tobytes() for i in range(n)]


# -- EC client steps (the JAX client's write_stripes, by hand) ---------------
def write_stripes(tier, codec, items, ver: int, *, chain_encode: bool):
    """Stage every shard of each (chunk id, data) stripe (phase 1), through
    ``chain_encode`` to shard 0's node or client-encoded through
    ``batch_write_shard`` per node, then commit (phase 2). -> the comparable
    replies of both rounds."""
    craq = tier.craq
    chain = tier.chain(EC_CHAIN)
    k, m, S = chain.ec_k, chain.ec_m, codec.shard_size
    width = k + m
    targets = [chain.target_of_shard(j).target_id for j in range(width)]
    reqs = []
    if chain_encode:
        for cid, data in items:
            for j in range(width):
                reqs.append(craq.ShardWriteReq(
                    chain_id=EC_CHAIN, chain_ver=chain.chain_version,
                    target_id=targets[j], chunk_id=cid,
                    data=data[j * S:(j + 1) * S] if j < k else b"", crc=-1,
                    update_ver=ver, chunk_size=S, logical_len=len(data),
                    phase=1))
        staged = tier.send(tier.node_of(targets[0]), "chain_encode", reqs)
    else:
        buf = np.zeros((len(items), k, S), dtype=np.uint8)
        for b, (_, data) in enumerate(items):
            buf[b].reshape(-1)[:len(data)] = np.frombuffer(data, np.uint8)
        parity, crcs = codec.encode_parity(buf)
        for b, (cid, data) in enumerate(items):
            for j in range(width):
                payload = (data[j * S:(j + 1) * S] if j < k
                           else parity[b, j - k].tobytes())
                crc = (int(crcs[b, j]) if len(payload) == S
                       else codec.crc_host(payload))
                reqs.append(craq.ShardWriteReq(
                    chain_id=EC_CHAIN, chain_ver=chain.chain_version,
                    target_id=targets[j], chunk_id=cid, data=payload,
                    crc=crc, update_ver=ver, chunk_size=S,
                    logical_len=len(data), phase=1))
        staged = _by_node(tier, reqs)
    commits = _by_node(tier, [replace(r, data=b"", crc=0, phase=2)
                              for r in reqs])
    return [_reply(r) for r in staged + commits]


def _by_node(tier, reqs) -> list:
    """batch_write_shard to each request's node; replies in request order."""
    by_node = {}
    for i, r in enumerate(reqs):
        by_node.setdefault(tier.node_of(r.target_id), []).append(i)
    out = [None] * len(reqs)
    for nid, idxs in by_node.items():
        for i, rep in zip(idxs, tier.send(nid, "batch_write_shard",
                                          [reqs[i] for i in idxs])):
            out[i] = rep
    return out


def read_stripe(tier, codec, cid) -> bytes:
    """A client's degraded read: the first k SERVING shards, read from
    their targets, and the lost data shards decoded with ``codec``."""
    craq = tier.craq
    chain = tier.chain(EC_CHAIN)
    k, S = chain.ec_k, codec.shard_size
    shards, logical = {}, 0
    for j in range(k + chain.ec_m):
        t = chain.target_of_shard(j)
        if len(shards) == k or not t.public_state.can_read:
            continue
        r = tier.service_of(t.target_id).read(craq.ReadReq(
            EC_CHAIN, cid, 0, -1, t.target_id, chunk_size=S))
        assert r.ok, (j, r.code)
        shards[j] = bytes(r.data)
        logical = max(logical, r.logical_len)
    present = sorted(shards)
    lost = [j for j in range(k) if j not in shards]
    data = {j: shards[j].ljust(S, b"\x00") for j in present if j < k}
    if lost:
        surv = np.stack([np.frombuffer(shards[j].ljust(S, b"\x00"), np.uint8)
                         for j in present])[None]
        rebuilt = codec.reconstruct_batch(present, lost, surv)
        for row, j in enumerate(lost):
            data[j] = rebuilt[0, row].tobytes()
    return b"".join(data[j] for j in range(k))[:logical]


# -- the seeded sequence -------------------------------------------------------
def run_sequence(tier, codec, *, seed: int, cr_chunks: int, stripes: int):
    """CR writes with partial overwrites, reads from every replica, EC
    client-encoded and chain-encoded writes, a degraded read with one data
    and one parity target down, the EC rebuild of the data target, the CR
    resync of a re-joined target, and the file-level query, truncate and
    remove calls. -> (record of every reply and read, the data written per
    chunk id)."""
    craq, ChunkId = tier.craq, tier.types.ChunkId
    rng = np.random.default_rng(seed)
    rec = []
    cr = tier.chain(CR_CHAIN)
    cs = tier.chunk_size[CR_CHAIN]
    head = tier.services[tier.node_of(cr.head().target_id)]

    def cr_write(items, seq0):
        reqs = [craq.WriteReq(
            CR_CHAIN, tier.chain(CR_CHAIN).chain_version, cid, off, data, cs,
            client_id="parity", channel_id=1 + i, seqnum=seq0)
            for i, (cid, off, data) in enumerate(items)]
        return [_reply(r) for r in head.batch_write(reqs)]

    # 1. CR: whole chunks, then partial overwrites of every other chunk
    want = {}
    items = []
    for i, data in enumerate(payloads(rng, cr_chunks, cs, 97)):
        cid = ChunkId(7, i)
        items.append((cid, 0, data))
        want[cid] = bytearray(data)
    rec.append(("cr.write", cr_write(items, 1)))
    items = []
    for i in range(0, cr_chunks, 2):
        cid = ChunkId(7, i)
        off = int(rng.integers(0, len(want[cid])))
        data = rng.integers(0, 256, int(rng.integers(1, cs - off + 1)),
                            dtype=np.uint8).tobytes()
        items.append((cid, off, data))
        buf = want[cid]
        buf.extend(b"\x00" * max(0, off + len(data) - len(buf)))
        buf[off:off + len(data)] = data
    rec.append(("cr.overwrite", cr_write(items, 2)))
    for t in cr.targets:
        got = [tier.service_of(t.target_id).read(craq.ReadReq(
            CR_CHAIN, cid, 0, -1, t.target_id)) for cid in want]
        assert all(r.ok and bytes(r.data) == want[cid]
                   for r, cid in zip(got, want)), t.target_id
        rec.append(("cr.read", t.target_id, [_reply(r) for r in got]))
    rec.append(("cr.batch_read", [_reply(r) for r in head.batch_read(
        [craq.ReadReq(CR_CHAIN, cid, 1, 100) for cid in want])]))

    # 2-3. EC: client-encoded stripes, then chain-encoded ones
    S = codec.shard_size
    ec = tier.chain(EC_CHAIN)
    k = ec.ec_k
    stripes_in = {}
    enc = [(ChunkId(8, i), d)
           for i, d in enumerate(payloads(rng, stripes, k * S, S // 3))]
    rec.append(("ec.write_shard", write_stripes(tier, codec, enc, 1,
                                                chain_encode=False)))
    ce = [(ChunkId(9, i), d)
          for i, d in enumerate(payloads(rng, stripes, k * S, S // 3))]
    rec.append(("ec.chain_encode", write_stripes(tier, codec, ce, 1,
                                                 chain_encode=True)))
    stripes_in.update(enc + ce)

    # 4. degraded read: data shard 1 and the first parity shard down
    data_t = ec.target_of_shard(1).target_id
    parity_t = ec.target_of_shard(k).target_id
    before = tier.stored()[data_t]
    tier.fail_node(tier.node_of(data_t))
    tier.fail_node(tier.node_of(parity_t))
    for cid, data in stripes_in.items():
        got = read_stripe(tier, codec, cid)
        assert got == data, cid
        rec.append(("ec.degraded_read", (cid.file_id, cid.index), got))

    # 5. EC rebuild of the data target onto an empty engine
    tier.rejoin_node(tier.node_of(data_t), wipe=True)
    coordinator = tier.chain(EC_CHAIN).serving_targets()[0].target_id
    worker = tier.ec_resync.EcResyncWorker(
        tier.service_of(coordinator), tier.send, batch_stripes=8, **tier.kw)
    rec.append(("ec.rebuild", worker.run_once(), tier.promote_synced()))
    assert tier.stored()[data_t] == before, "rebuilt shards differ"

    # 6. CR resync: the tail misses a round of writes, then re-joins
    tail = cr.targets[-1].target_id
    tier.fail_node(tier.node_of(tail))
    items = []
    for i in range(1, cr_chunks, 2):
        cid = ChunkId(7, i)
        data = rng.integers(0, 256, cs, dtype=np.uint8).tobytes()
        items.append((cid, 0, data))
        want[cid] = bytearray(data)
    rec.append(("cr.write_degraded", cr_write(items, 3)))
    tier.rejoin_node(tier.node_of(tail), wipe=False)
    moved = sum(tier.resync.ResyncWorker(svc, tier.send).run_once()
                for nid, svc in sorted(tier.services.items())
                if nid not in tier.down)
    rec.append(("cr.resync", moved, tier.promote_synced()))
    got = [tier.service_of(tail).read(craq.ReadReq(CR_CHAIN, cid, 0, -1, tail))
           for cid in want]
    assert all(r.ok and bytes(r.data) == want[cid]
               for r, cid in zip(got, want)), "resynced target differs"
    rec.append(("cr.read_resynced", [_reply(r) for r in got]))

    # 7. file-level calls: query, truncate, remove
    rec.append(("cr.query", head.query_last_chunk(CR_CHAIN, 7)))
    rec.append(("cr.truncate", head.truncate_file_chunks(CR_CHAIN, 7, 2, 5)))
    rec.append(("cr.query", head.query_last_chunk(CR_CHAIN, 7)))
    rec.append(("cr.remove", head.remove_file_chunks(CR_CHAIN, 7)))
    rec.append(("cr.query", head.query_last_chunk(CR_CHAIN, 7)))
    return rec, stripes_in
