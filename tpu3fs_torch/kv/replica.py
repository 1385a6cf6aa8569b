"""Replicated kvd: fault tolerance for the FoundationDB role.

The port's own copy of ``tpu3fs/kv/replica.py``, unchanged but for its
imports.

The reference inherits replicated, failover-capable transactions from
FoundationDB (ref src/fdb/FDBTransaction.h,
HybridKvEngine.h:12-22). A single-process kvd with a WAL (kv/service.py) is
a single point of failure under the lease election, routing, and all
metadata. This module adds the missing property: a kvd GROUP of N peers
with one elected leader, where a transaction is acknowledged only after
its resolved write set is durable on a MAJORITY, and any future leader
provably holds every acknowledged transaction.

The protocol is Raft's core (terms, log-completeness voting, quorum
commit, a no-op barrier entry per new term), deliberately without
membership changes:

- LOG: entries (term, index, payload) where payload is the serialized
  resolved write set (kv.service.WalRecord — versionstamps already
  expanded), appended to a per-node log file BEFORE acking the leader.
- COMMIT PATH (leader, fully serialized): conflict-check + apply on the
  leader engine -> append entry -> replicate -> wait majority -> ack the
  client. If quorum cannot be reached the leader steps down and REBUILDS
  its engine from the durable prefix, so the un-replicated application is
  discarded and the client (never acked) retries on the next leader.
  Serializing snapshot() behind the same lock means no client can observe
  engine state that is not yet quorum-durable.
- ELECTION: a candidate wins only if its (last_term, last_index) is >= the
  voter's for a majority — the standard argument makes every acknowledged
  entry present in the winner's log. The winner replays its log into a
  fresh engine, appends a no-op entry of its own term, and serves only
  after that barrier replicates (the figure-8 guard).
- SNAPSHOT/COMPACTION: when the log exceeds a threshold, the leader dumps
  the applied engine state, persists it, and truncates the log prefix;
  followers too far behind receive installSnapshot. Mirrors the kvd WAL's
  snapshot compaction (kv/service.py).

Followers reject client ops with KV_NOT_PRIMARY + a leader hint; the
client (kv/remote.py ReplicatedRemoteKVEngine) re-resolves and retries,
and with_transaction treats it as one more retriable code.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from tpu3fs_torch.kv.mem import MemKVEngine
from tpu3fs_torch.utils.logging import xlog
from tpu3fs_torch.kv.service import (
    CommitReq,
    CommitRsp,
    EmptyMsg,
    GetReq,
    KvService,
    RangePair,
    RangeReq,
    ReleaseReq,
    SnapshotReq,
    SnapshotRsp,
    WalRecord,
    WriteEntry,
    RangeEntry,
)
from tpu3fs_torch.rpc.net import RpcClient, RpcServer, ServiceDef
from tpu3fs_torch.rpc.serde import deserialize, serialize
from tpu3fs_torch.utils.result import Code, FsError, Status

KV_REPL_SERVICE_ID = 6

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"


# -- wire schemas ------------------------------------------------------------

@dataclass
class LogEntry:
    term: int = 0
    index: int = 0
    payload: bytes = b""     # serialized WalRecord; b"" = no-op barrier
    # non-empty = membership entry: JSON {node_id: [host, port], ...}.
    # Activated at APPEND time on every replica (Raft's single-server
    # change, dissertation §4.2.2): because each reconfig adds OR removes
    # at most one node, any majority of the old config overlaps any
    # majority of the new one, so two leaders can never be elected for
    # the same term across the boundary — no joint consensus needed.
    config: str = ""


@dataclass
class AppendReq:
    term: int = 0
    leader_id: int = 0
    prev_index: int = 0
    prev_term: int = 0
    entries: List[LogEntry] = field(default_factory=list)
    commit_index: int = 0


@dataclass
class AppendRsp:
    term: int = 0
    ok: bool = False
    match_index: int = 0


@dataclass
class VoteReq:
    term: int = 0
    candidate_id: int = 0
    last_log_index: int = 0
    last_log_term: int = 0


@dataclass
class VoteRsp:
    term: int = 0
    granted: bool = False


@dataclass
class SnapInstallReq:
    term: int = 0
    leader_id: int = 0
    last_index: int = 0
    last_term: int = 0
    engine_version: int = 0
    pairs: List[RangePair] = field(default_factory=list)
    # membership active at the snapshot point (config entries may have
    # been compacted out of the log)
    peers_json: str = ""


@dataclass
class SnapInstallRsp:
    term: int = 0
    ok: bool = False


@dataclass
class ReconfigReq:
    peers_json: str = ""     # the COMPLETE new map {node_id: [host, port]}


@dataclass
class ReconfigRsp:
    ok: bool = False
    term: int = 0
    index: int = 0
    message: str = ""


@dataclass
class StatusReq:
    pass


@dataclass
class StatusRsp:
    node_id: int = 0
    role: str = ""
    term: int = 0
    leader_id: int = 0
    last_index: int = 0
    commit_index: int = 0
    engine_version: int = 0
    peers_json: str = ""


class ReplicatedKvService:
    """One member of a kvd replication group."""

    def __init__(
        self,
        node_id: int,
        peers: Dict[int, Tuple[str, int]],
        *,
        data_dir: Optional[str] = None,
        election_timeout_s: Tuple[float, float] = (0.8, 1.6),
        heartbeat_s: float = 0.25,
        compact_entries: int = 100_000,
        fsync: bool = False,
        rpc_client: Optional[RpcClient] = None,
    ):
        self.node_id = node_id
        self.peers = dict(peers)          # node_id -> (host, port), incl. self
        self._others = [p for p in peers if p != node_id]
        self._quorum = len(peers) // 2 + 1
        self._dir = data_dir
        self._fsync = fsync
        self._election_window = election_timeout_s
        self._heartbeat_s = heartbeat_s
        self._compact_entries = compact_entries
        # short transport deadlines: a dead peer must not stall the
        # commit path or the election loop for the default 30s
        self._rpc = rpc_client or RpcClient(
            connect_timeout=max(heartbeat_s, 0.2),
            call_timeout=max(heartbeat_s * 8, 2.0))

        self._mu = threading.RLock()
        self.role = FOLLOWER
        self.term = 0
        self.voted_for = 0
        self.leader_id = 0
        self.commit_index = 0
        self.last_applied = 0
        self._match: Dict[int, int] = {}
        self._next: Dict[int, int] = {}
        self._last_leader_contact = time.monotonic()
        self._stopped = False

        # log[i] holds the entry at index snap_last_index + 1 + i
        self.log: List[LogEntry] = []
        self.snap_last_index = 0
        self.snap_last_term = 0
        self._snap_pairs: List[Tuple[bytes, bytes]] = []
        self._snap_engine_version = 0
        self._snap_peers_json = ""   # membership at the snapshot point
        self._log_f = None

        # serializes the full commit round (apply -> replicate -> ack) AND
        # snapshot(): nothing observable escapes before quorum durability
        self._commit_lock = threading.Lock()

        self.engine = MemKVEngine()
        # the client-facing read front (pins/floor) over the shared engine;
        # no WAL — the replicated log IS the durability story
        self.kv = KvService(self.engine)

        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            self._load_durable()
            self._log_f = open(self._log_path(), "ab")
        with self._mu:
            # a recovered log/snapshot may carry a NEWER membership than
            # the bootstrap map this process was started with
            self._active_config_rescan()
        self._rebuild_engine(upto=self.snap_last_index)
        self.last_applied = self.snap_last_index

        self._ticker = threading.Thread(
            target=self._tick_loop, daemon=True,
            name=f"kvd-repl-{node_id}")
        self._ticker.start()

    # -- membership ----------------------------------------------------------
    @staticmethod
    def _peers_to_json(peers: Dict[int, Tuple[str, int]]) -> str:
        return json.dumps({str(n): list(a) for n, a in sorted(peers.items())})

    @staticmethod
    def _peers_from_json(blob: str) -> Dict[int, Tuple[str, int]]:
        return {int(n): (a[0], int(a[1]))
                for n, a in json.loads(blob).items()}

    def _adopt_config(self, peers: Dict[int, Tuple[str, int]]) -> None:
        """Caller holds _mu. Switch to `peers` (append-time activation):
        quorum and replication targets change NOW; removed peers drop out
        of _match/_next, added ones start from scratch (snapshot/backoff
        brings them up)."""
        if peers == self.peers:
            return
        self.peers = dict(peers)
        self._others = [p for p in peers if p != self.node_id]
        self._quorum = len(peers) // 2 + 1
        for gone in [p for p in self._match if p not in peers]:
            self._match.pop(gone, None)
            self._next.pop(gone, None)
        if self.role == LEADER:
            for p in self._others:
                self._match.setdefault(p, 0)
                self._next.setdefault(p, self._last_index() + 1)

    def _active_config_rescan(self) -> None:
        """Caller holds _mu. Recompute the active config after a log
        truncation or durable load: the LAST surviving config entry wins;
        with none, the snapshot's; with neither, the bootstrap map."""
        chosen: Optional[Dict[int, Tuple[str, int]]] = None
        for e in reversed(self.log):
            if e.config:
                chosen = self._peers_from_json(e.config)
                break
        if chosen is None and self._snap_peers_json:
            chosen = self._peers_from_json(self._snap_peers_json)
        if chosen is not None:
            self._adopt_config(chosen)

    # -- durable state -------------------------------------------------------
    def _state_path(self) -> str:
        return os.path.join(self._dir, "raft_state.json")

    def _log_path(self) -> str:
        return os.path.join(self._dir, "repl.log")

    def _snap_path(self) -> str:
        return os.path.join(self._dir, "repl.snap")

    def _persist_state(self) -> None:
        if not self._dir:
            return
        tmp = self._state_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"term": self.term, "voted_for": self.voted_for}, f)
            if self._fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, self._state_path())

    def _append_durable(self, entries: List[LogEntry]) -> None:
        if self._log_f is None:
            return
        buf = b"".join(
            len(raw).to_bytes(4, "big") + raw
            for raw in (serialize(e) for e in entries))
        self._log_f.write(buf)
        self._log_f.flush()
        if self._fsync:
            os.fsync(self._log_f.fileno())

    def _rewrite_log(self) -> None:
        """Persist the current in-memory log tail (after truncation or
        compaction) atomically."""
        if not self._dir:
            return
        tmp = self._log_path() + ".tmp"
        with open(tmp, "wb") as f:
            for e in self.log:
                raw = serialize(e)
                f.write(len(raw).to_bytes(4, "big") + raw)
            f.flush()
            if self._fsync:
                os.fsync(f.fileno())
        if self._log_f is not None:
            self._log_f.close()
        os.replace(tmp, self._log_path())
        self._log_f = open(self._log_path(), "ab")

    def _persist_snapshot(self) -> None:
        if not self._dir:
            return
        tmp = self._snap_path() + ".tmp"
        with open(tmp, "wb") as f:
            head = json.dumps({
                "last_index": self.snap_last_index,
                "last_term": self.snap_last_term,
                "engine_version": self._snap_engine_version,
                "peers": self._snap_peers_json,
            }).encode()
            f.write(len(head).to_bytes(4, "big") + head)
            for k, v in self._snap_pairs:
                f.write(len(k).to_bytes(4, "big") + k)
                f.write(len(v).to_bytes(4, "big") + v)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snap_path())

    def _load_durable(self) -> None:
        try:
            with open(self._state_path()) as f:
                st = json.load(f)
            self.term = int(st.get("term", 0))
            self.voted_for = int(st.get("voted_for", 0))
        except (OSError, ValueError):
            pass
        try:
            with open(self._snap_path(), "rb") as f:
                raw = f.read()
            n = int.from_bytes(raw[:4], "big")
            head = json.loads(raw[4:4 + n])
            self.snap_last_index = int(head["last_index"])
            self.snap_last_term = int(head["last_term"])
            self._snap_engine_version = int(head["engine_version"])
            self._snap_peers_json = str(head.get("peers", ""))
            pos = 4 + n
            pairs = []
            while pos + 4 <= len(raw):
                kl = int.from_bytes(raw[pos:pos + 4], "big")
                k = raw[pos + 4:pos + 4 + kl]
                pos += 4 + kl
                vl = int.from_bytes(raw[pos:pos + 4], "big")
                v = raw[pos + 4:pos + 4 + vl]
                pos += 4 + vl
                pairs.append((k, v))
            self._snap_pairs = pairs
        except (OSError, ValueError, KeyError):
            pass
        try:
            with open(self._log_path(), "rb") as f:
                raw = f.read()
            pos = 0
            while pos + 4 <= len(raw):
                n = int.from_bytes(raw[pos:pos + 4], "big")
                if pos + 4 + n > len(raw):
                    break  # torn tail (never acked)
                try:
                    e = deserialize(raw[pos + 4:pos + 4 + n], LogEntry)
                except Exception:
                    break
                if e.index == self.snap_last_index + len(self.log) + 1:
                    self.log.append(e)
                pos += 4 + n
        except OSError:
            pass

    # -- log helpers ---------------------------------------------------------
    def _last_index(self) -> int:
        return self.snap_last_index + len(self.log)

    def _term_at(self, index: int) -> int:
        if index == self.snap_last_index:
            return self.snap_last_term
        off = index - self.snap_last_index - 1
        if 0 <= off < len(self.log):
            return self.log[off].term
        return -1

    def _entry_at(self, index: int) -> Optional[LogEntry]:
        off = index - self.snap_last_index - 1
        if 0 <= off < len(self.log):
            return self.log[off]
        return None

    # -- engine application --------------------------------------------------
    def _apply_record(self, payload: bytes) -> None:
        if not payload:
            return  # no-op barrier
        rec = deserialize(payload, WalRecord)
        writes = {w.key: (None if w.tombstone else w.value)
                  for w in rec.writes}
        clears = [(r.begin, r.end) for r in rec.clear_ranges]
        self.engine.commit_external(
            self.engine.version, [], [], writes, clears, [])
        if rec.version > self.engine.version:
            self.engine.restore_version_floor(rec.version)

    def _rebuild_engine(self, upto: int) -> None:
        """Fresh engine = snapshot + log entries (snap_last, upto]."""
        self.engine = MemKVEngine()
        if self._snap_pairs:
            self.engine.commit_external(
                0, [], [], {k: v for k, v in self._snap_pairs}, [], [])
            self.engine.restore_version_floor(self._snap_engine_version)
        for idx in range(self.snap_last_index + 1, upto + 1):
            e = self._entry_at(idx)
            if e is not None:
                self._apply_record(e.payload)
        self.kv = KvService(self.engine)
        self.last_applied = upto

    def _advance_applied(self) -> None:
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            e = self._entry_at(self.last_applied)
            if e is not None:
                self._apply_record(e.payload)

    # -- role transitions ----------------------------------------------------
    def _become_follower(self, term: int, leader_id: int = 0) -> None:
        self.role = FOLLOWER
        if term > self.term:
            self.term = term
            self.voted_for = 0
            self._persist_state()
        if leader_id:
            self.leader_id = leader_id
        self._last_leader_contact = time.monotonic()

    def _become_leader(self) -> None:
        self.role = LEADER
        self.leader_id = self.node_id
        last = self._last_index()
        self._match = {p: 0 for p in self._others}
        self._next = {p: last + 1 for p in self._others}
        # no-op barrier of our own term: once it commits, every prior
        # entry in this log is committed too (the figure-8 guard), and the
        # engine rebuilt below is known quorum-durable. Client ops are
        # REJECTED until the barrier commits (_require_leader): otherwise a
        # read could observe an inherited entry that a future leader
        # (elected without it) is still allowed to discard.
        barrier = LogEntry(term=self.term, index=last + 1, payload=b"")
        self.log.append(barrier)
        self._append_durable([barrier])
        self._barrier_index = barrier.index
        if len(self.peers) == 1:
            self.commit_index = barrier.index  # quorum of one
        self._rebuild_engine(upto=self._last_index())

    # -- background: election timer + heartbeats -----------------------------
    def _tick_loop(self) -> None:
        timeout = random.uniform(*self._election_window)
        while not self._stopped:
            time.sleep(self._heartbeat_s / 2)
            with self._mu:
                if self._stopped:
                    return
                role = self.role
                silent = time.monotonic() - self._last_leader_contact
            if role == LEADER:
                self._broadcast_heartbeat()
            elif silent > timeout:
                timeout = random.uniform(*self._election_window)
                self._run_election()

    def _run_election(self) -> None:
        with self._mu:
            if self._stopped:
                return  # a zombie candidate must not bump/persist terms
            self.role = CANDIDATE
            self.term += 1
            self.voted_for = self.node_id
            self._persist_state()
            term = self.term
            req = VoteReq(
                term=term,
                candidate_id=self.node_id,
                last_log_index=self._last_index(),
                last_log_term=self._term_at(self._last_index()),
            )
            self._last_leader_contact = time.monotonic()
        votes = 1
        for peer in self._others:
            try:
                rsp = self._rpc.call(
                    self.peers[peer], KV_REPL_SERVICE_ID, 2, req, VoteRsp)
            except FsError:
                continue
            with self._mu:
                if rsp.term > self.term:
                    self._become_follower(rsp.term)
                    return
            if rsp.granted:
                votes += 1
        with self._mu:
            if self.role != CANDIDATE or self.term != term:
                return
            if votes >= self._quorum:
                self._become_leader()
            else:
                self.role = FOLLOWER
        if self.role == LEADER:
            self._broadcast_heartbeat()

    def _broadcast_heartbeat(self) -> None:
        if self._stopped:
            return
        for peer in self._others:
            self._replicate_to(peer)
        self._advance_commit_from_matches()

    def _advance_commit_from_matches(self) -> None:
        """Leader: commit = the highest index stored on a majority, but
        only once an entry of OUR term reaches it (Raft's commit rule) —
        this is what lets the election barrier commit without client
        traffic."""
        with self._mu:
            if self.role != LEADER:
                return
            stored = sorted(
                [self._last_index()] + list(self._match.values()),
                reverse=True)
            candidate = stored[self._quorum - 1]
            if (candidate > self.commit_index
                    and self._term_at(candidate) == self.term):
                self.commit_index = candidate
                self._advance_applied()

    # -- replication ---------------------------------------------------------
    def _replicate_to(self, peer: int) -> bool:
        """Bring one follower up to date; True when it matches our log."""
        for _ in range(4):  # back off through log mismatches
            with self._mu:
                if self.role != LEADER or self._stopped:
                    return False
                nxt = self._next.get(peer, self._last_index() + 1)
                if nxt <= self.snap_last_index:
                    return self._install_snapshot_on(peer)
                prev = nxt - 1
                req = AppendReq(
                    term=self.term,
                    leader_id=self.node_id,
                    prev_index=prev,
                    prev_term=self._term_at(prev),
                    entries=[self._entry_at(i)
                             for i in range(nxt, self._last_index() + 1)],
                    commit_index=self.commit_index,
                )
            try:
                rsp = self._rpc.call(
                    self.peers[peer], KV_REPL_SERVICE_ID, 1, req, AppendRsp)
            except FsError:
                return False
            with self._mu:
                if rsp.term > self.term:
                    self._become_follower(rsp.term)
                    return False
                if rsp.ok:
                    # max(): a late heartbeat reply must not regress match
                    self._match[peer] = max(self._match.get(peer, 0),
                                            rsp.match_index)
                    self._next[peer] = self._match[peer] + 1
                    return True
                # consistency miss: back off (follower told us how far back)
                self._next[peer] = max(
                    1, min(rsp.match_index + 1, self._next.get(peer, 1) - 1))
        return False

    def _install_snapshot_on(self, peer: int) -> bool:
        # caller holds _mu
        req = SnapInstallReq(
            term=self.term,
            leader_id=self.node_id,
            last_index=self.snap_last_index,
            last_term=self.snap_last_term,
            engine_version=self._snap_engine_version,
            pairs=[RangePair(k, v) for k, v in self._snap_pairs],
            peers_json=(self._snap_peers_json
                        or self._peers_to_json(self.peers)),
        )
        addr = self.peers[peer]
        self._mu.release()
        try:
            rsp = self._rpc.call(
                addr, KV_REPL_SERVICE_ID, 3, req, SnapInstallRsp)
        except FsError:
            return False
        finally:
            self._mu.acquire()
        if rsp.term > self.term:
            self._become_follower(rsp.term)
            return False
        if rsp.ok:
            self._match[peer] = req.last_index
            self._next[peer] = req.last_index + 1
        return rsp.ok

    def _replicate_quorum(self) -> bool:
        """Push the current log to followers; True once a majority
        (including self) stores the last index."""
        target = self._last_index()
        acked = 1
        for peer in self._others:
            if self._replicate_to(peer):
                with self._mu:
                    if self._match.get(peer, 0) >= target:
                        acked += 1
            if acked >= self._quorum:
                break
        if acked >= self._quorum:
            with self._mu:
                if self.role == LEADER and self.term == self._term_at(target):
                    self.commit_index = max(self.commit_index, target)
                    self._advance_applied()
            return True
        return False

    def _maybe_compact(self) -> None:
        with self._mu:
            self._compact_locked()

    def _compact_locked(self) -> None:
        """Caller holds _mu. Snapshot applied state + truncate the log
        prefix; runs on leaders AND followers (a follower that never lags
        would otherwise grow its log forever)."""
        if self._stopped:
            return  # never rewrite files a successor may own
        if len(self.log) <= self._compact_entries:
            return
        keep_from = self.last_applied  # snapshot covers exactly this state
        if keep_from <= self.snap_last_index or keep_from > self.commit_index:
            return
        # membership at the snapshot point: the last config entry at or
        # below keep_from (those entries are about to be truncated away)
        for e in self.log:
            if e.index > keep_from:
                break
            if e.config:
                self._snap_peers_json = e.config
        self._snap_pairs = self.engine.dump_at(self.engine.version)
        self._snap_engine_version = self.engine.version
        self.snap_last_term = self._term_at(keep_from)
        self.log = self.log[keep_from - self.snap_last_index:]
        self.snap_last_index = keep_from
        self._persist_snapshot()
        self._rewrite_log()

    # -- client-facing KV API (leader only) ----------------------------------
    def _require_leader(self) -> None:
        with self._mu:
            if self.role != LEADER:
                raise FsError(Status(
                    Code.KV_NOT_PRIMARY,
                    f"not primary; leader={self.leader_id}"))
            if self.commit_index < getattr(self, "_barrier_index", 0):
                # elected but the term barrier has not replicated yet:
                # nothing this engine shows is known quorum-durable
                raise FsError(Status(
                    Code.KV_NOT_PRIMARY,
                    f"not primary (barrier pending); "
                    f"leader={self.leader_id}"))

    def snapshot(self, req: SnapshotReq) -> SnapshotRsp:
        self._require_leader()
        # serialized behind in-flight commits: the version handed out is
        # quorum-durable (see module docstring)
        with self._commit_lock:
            return self.kv.snapshot(req)

    def get(self, req: GetReq):
        self._require_leader()
        return self.kv.get(req)

    def get_range(self, req: RangeReq):
        self._require_leader()
        return self.kv.get_range(req)

    def release(self, req: ReleaseReq) -> EmptyMsg:
        self._require_leader()
        return self.kv.release(req)

    def commit(self, req: CommitReq) -> CommitRsp:
        self._require_leader()
        writes = {w.key: (None if w.tombstone else w.value)
                  for w in req.writes}
        clears = [(r.begin, r.end) for r in req.clear_ranges]
        stamps = [(s.prefix, s.suffix, s.value) for s in req.versionstamped]
        with self._commit_lock:
            self._require_leader()
            self.kv._check_version(req.read_version)
            version = self.engine.commit_external(
                req.read_version,
                list(req.read_keys),
                [(r.begin, r.end) for r in req.read_ranges],
                writes,
                clears,
                stamps,
            )
            if not (writes or clears or stamps):
                return CommitRsp(version=version)  # read-only: no log entry
            if stamps:
                import struct as _struct

                for order, (prefix, suffix, value) in enumerate(stamps):
                    stamp = _struct.pack(">QH", version, order)
                    writes[prefix + stamp + suffix] = value
            rec = WalRecord(
                version=version,
                writes=[WriteEntry(k, v if v is not None else b"", v is None)
                        for k, v in writes.items()],
                clear_ranges=[RangeEntry(b, e) for b, e in clears],
            )
            with self._mu:
                if self.role != LEADER:
                    # deposed between the engine apply and the log append
                    # (a higher-term leader contacted us): the local apply
                    # is discarded, nothing was appended anywhere — the
                    # retry is unambiguous
                    self._rebuild_engine(upto=min(self.commit_index,
                                                  self._last_index()))
                    raise FsError(Status(
                        Code.KV_NOT_PRIMARY,
                        f"deposed mid-commit; leader={self.leader_id}"))
                entry = LogEntry(term=self.term,
                                 index=self._last_index() + 1,
                                 payload=serialize(rec))
                self.log.append(entry)
                self._append_durable([entry])
                # the engine ALREADY applied this record (commit_external
                # above): mark it applied now or _advance_applied would
                # re-apply it after quorum, double-bumping the version
                self.last_applied = max(self.last_applied, entry.index)
            if not self._replicate_quorum():
                # the entry IS durably in our log: if this node is later
                # re-elected (it may have the longest log) the entry
                # commits after all — a genuinely ambiguous outcome. Hide
                # the apply locally and say MAYBE_COMMITTED, mirroring
                # FDB's commit_unknown_result.
                with self._mu:
                    self.role = FOLLOWER
                    self._rebuild_engine(upto=min(self.commit_index,
                                                  self._last_index()))
                raise FsError(Status(
                    Code.KV_MAYBE_COMMITTED,
                    "lost quorum mid-commit; outcome unknown"))
            self._maybe_compact()
        return CommitRsp(version=version)

    # -- replication RPC handlers (peer-facing) ------------------------------
    def append_entries(self, req: AppendReq) -> AppendRsp:
        with self._mu:
            if self._stopped:
                return AppendRsp(term=self.term, ok=False,
                                 match_index=self._last_index())
            # note: appends from leaders OUTSIDE our (possibly stale)
            # config are ACCEPTED — a lagging member must be able to learn
            # the very config entries that make the sender legitimate, and
            # the log-consistency check below protects correctness either
            # way. Removed-node containment lives in request_vote's leader
            # stickiness, not here.
            if req.term < self.term:
                return AppendRsp(term=self.term, ok=False,
                                 match_index=self._last_index())
            self._become_follower(req.term, req.leader_id)
            # consistency check at prev (indices covered by our snapshot
            # are trusted: snapshots only contain committed state)
            if req.prev_index > self._last_index() or (
                    req.prev_index > self.snap_last_index
                    and self._term_at(req.prev_index) != req.prev_term):
                # tell the leader how far back we actually are
                return AppendRsp(
                    term=self.term, ok=False,
                    match_index=min(self._last_index(),
                                    max(req.prev_index - 1, 0)))
            new_durable: List[LogEntry] = []
            truncated = False
            for e in req.entries:
                if e.index <= self.snap_last_index:
                    continue  # covered by our snapshot
                have = self._entry_at(e.index)
                if have is not None and have.term == e.term:
                    continue
                if have is not None:
                    # conflicting suffix: drop it (it was never committed)
                    self.log = self.log[: e.index - self.snap_last_index - 1]
                    truncated = True
                if e.index == self._last_index() + 1:
                    self.log.append(e)
                    new_durable.append(e)
            if truncated:
                self._rewrite_log()
                if self.last_applied > self._last_index():
                    # rebuild below the truncation point
                    self._rebuild_engine(
                        upto=min(self.commit_index, self._last_index()))
            elif new_durable:
                self._append_durable(new_durable)
            if truncated or any(e.config for e in new_durable):
                # membership activates at APPEND time (and a truncation
                # may have rolled a config entry back out)
                self._active_config_rescan()
            if req.commit_index > self.commit_index:
                self.commit_index = min(req.commit_index, self._last_index())
                self._advance_applied()
                self._compact_locked()
            return AppendRsp(term=self.term, ok=True,
                             match_index=self._last_index())

    def request_vote(self, req: VoteReq) -> VoteRsp:
        with self._mu:
            if self._stopped:
                return VoteRsp(term=self.term, granted=False)
            if (time.monotonic() - self._last_leader_contact
                    < self._election_window[0]):
                # leader stickiness (Raft dissertation §4.2.3): while we
                # hear a current leader, campaigns are refused WITHOUT
                # adopting the candidate's term — this is what contains a
                # REMOVED node (its config no longer includes it, but it
                # keeps timing out and campaigning at ever-higher terms)
                # without blocking a lagging member's catch-up
                return VoteRsp(term=self.term, granted=False)
            if req.term < self.term:
                return VoteRsp(term=self.term, granted=False)
            if req.term > self.term:
                self._become_follower(req.term)
            up_to_date = (
                req.last_log_term > self._term_at(self._last_index())
                or (req.last_log_term == self._term_at(self._last_index())
                    and req.last_log_index >= self._last_index()))
            if up_to_date and self.voted_for in (0, req.candidate_id):
                self.voted_for = req.candidate_id
                self._persist_state()
                self._last_leader_contact = time.monotonic()
                return VoteRsp(term=self.term, granted=True)
            return VoteRsp(term=self.term, granted=False)

    def install_snapshot(self, req: SnapInstallReq) -> SnapInstallRsp:
        with self._mu:
            if self._stopped:
                return SnapInstallRsp(term=self.term, ok=False)
            if req.term < self.term:
                return SnapInstallRsp(term=self.term, ok=False)
            self._become_follower(req.term, req.leader_id)
            self._snap_pairs = [(p.key, p.value) for p in req.pairs]
            self._snap_engine_version = req.engine_version
            self.snap_last_index = req.last_index
            self.snap_last_term = req.last_term
            self._snap_peers_json = req.peers_json
            self.log = [e for e in self.log if e.index > req.last_index]
            # a snapshot replaces everything up to last_index
            if self.log and self.log[0].index != req.last_index + 1:
                self.log = []
            self._persist_snapshot()
            self._rewrite_log()
            self.commit_index = max(self.commit_index, req.last_index)
            self._rebuild_engine(upto=self.commit_index)
            self._active_config_rescan()
            return SnapInstallRsp(term=self.term, ok=True)

    def reconfig(self, req: ReconfigReq) -> ReconfigRsp:
        """Online membership change (the role FDB's reconfigurable cluster
        plays for the reference, src/fdb/HybridKvEngine.h:12-22): append a
        config entry carrying the COMPLETE new peer map and replicate it
        under the NEW quorum. One node added or removed per call (the
        single-server rule that makes append-time activation safe); the
        current leader cannot remove itself. A freshly added node is
        started empty with the new map as its bootstrap config and catches
        up via snapshot/log backoff."""
        self._require_leader()
        try:
            new_peers = self._peers_from_json(req.peers_json)
        except (ValueError, KeyError, TypeError) as e:
            return ReconfigRsp(ok=False, message=f"bad peer map: {e!r}")
        with self._commit_lock:
            with self._mu:
                if self.role != LEADER:
                    return ReconfigRsp(
                        ok=False, term=self.term,
                        message=f"not leader; leader={self.leader_id}")
                if not new_peers:
                    return ReconfigRsp(ok=False, message="empty peer map")
                if self.node_id not in new_peers:
                    return ReconfigRsp(
                        ok=False,
                        message="leader cannot remove itself; move "
                                "leadership first")
                # ONE changed node per entry — added, removed, OR an
                # existing member's address rewrite all count (the
                # quorum-overlap argument needs every other member's
                # identity AND address unchanged)
                delta = set(new_peers) ^ set(self.peers)
                delta |= {n for n in set(new_peers) & set(self.peers)
                          if new_peers[n] != self.peers[n]}
                if len(delta) > 1:
                    return ReconfigRsp(
                        ok=False,
                        message=f"one node per change (delta={sorted(delta)}"
                                "); reconfig repeatedly for more")
                entry = LogEntry(term=self.term,
                                 index=self._last_index() + 1,
                                 config=self._peers_to_json(new_peers))
                self.log.append(entry)
                self._append_durable([entry])
                self._adopt_config(new_peers)  # append-time activation
                self.last_applied = max(self.last_applied, entry.index)
                term, index = self.term, entry.index
            if not self._replicate_quorum():
                # the entry is durably in our log; like a client commit
                # that lost quorum mid-round the outcome is ambiguous —
                # step down and report it
                with self._mu:
                    self.role = FOLLOWER
                return ReconfigRsp(
                    ok=False, term=term, index=index,
                    message="lost quorum mid-reconfig; outcome unknown")
        return ReconfigRsp(ok=True, term=term, index=index)

    def status(self, req: StatusReq) -> StatusRsp:
        with self._mu:
            return StatusRsp(
                node_id=self.node_id,
                role=self.role,
                term=self.term,
                leader_id=self.leader_id,
                last_index=self._last_index(),
                commit_index=self.commit_index,
                engine_version=self.engine.version,
                peers_json=self._peers_to_json(self.peers),
            )

    def stop(self) -> None:
        with self._mu:
            self._stopped = True
            self.role = FOLLOWER
        # QUIESCE before releasing the data dir: join the ticker and take
        # the lock once more so any in-flight RPC handler finishes. An
        # in-process restart (tests) constructs a NEW service over the
        # SAME files with a different lock — a zombie writer thread from
        # this instance racing the successor's reads/writes corrupts the
        # log (impossible with real process kills, very possible with
        # thread-level ones).
        if self._ticker is not None \
                and self._ticker is not threading.current_thread():
            deadline = time.monotonic() + 30
            while self._ticker.is_alive() and time.monotonic() < deadline:
                self._ticker.join(timeout=1)
            if self._ticker.is_alive():
                # loud, not silent: the quiesce invariant is broken and a
                # successor over this data dir would race a zombie writer
                xlog("WARN",
                     f"kvd {self.node_id}: ticker still alive after "
                     "stop() quiesce window")
        # drain any in-flight client commit (it holds _commit_lock across
        # replication): its post-quorum compact is also _stopped-guarded
        with self._commit_lock:
            pass
        with self._mu:
            if self._log_f is not None:
                self._log_f.close()
                self._log_f = None


def bind_repl_service(server: RpcServer, svc: ReplicatedKvService) -> None:
    s = ServiceDef(KV_REPL_SERVICE_ID, "KvRepl")
    s.method(1, "appendEntries", AppendReq, AppendRsp, svc.append_entries)
    s.method(2, "requestVote", VoteReq, VoteRsp, svc.request_vote)
    s.method(3, "installSnapshot", SnapInstallReq, SnapInstallRsp,
             svc.install_snapshot)
    s.method(4, "status", StatusReq, StatusRsp, svc.status)
    s.method(5, "reconfig", ReconfigReq, ReconfigRsp, svc.reconfig)
    server.add_service(s)


def bind_replicated_kv(server: RpcServer, svc: ReplicatedKvService) -> None:
    """Expose the client-facing KV schema (same ids as the plain kvd) plus
    the replication service on one server."""
    from tpu3fs_torch.kv.service import KV_SERVICE_ID, GetRsp, RangeRsp

    s = ServiceDef(KV_SERVICE_ID, "Kv")
    s.method(1, "snapshot", SnapshotReq, SnapshotRsp, svc.snapshot)
    s.method(2, "get", GetReq, GetRsp, svc.get)
    s.method(3, "getRange", RangeReq, RangeRsp, svc.get_range)
    s.method(4, "commit", CommitReq, CommitRsp, svc.commit)
    s.method(5, "release", ReleaseReq, EmptyMsg, svc.release)
    server.add_service(s)
    bind_repl_service(server, svc)
