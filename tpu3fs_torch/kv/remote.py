"""RemoteKVEngine: IKVEngine client for the network KV service.

The port's own copy of ``tpu3fs/kv/remote.py``, unchanged but for its
imports.

The FDB-client model (ref src/fdb/FDBTransaction.h semantics over our own
service instead of the FDB C library): a transaction takes a server snapshot
version, reads at that version over RPC, buffers writes/clears locally with
read-your-writes overlay, and submits ONE atomic commit RPC carrying the
read set — the server validates and applies. Conflicts surface as
FsError(KV_CONFLICT) so the standard with_transaction retry loop drives
retries identically to the in-memory engine; the meta/mgmtd suites run
unchanged on top.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from tpu3fs_torch.kv.kv import IKVEngine, ITransaction, KVPair
from tpu3fs_torch.kv.service import (
    KV_SERVICE_ID,
    CommitReq,
    CommitRsp,
    EmptyMsg,
    GetReq,
    GetRsp,
    RangeEntry,
    RangeReq,
    RangeRsp,
    ReleaseReq,
    SnapshotReq,
    SnapshotRsp,
    StampEntry,
    WriteEntry,
)
from tpu3fs_torch.rpc.net import RpcClient
from tpu3fs_torch.utils.result import Code, FsError, Status


def engine_from_flag(kv_flag: str):
    """'host:port' -> RemoteKVEngine; 'h1:p1,h2:p2,...' (or explicit
    'id=h:p,...') -> ReplicatedRemoteKVEngine over the kvd group; empty ->
    local MemKVEngine (dev)."""
    if not kv_flag:
        from tpu3fs_torch.kv.mem import MemKVEngine

        return MemKVEngine()
    if "," in kv_flag or "=" in kv_flag:
        peers = {}
        for i, part in enumerate(kv_flag.split(",")):
            part = part.strip()
            if not part:
                continue
            if "=" in part:
                nid, addr = part.split("=", 1)
            else:
                nid, addr = str(i + 1), part
            host, port = addr.rsplit(":", 1)
            peers[int(nid)] = (host, int(port))
        return ReplicatedRemoteKVEngine(peers)
    host, port = kv_flag.rsplit(":", 1)
    return RemoteKVEngine((host, int(port)))


class RemoteKVEngine(IKVEngine):
    def __init__(self, addr: Tuple[str, int],
                 client: Optional[RpcClient] = None,
                 client_id: str = ""):
        self._addr = (addr[0], int(addr[1]))
        self._client = client or RpcClient()
        self._client_id = client_id

    def _call(self, method_id: int, req, rsp_type):
        return self._client.call(
            self._addr, KV_SERVICE_ID, method_id, req, rsp_type
        )

    def transaction(self) -> "RemoteTransaction":
        rsp = self._call(1, SnapshotReq(self._client_id), SnapshotRsp)
        return RemoteTransaction(self, rsp.version)

    def close(self) -> None:
        self._client.close()


class RemoteTransaction(ITransaction):
    """Local write buffer + RPC snapshot reads + single commit RPC."""

    def __init__(self, engine: RemoteKVEngine, read_version: int):
        self._engine = engine
        self._read_version = read_version
        self._writes: Dict[bytes, Optional[bytes]] = {}
        self._clear_ranges: List[Tuple[bytes, bytes]] = []
        self._read_keys: List[bytes] = []
        self._read_ranges: List[Tuple[bytes, bytes]] = []
        self._versionstamped: List[Tuple[bytes, bytes, bytes]] = []
        self._committed_version: Optional[int] = None
        self._done = False

    # -- reads (read-your-writes overlay, same rules as MemTransaction) -----
    def _local_lookup(self, key: bytes):
        if key in self._writes:
            return True, self._writes[key]
        for begin, end in self._clear_ranges:
            if begin <= key < end:
                return True, None
        return False, None

    def _remote_get(self, key: bytes) -> Optional[bytes]:
        rsp = self._engine._call(
            2, GetReq(bytes(key), self._read_version), GetRsp
        )
        return rsp.value if rsp.found else None

    def get(self, key: bytes) -> Optional[bytes]:
        found, val = self._local_lookup(key)
        if found:
            return val
        self._read_keys.append(bytes(key))
        return self._remote_get(key)

    def snapshot_get(self, key: bytes) -> Optional[bytes]:
        found, val = self._local_lookup(key)
        if found:
            return val
        return self._remote_get(key)

    def get_range(
        self,
        begin: bytes,
        end: bytes,
        *,
        limit: int = 0,
        reverse: bool = False,
        snapshot: bool = False,
    ) -> List[KVPair]:
        begin, end = bytes(begin), bytes(end)
        if not snapshot:
            self._read_ranges.append((begin, end))
        # push limit/reverse to the server only when no buffered local edits
        # could change which keys survive the overlay; otherwise fetch the
        # full range and trim after merging
        clean = not self._writes and not self._clear_ranges
        rsp = self._engine._call(
            3,
            RangeReq(begin, end, self._read_version,
                     limit if clean else 0, reverse if clean else False),
            RangeRsp,
        )
        merged: Dict[bytes, Optional[bytes]] = {
            p.key: p.value for p in rsp.pairs
        }
        for rb, re_ in self._clear_ranges:
            for key in list(merged):
                if rb <= key < re_:
                    merged[key] = None
        for key, val in self._writes.items():
            if begin <= key < end:
                merged[key] = val
        items = sorted(
            (k for k, v in merged.items() if v is not None), reverse=reverse
        )
        if limit:
            items = items[:limit]
        return [KVPair(k, merged[k]) for k in items]

    def add_read_conflict(self, key: bytes) -> None:
        self._read_keys.append(bytes(key))

    # -- writes --------------------------------------------------------------
    def set(self, key: bytes, value: bytes) -> None:
        assert not self._done
        self._writes[bytes(key)] = bytes(value)

    def set_versionstamped_key(self, prefix: bytes, suffix: bytes,
                               value: bytes) -> None:
        assert not self._done
        self._versionstamped.append(
            (bytes(prefix), bytes(suffix), bytes(value)))

    def clear(self, key: bytes) -> None:
        assert not self._done
        self._writes[bytes(key)] = None

    def clear_range(self, begin: bytes, end: bytes) -> None:
        assert not self._done
        begin, end = bytes(begin), bytes(end)
        for key in [k for k in self._writes if begin <= k < end]:
            del self._writes[key]
        self._clear_ranges.append((begin, end))

    # -- commit ---------------------------------------------------------------
    def commit(self) -> None:
        assert not self._done
        self._done = True
        req = CommitReq(
            read_version=self._read_version,
            read_keys=list(self._read_keys),
            read_ranges=[RangeEntry(b, e) for b, e in self._read_ranges],
            writes=[
                WriteEntry(k, v if v is not None else b"", v is None)
                for k, v in self._writes.items()
            ],
            clear_ranges=[RangeEntry(b, e) for b, e in self._clear_ranges],
            versionstamped=[
                StampEntry(p, s, v) for p, s, v in self._versionstamped
            ],
        )
        try:
            rsp = self._engine._call(4, req, CommitRsp)
            self._committed_version = rsp.version
        finally:
            self._release()  # on conflict too: free the snapshot pin now

    def cancel(self) -> None:
        if not self._done:
            self._done = True
            self._release()

    def _release(self) -> None:
        try:
            self._engine._call(5, ReleaseReq(self._read_version), EmptyMsg)
        except FsError:
            pass  # pin expires by TTL server-side

    @property
    def committed_version(self) -> Optional[int]:
        return self._committed_version


class ReplicatedRemoteKVEngine(RemoteKVEngine):
    """Client for a replicated kvd group (kv/replica.py): tracks the
    leader, follows KV_NOT_PRIMARY hints, and retries across peers through
    elections.

    Failing over MID-transaction is safe by construction: any version a
    client ever observed is quorum-durable, every new leader's engine is
    rebuilt to at least that version, and its read floor starts AT its
    rebuilt version — so a re-routed read either resolves identical state
    (same log prefix => same bytes) or fails loudly with KV_TXN_TOO_OLD
    and the with_transaction loop restarts the transaction."""

    # generous by design: a leader election under heavy host load can take
    # well past 15s (observed in CI-like runs with parallel suites), and
    # exhausting the window surfaces RPC_CONNECT_FAILED to callers whose
    # transaction would have succeeded one election later. FDB clients
    # effectively retry until the transaction timeout; 45s approximates
    # that while still failing a genuinely dead cluster promptly.
    RETRY_WINDOW_S = 45.0

    def __init__(self, peers, client: Optional[RpcClient] = None,
                 client_id: str = ""):
        peers = {int(i): (h, int(p)) for i, (h, p) in dict(peers).items()}
        super().__init__(next(iter(peers.values())), client, client_id)
        self._peers = peers
        self._order = sorted(peers)
        self._leader: Optional[int] = None

    _COMMIT_METHOD = 4

    def _call(self, method_id: int, req, rsp_type):
        import time as _time

        deadline = _time.monotonic() + self.RETRY_WINDOW_S
        last: Optional[FsError] = None
        cursor = 0
        while _time.monotonic() < deadline:
            nid = (self._leader if self._leader in self._peers
                   else self._order[cursor % len(self._order)])
            try:
                return self._client.call(
                    self._peers[nid], KV_SERVICE_ID, method_id, req, rsp_type)
            except FsError as e:
                last = e
                ambiguous_commit = (
                    method_id == self._COMMIT_METHOD
                    and e.code in (Code.RPC_TIMEOUT, Code.RPC_PEER_CLOSED,
                                   Code.TIMEOUT))
                if ambiguous_commit:
                    # the commit REACHED the server and its fate is
                    # unknown (it may yet replicate): blind transport
                    # retry could apply the write set twice. Surface
                    # FDB's commit_unknown_result; with_transaction
                    # restarts the whole transaction.
                    raise FsError(Status(
                        Code.KV_MAYBE_COMMITTED,
                        f"commit outcome unknown: {e.status.message}"))
                if e.code == Code.KV_NOT_PRIMARY:
                    # pre-apply rejection (or a barrier-pending leader):
                    # always safe to re-send
                    hint = _leader_hint(e.status.message)
                    if hint in self._peers and hint != nid:
                        self._leader = hint
                        continue
                    self._leader = None
                    cursor += 1
                    _time.sleep(0.1)  # election likely in progress
                elif e.code in (Code.RPC_CONNECT_FAILED, Code.RPC_SEND_FAILED,
                                Code.RPC_TIMEOUT, Code.RPC_PEER_CLOSED,
                                Code.TIMEOUT):
                    # request provably not processed (connect/send), or a
                    # non-commit op (reads are idempotent): safe to retry
                    self._leader = None
                    cursor += 1
                    _time.sleep(0.05)
                else:
                    raise  # conflicts/too-old etc. belong to the caller
        raise last or FsError(Status(Code.RPC_CONNECT_FAILED,
                                     "no kvd peer reachable"))


def _leader_hint(message: str) -> Optional[int]:
    # "not primary; leader=3" -> 3 (0 = unknown)
    marker = "leader="
    pos = message.find(marker)
    if pos < 0:
        return None
    digits = ""
    for ch in message[pos + len(marker):]:
        if ch.isdigit():
            digits += ch
        else:
            break
    nid = int(digits) if digits else 0
    return nid or None
