"""Two-phase cross-partition rename/hardlink: intent records +
prepare/commit with an idempotent crash resolver (docs/metashard.md).

The port's own copy of ``tpu3fs/metashard/twophase.py``,
unchanged but for its imports.

Single-partition meta ops are one KV transaction (MetaStore). A
cross-partition rename mutates TWO owners' serialization domains — the
src directory's dirent (src partition) and the dst directory's dirent
(dst partition) — so it runs as three bounded steps, each one KV
transaction, with a durable INTENT record driving crash recovery:

    A. INTENT   (coordinator = src-partition owner): validate src,
                write ``IntentRecord`` (state=preparing, deadline).
    B. PREPARE  (dst-partition owner, via peer RPC): validate the
                intent is live, create the dst dirent + a
                ``PrepareRecord``. Idempotent per txn_id.
    C. COMMIT   (coordinator): guarded clear of the src dirent (only
                if it still points at the recorded inode) + clear the
                intent — ONE atomic txn. Then best-effort FINISH on the
                dst owner clears the prepare record.

Hardlink mirrors it with the roles swapped: the coordinator is the
dst-parent owner (where the new dirent lands), PREPARE bumps nlink on
the inode's by-inode owner behind a prepare record, COMMIT writes the
dst dirent.

Crash matrix (kill the coordinator at any phase boundary — fault
points ``meta.twophase.intent`` / ``.prepared`` / ``.committed``):

=====================  ======================================================
crashed after          resolver action (``resolve_intents``)
=====================  ======================================================
A (intent only)        dst has no prepare record and the deadline passed:
                       ABORT — clear the intent. Nothing ever showed.
B (intent + prepare)   ROLL FORWARD — re-run C's txn (guarded src clear +
                       intent clear), then clear the prepare record. The
                       dst name already serves; the src name dies exactly
                       once.
C (prepare only)       the intent is gone, so the op COMMITTED — clear the
                       orphan prepare record. (A prepare record never
                       outlives its meaning: for rename the dst dirent
                       stays; for hardlink the nlink bump stays.)
=====================  ======================================================

Every resolver mutation is guarded (dirent cleared only when it still
points at the intent's inode; nlink undone only behind a live prepare
record), so blind re-execution after ANY crash converges —
``TWOPHASE_REEXECUTED_METHODS`` names the surface and
``tools/check_rpc_registry.py`` (check 9) statically holds each entry to
idempotent-or-replay-safe, the migration-resume rule extended to meta.

The resolver needs NO peer transport: all partitions share one
transactional KV, so recovery acts on the KV directly (a dead
coordinator's partitions are being reassigned anyway; txn atomicity
keeps direct recovery sound). Ownership is a serialization/scale
discipline, not the correctness boundary.

``rename_orphan_intent`` (chaos/bugs.py) re-plants the historic bug this
protocol exists to prevent: a resolver that rolls a stale intent forward
WITHOUT the inode guard clears whatever now lives at src — replaying a
crashed rename orphans a newer file (caught by the ``meta_intents``
invariant checker; seed ``tests/chaos_seeds/rename_orphan_intent_*``).
"""

from __future__ import annotations

import secrets
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from tpu3fs_torch.chaos.bugs import bug_fire
from tpu3fs_torch.kv.kv import IKVEngine, ITransaction, with_transaction
from tpu3fs_torch.meta.types import DirEntry, InodeType, dirent_key
from tpu3fs_torch.rpc.serde import deserialize, serialize
from tpu3fs_torch.utils.fault_injection import inject
from tpu3fs_torch.utils.result import Code, FsError
from tpu3fs_torch.utils.result import err as _err

#: default intent lifetime: PREPARE refuses past it, the resolver only
#: touches intents beyond it (coordinator crash detection by timeout)
INTENT_TTL_S = 5.0

_INTENT_PREFIX = b"MTPI"
_PREPARE_PREFIX = b"MTPP"

#: every (service, method) a crash-resumed two-phase replay re-executes
#: blindly. check_rpc_registry check 9 statically requires each to be
#: classified idempotent or listed in REPLAY_SAFE_MUTATIONS — the
#: migration-worker resume rule (check 8) extended to the meta plane.
TWOPHASE_REEXECUTED_METHODS = (
    ("MetaSerde", "renamePrepare"),
    ("MetaSerde", "renameFinish"),
    ("MetaSerde", "renameResolve"),
)

KIND_RENAME = "rename"
KIND_HARDLINK = "hardlink"

ST_PREPARING = "preparing"


def intent_key(txn_id: str) -> bytes:
    return _INTENT_PREFIX + txn_id.encode()


def prepare_key(txn_id: str) -> bytes:
    return _PREPARE_PREFIX + txn_id.encode()


def intent_scan_range() -> Tuple[bytes, bytes]:
    return _INTENT_PREFIX, _INTENT_PREFIX + b"\xff" * 33


def prepare_scan_range() -> Tuple[bytes, bytes]:
    return _PREPARE_PREFIX, _PREPARE_PREFIX + b"\xff" * 33


def new_txn_id() -> str:
    return secrets.token_hex(16)


@dataclass
class IntentRecord:
    """The coordinator's durable promise (phase A). Holds everything the
    resolver needs to finish or undo the op without re-resolving paths —
    paths may mean something ELSE by recovery time, which is exactly why
    every field is an id."""

    txn_id: str = ""
    kind: str = KIND_RENAME
    state: str = ST_PREPARING
    src_pid: int = 0
    dst_pid: int = 0
    # rename: the dirent being moved; hardlink: the dirent being created
    # lives at (dst_parent, dst_name) and inode_id gains a link
    inode_id: int = 0
    inode_type: int = 0
    src_parent: int = 0
    src_name: str = ""
    dst_parent: int = 0
    dst_name: str = ""
    # directory rename: the inode's parent pointer must follow the move
    is_dir: int = 0
    deadline: float = 0.0


@dataclass
class PrepareRecord:
    """The participant's durable acknowledgement (phase B), written in
    the SAME txn as its side effect — record present <=> effect applied,
    which is what makes prepare idempotent per txn_id."""

    txn_id: str = ""
    kind: str = KIND_RENAME
    coordinator_pid: int = 0
    inode_id: int = 0
    dst_parent: int = 0
    dst_name: str = ""


def _load_intent(txn: ITransaction, txn_id: str) -> Optional[IntentRecord]:
    raw = txn.get(intent_key(txn_id))
    return deserialize(raw, IntentRecord) if raw else None


def _load_prepare(txn: ITransaction, txn_id: str) -> Optional[PrepareRecord]:
    raw = txn.get(prepare_key(txn_id))
    return deserialize(raw, PrepareRecord) if raw else None


class TwoPhaseCoordinator:
    """Drives one cross-partition rename/hardlink over a
    ``ShardedMetaStore``. ``peer_prepare(dst_pid, intent)`` /
    ``peer_finish(dst_pid, txn_id)`` route phase B/finish through the
    participant partition's owner (MetaRpcClient in real clusters); when
    absent — tests, single-process drives, the resolver — phases execute
    locally against the shared KV."""

    def __init__(self, store, *,
                 peer_prepare: Optional[Callable] = None,
                 peer_finish: Optional[Callable] = None,
                 ttl_s: float = INTENT_TTL_S):
        self.store = store
        self._peer_prepare = peer_prepare
        self._peer_finish = peer_finish
        self.ttl_s = ttl_s

    @property
    def _engine(self) -> IKVEngine:
        return self.store.engine

    # -- phase A -------------------------------------------------------------
    def _write_rename_intent(self, src: str, dst: str, user,
                             src_pid: int, dst_pid: int) -> IntentRecord:
        st = self.store

        def op(txn: ITransaction) -> IntentRecord:
            sparent, sname, sinode = st._walk(txn, src, user,
                                              follow_last=False)
            if sname is None or sinode is None:
                raise _err(Code.META_NOT_FOUND, src)
            st._check_dir_writable(sparent, user)
            rec = IntentRecord(
                txn_id=new_txn_id(), kind=KIND_RENAME,
                src_pid=src_pid, dst_pid=dst_pid,
                inode_id=sinode.id, inode_type=int(sinode.type),
                src_parent=sparent.id, src_name=sname,
                is_dir=int(sinode.is_dir()),
                deadline=time.time() + self.ttl_s,
            )
            txn.set(intent_key(rec.txn_id), serialize(rec))
            return rec

        return with_transaction(self._engine, op)

    def _write_hardlink_intent(self, src: str, dst: str, user,
                               src_pid: int, dst_pid: int) -> IntentRecord:
        st = self.store

        def op(txn: ITransaction) -> IntentRecord:
            _, _, sinode = st._walk(txn, src, user)
            if sinode is None:
                raise _err(Code.META_NOT_FOUND, src)
            if sinode.is_dir():
                raise _err(Code.META_IS_DIRECTORY, src)
            dparent, dname, dexist = st._walk(txn, dst, user,
                                              follow_last=False)
            if dname is None or dexist is not None:
                raise _err(Code.META_EXISTS, dst)
            st._check_dir_writable(dparent, user)
            rec = IntentRecord(
                txn_id=new_txn_id(), kind=KIND_HARDLINK,
                src_pid=src_pid, dst_pid=dst_pid,
                inode_id=sinode.id, inode_type=int(sinode.type),
                dst_parent=dparent.id, dst_name=dname,
                deadline=time.time() + self.ttl_s,
            )
            txn.set(intent_key(rec.txn_id), serialize(rec))
            return rec

        return with_transaction(self._engine, op)

    # -- phase B (participant side; also the peer RPC handler body) ----------
    def prepare_rename(self, intent: IntentRecord, dst: str, user) -> None:
        """Create the dst dirent + prepare record on the dst partition.
        Idempotent per txn_id; refuses expired or vanished intents (the
        resolver may already be aborting them)."""
        st = self.store

        def op(txn: ITransaction) -> None:
            if _load_prepare(txn, intent.txn_id) is not None:
                return  # replayed prepare: effect already durable
            live = _load_intent(txn, intent.txn_id)
            if live is None or time.time() > live.deadline:
                raise _err(Code.META_TXN_EXPIRED,
                           f"intent {intent.txn_id} expired/aborted")
            dparent, dname, dexist = st._walk(txn, dst, user,
                                              follow_last=False)
            if dname is None:
                raise _err(Code.META_EXISTS, "/")
            if dexist is not None:
                if dexist.id == intent.inode_id:
                    return  # rename onto itself: no-op
                # cross-partition rename is NO-REPLACE by design: an
                # atomic replace would need the dst inode's teardown
                # staged behind the same intent (docs/metashard.md
                # limitations); callers remove dst first
                raise _err(Code.META_EXISTS, dst)
            st._check_dir_writable(dparent, user)
            st._store_dirent(txn, DirEntry(
                dparent.id, dname, intent.inode_id,
                InodeType(intent.inode_type)))
            txn.set(prepare_key(intent.txn_id), serialize(PrepareRecord(
                txn_id=intent.txn_id, kind=KIND_RENAME,
                coordinator_pid=intent.src_pid, inode_id=intent.inode_id,
                dst_parent=dparent.id, dst_name=dname)))

        with_transaction(self._engine, op)

    def prepare_hardlink(self, intent: IntentRecord) -> None:
        """Bump nlink on the inode's partition behind a prepare record
        (present <=> bumped exactly once)."""
        st = self.store

        def op(txn: ITransaction) -> None:
            if _load_prepare(txn, intent.txn_id) is not None:
                return
            live = _load_intent(txn, intent.txn_id)
            if live is None or time.time() > live.deadline:
                raise _err(Code.META_TXN_EXPIRED,
                           f"intent {intent.txn_id} expired/aborted")
            inode = st._load_inode(txn, intent.inode_id)
            if inode is None or inode.nlink <= 0:
                raise _err(Code.META_NOT_FOUND,
                           f"inode {intent.inode_id}")
            inode.nlink += 1
            inode.ctime = time.time()
            st._store_inode(txn, inode)
            txn.set(prepare_key(intent.txn_id), serialize(PrepareRecord(
                txn_id=intent.txn_id, kind=KIND_HARDLINK,
                coordinator_pid=intent.dst_pid,
                inode_id=intent.inode_id,
                dst_parent=intent.dst_parent,
                dst_name=intent.dst_name)))

        with_transaction(self._engine, op)

    # -- phase C -------------------------------------------------------------
    def _commit_rename(self, rec: IntentRecord, *,
                       guard: bool = True) -> None:
        """Guarded src-dirent clear + intent clear, one atomic txn. The
        guard (src dirent still points at the intent's inode) is what
        makes blind replay safe: a recreated src entry survives a stale
        intent's roll-forward. ``guard=False`` is the planted
        ``rename_orphan_intent`` bug shape — never passed by real code."""
        st = self.store

        def op(txn: ITransaction) -> None:
            if _load_intent(txn, rec.txn_id) is None:
                return  # already committed/aborted: replay no-op
            ent = st._load_dirent(txn, rec.src_parent, rec.src_name)
            if ent is not None and (not guard or ent.inode_id == rec.inode_id):
                txn.clear(dirent_key(rec.src_parent, rec.src_name))
            if rec.is_dir and rec.src_parent != rec.dst_parent:
                # inode-record carve-out: the dir inode's parent pointer
                # may live in a third partition; the shared KV keeps the
                # cross-partition write sound (docs/metashard.md)
                prep = _load_prepare(txn, rec.txn_id)
                inode = st._load_inode(txn, rec.inode_id)
                if inode is not None and prep is not None:
                    inode.parent = prep.dst_parent
                    st._store_inode(txn, inode)
            txn.clear(intent_key(rec.txn_id))

        with_transaction(self._engine, op)

    def _commit_hardlink(self, rec: IntentRecord) -> None:
        st = self.store

        def op(txn: ITransaction) -> None:
            if _load_intent(txn, rec.txn_id) is None:
                return
            if _load_prepare(txn, rec.txn_id) is None:
                raise _err(Code.META_TXN_EXPIRED,
                           f"hardlink {rec.txn_id} unprepared")
            ent = st._load_dirent(txn, rec.dst_parent, rec.dst_name)
            if ent is None:
                st._store_dirent(txn, DirEntry(
                    rec.dst_parent, rec.dst_name, rec.inode_id,
                    InodeType(rec.inode_type)))
            elif ent.inode_id != rec.inode_id:
                raise _err(Code.META_EXISTS, rec.dst_name)
            txn.clear(intent_key(rec.txn_id))

        with_transaction(self._engine, op)

    def _abort(self, rec: IntentRecord) -> None:
        """Clear the intent; undo a hardlink's prepared nlink bump behind
        its prepare record (present <=> bump applied, so the undo is
        exactly-once too)."""
        st = self.store

        def op(txn: ITransaction) -> None:
            if _load_intent(txn, rec.txn_id) is None:
                return
            prep = _load_prepare(txn, rec.txn_id)
            if prep is not None and rec.kind == KIND_HARDLINK:
                inode = st._load_inode(txn, rec.inode_id)
                if inode is not None and inode.nlink > 1:
                    inode.nlink -= 1
                    st._store_inode(txn, inode)
                txn.clear(prepare_key(rec.txn_id))
            if prep is not None and rec.kind == KIND_RENAME:
                ent = st._load_dirent(txn, prep.dst_parent, prep.dst_name)
                if ent is not None and ent.inode_id == rec.inode_id:
                    txn.clear(dirent_key(prep.dst_parent, prep.dst_name))
                txn.clear(prepare_key(rec.txn_id))
            txn.clear(intent_key(rec.txn_id))

        with_transaction(self._engine, op)

    def _finish(self, txn_id: str) -> None:
        def op(txn: ITransaction) -> None:
            txn.clear(prepare_key(txn_id))

        with_transaction(self._engine, op)

    # -- the driving sequence ------------------------------------------------
    def rename(self, src: str, dst: str, user,
               src_pid: int, dst_pid: int) -> None:
        rec = self._write_rename_intent(src, dst, user, src_pid, dst_pid)
        inject("meta.twophase.intent")
        try:
            if self._peer_prepare is not None:
                self._peer_prepare(dst_pid, rec, dst)
            else:
                self.prepare_rename(rec, dst, user)
        except FsError:
            self._abort(rec)
            raise
        inject("meta.twophase.prepared")
        self._commit_rename(rec)
        inject("meta.twophase.committed")
        if self._peer_finish is not None:
            try:
                self._peer_finish(dst_pid, rec.txn_id)
            except FsError:
                pass  # orphan prepare record: the resolver clears it
        else:
            self._finish(rec.txn_id)

    def hard_link(self, src: str, dst: str, user,
                  src_pid: int, dst_pid: int):
        rec = self._write_hardlink_intent(src, dst, user, src_pid, dst_pid)
        inject("meta.twophase.intent")
        ino_pid = rec.src_pid
        try:
            if self._peer_prepare is not None:
                self._peer_prepare(ino_pid, rec, src)
            else:
                self.prepare_hardlink(rec)
        except FsError:
            self._abort(rec)
            raise
        inject("meta.twophase.prepared")
        try:
            self._commit_hardlink(rec)
        except FsError:
            self._abort(rec)
            raise
        inject("meta.twophase.committed")
        if self._peer_finish is not None:
            try:
                self._peer_finish(ino_pid, rec.txn_id)
            except FsError:
                pass
        else:
            self._finish(rec.txn_id)
        return self.store.batch_stat([rec.inode_id])[0]


# -- the idempotent crash resolver -------------------------------------------

def list_intents(engine: IKVEngine) -> List[IntentRecord]:
    def op(txn: ITransaction):
        begin, end = intent_scan_range()
        return [deserialize(p.value, IntentRecord)
                for p in txn.get_range(begin, end, snapshot=True)]

    return with_transaction(engine, op, read_only=True)


def list_prepares(engine: IKVEngine) -> List[PrepareRecord]:
    def op(txn: ITransaction):
        begin, end = prepare_scan_range()
        return [deserialize(p.value, PrepareRecord)
                for p in txn.get_range(begin, end, snapshot=True)]

    return with_transaction(engine, op, read_only=True)


def resolve_intents(store, *, now: Optional[float] = None,
                    force: bool = False,
                    pids: Optional[set] = None) -> int:
    """Converge every dangling two-phase record (the crash matrix above).
    Safe to run anywhere, anytime, repeatedly: every action re-validates
    under its own txn and is guarded, so concurrent resolvers — or a
    resolver racing a live coordinator (hence the deadline gate;
    ``force`` is for tests and quiesce) — never double-apply. Returns
    records resolved. ``pids`` restricts to intents whose coordinator
    partition is in the set (an owner resolving only its own partitions);
    None resolves all (drive quiesce, single-process recovery)."""
    co = TwoPhaseCoordinator(store)
    engine = store.engine
    now = time.time() if now is None else now
    resolved = 0
    for rec in list_intents(engine):
        coord_pid = (rec.src_pid if rec.kind == KIND_RENAME
                     else rec.dst_pid)
        if pids is not None and coord_pid not in pids:
            continue
        if not force and now <= rec.deadline:
            continue  # the coordinator may still be driving it
        prepared = with_transaction(
            engine, lambda txn, t=rec.txn_id: _load_prepare(txn, t),
            read_only=True) is not None
        if not prepared:
            co._abort(rec)
            resolved += 1
            continue
        # roll forward. The inode GUARD on the src-dirent clear is the
        # load-bearing line: without it a stale intent's replay clears
        # whatever now lives at (src_parent, src_name) — the historic
        # rename_orphan_intent bug, re-plantable via chaos/bugs.py.
        guard = not bug_fire("rename_orphan_intent")
        if rec.kind == KIND_RENAME:
            co._commit_rename(rec, guard=guard)
        else:
            co._commit_hardlink(rec)
        co._finish(rec.txn_id)
        resolved += 1
    # orphan prepare records (crash between commit and finish): the
    # intent is gone, so the op committed — the record is litter
    for prep in list_prepares(engine):
        gone = with_transaction(
            engine, lambda txn, t=prep.txn_id: _load_intent(txn, t),
            read_only=True) is None
        if gone:
            co._finish(prep.txn_id)
            resolved += 1
    if resolved:
        from tpu3fs_torch.metashard import metrics

        metrics.intents_resolved.add(resolved)
    return resolved
