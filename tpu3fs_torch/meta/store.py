"""Metadata store: every FS operation as a transaction over the KV engine.

The port's own copy of ``tpu3fs/meta/store.py``,
unchanged but for its imports.

Re-expresses the reference's meta service (src/meta/store/ops/*): each op
(create/open/mkdirs/remove/rename/...) runs inside one KV transaction via the
retry driver, so concurrent conflicting ops serialize optimistically exactly
like the reference's FDB transactions (src/meta/service/MetaOperator.cc runOp;
src/common/kv/WithTransaction.h retry loop). The service is stateless: any
meta server instance can run any op against the shared KV.

Semantics ported (not code): path walk with symlink depth limits
(src/meta/store/PathResolve.cc), rename loop detection
(src/meta/store/ops/Rename.cc), idempotent remove/close via "IDEM" records
(src/meta/store/Idempotent.h:22-45), write-open sessions ("INOS",
src/meta/store/FileSession.cc), GC queue for deferred chunk reclamation
(src/meta/components/GcManager.cc), eventual-length hints with precise length
on close/fsync (docs/design_notes.md "Dynamic file attributes",
src/meta/components/FileHelper.cc).
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from tpu3fs_torch.kv.kv import IKVEngine, ITransaction, with_transaction
from tpu3fs_torch.meta.types import (
    Acl,
    DirEntry,
    FileSession,
    Inode,
    InodeType,
    Layout,
    PERM_R,
    PERM_W,
    PERM_X,
    ROOT_INODE_ID,
    dirent_key,
    dirent_scan_range,
    gc_key,
    gc_scan_range,
    idempotent_key,
    inode_key,
    session_key,
    session_scan_range,
)
from tpu3fs_torch.rpc.serde import deserialize, serialize
from tpu3fs_torch.utils.result import Code, FsError
from tpu3fs_torch.utils.result import err as _err

MAX_SYMLINK_DEPTH = 10
MAX_NAME_LEN = 255

_INODE_COUNTER_KEY = b"INOA" + b"counter"


@dataclass
class User:
    uid: int = 0
    gid: int = 0
    groups: tuple = ()
    root: bool = False

    @property
    def is_root(self) -> bool:
        return self.uid == 0 or self.root


ROOT_USER = User(0, 0)


class InodeIdAllocator:
    """Monotonic inode ids handed out in blocks to cut KV conflicts
    (ref src/meta/components/InodeIdAllocator.cc)."""

    def __init__(self, engine: IKVEngine, block: int = 64):
        self._engine = engine
        self._block = block
        self._lock = threading.Lock()
        self._next = 0
        self._limit = 0

    def allocate(self) -> int:
        with self._lock:
            if self._next >= self._limit:
                def grab(txn: ITransaction) -> int:
                    raw = txn.get(_INODE_COUNTER_KEY)
                    cur = int(raw) if raw else ROOT_INODE_ID + 1
                    txn.set(_INODE_COUNTER_KEY, str(cur + self._block).encode())
                    return cur

                self._next = with_transaction(self._engine, grab)
                self._limit = self._next + self._block
            out = self._next
            self._next += 1
            return out


class ChainAllocator:
    """Round-robin + shuffle-seed chain selection for new files
    (ref src/meta/components/ChainAllocator.h)."""

    def __init__(self, table_id: int, chain_ids: List[int]):
        self.table_id = table_id
        self.chain_ids = list(chain_ids)
        self._cursor = 0
        self._lock = threading.Lock()

    def allocate(self, stripe_size: int) -> Tuple[int, List[int], int]:
        with self._lock:
            n = len(self.chain_ids)
            stripe = min(stripe_size, n)
            picked = [
                self.chain_ids[(self._cursor + i) % n] for i in range(stripe)
            ]
            self._cursor = (self._cursor + stripe) % n
            seed = int(time.time_ns()) & 0x7FFFFFFF
            return self.table_id, picked, seed


class OpenFlags:
    READ = 1
    WRITE = 2
    CREATE = 4
    TRUNC = 8
    EXCL = 16
    DIRECTORY = 32


@dataclass
class BatchCloseItem:
    """One close in a batch settle (wire-friendly: -1 = unset)."""

    inode_id: int = 0
    session_id: str = ""
    length_hint: int = -1
    client_id: str = ""
    request_id: str = ""
    wrote: int = -1              # -1 unset / 0 false / 1 true


@dataclass
class BatchCreateItem:
    """One create in a batched open (wire-friendly: 0 = unset). The
    optional explicit layout pins chains the way MetaStore.create's
    ``layout=`` does — the ckpt archiver placing files on EC chains."""

    path: str = ""
    perm: int = 0o644
    flags: int = 0
    chunk_size: int = 0
    stripe: int = 0
    client_id: str = ""
    layout: Optional[Layout] = None


@dataclass
class OpenResult:
    inode: Inode
    session_id: str = ""


@dataclass
class StatFs:
    capacity: int = 0
    used: int = 0
    files: int = 0


class MetaStore:
    """Stateless metadata operations over a transactional KV engine."""

    def __init__(
        self,
        engine: IKVEngine,
        chain_allocator: Optional[ChainAllocator] = None,
        *,
        file_length_hook: Optional[Callable[[Inode], int]] = None,
        truncate_hook: Optional[Callable[[Inode, int], None]] = None,
        space_hook: Optional[Callable[[], Tuple[int, int]]] = None,
        default_chunk_size: int = 1 << 20,
        default_stripe: int = 1,
        event_log=None,
    ):
        self._engine = engine
        self._ids = InodeIdAllocator(engine)
        # optional structured meta event stream (ref src/meta/event/Event.cc)
        self._events = event_log
        self._chains = chain_allocator or ChainAllocator(1, [1])
        # queries storage for the real last-chunk length on close/fsync
        # (ref FileHelper.cc queryLastChunk)
        self._file_length_hook = file_length_hook
        # trims/removes storage chunks past the new EOF (ref: meta truncate
        # goes through the storage client in the reference too)
        self._truncate_hook = truncate_hook
        # cluster (capacity, used) from storage spaceInfo; statFs then
        # reports physical space, not summed logical lengths (ref statFs
        # aggregating storage space)
        self._space_hook = space_hook
        self._default_chunk_size = default_chunk_size
        self._default_stripe = default_stripe
        self._ensure_root()

    @property
    def engine(self) -> IKVEngine:
        """The underlying KV engine (subsystems that keep their own small
        records — e.g. ckpt save sessions — share the meta keyspace)."""
        return self._engine

    # -- low-level codecs ---------------------------------------------------
    def _emit(self, op: str, path: str, *, inode_id: int = 0,
              uid: int = 0, detail: str = "") -> None:
        if self._events is not None:
            try:
                self._events.append(op, path, inode_id=inode_id, uid=uid,
                                    detail=detail)
            except Exception:
                pass  # event stream is best-effort observability

    @staticmethod
    def _load_inode(txn: ITransaction, inode_id: int) -> Optional[Inode]:
        raw = txn.get(inode_key(inode_id))
        return deserialize(raw, Inode) if raw else None

    @staticmethod
    def _store_inode(txn: ITransaction, inode: Inode) -> None:
        txn.set(inode_key(inode.id), serialize(inode))

    @staticmethod
    def _load_dirent(txn: ITransaction, parent: int, name: str) -> Optional[DirEntry]:
        raw = txn.get(dirent_key(parent, name))
        return deserialize(raw, DirEntry) if raw else None

    @staticmethod
    def _store_dirent(txn: ITransaction, ent: DirEntry) -> None:
        txn.set(dirent_key(ent.parent, ent.name), serialize(ent))

    def _ensure_root(self) -> None:
        def init(txn: ITransaction):
            if txn.get(inode_key(ROOT_INODE_ID)) is None:
                root = Inode.new_dir(ROOT_INODE_ID, Acl(0, 0, 0o777), ROOT_INODE_ID)
                self._store_inode(txn, root)

        with_transaction(self._engine, init)

    # -- path resolution (ref src/meta/store/PathResolve.cc) ----------------
    @staticmethod
    def _split(path: str) -> List[str]:
        if not path.startswith("/"):
            raise _err(Code.META_INVALID_PATH, f"path must be absolute: {path}")
        parts = [p for p in path.split("/") if p and p != "."]
        for p in parts:
            if len(p) > MAX_NAME_LEN:
                raise _err(Code.META_NAME_TOO_LONG, p[:32])
        out: List[str] = []
        for p in parts:
            if p == "..":
                if out:
                    out.pop()
            else:
                out.append(p)
        return out

    def _walk(
        self,
        txn: ITransaction,
        path: str,
        user: User,
        *,
        follow_last: bool = True,
        _depth: int = 0,
    ) -> Tuple[Inode, Optional[str], Optional[Inode]]:
        """-> (parent dir inode, last component name or None for '/',
               resolved inode or None)."""
        if _depth > MAX_SYMLINK_DEPTH:
            raise _err(Code.META_TOO_MANY_SYMLINKS, path)
        parts = self._split(path)
        cur = self._load_inode(txn, ROOT_INODE_ID)
        assert cur is not None
        if not parts:
            return cur, None, cur
        parent = cur
        for i, name in enumerate(parts):
            if not parent.is_dir():
                raise _err(Code.META_NOT_DIRECTORY, "/" + "/".join(parts[:i]))
            if not parent.acl.check_user(user, PERM_X):
                raise _err(Code.META_NO_PERMISSION, "/" + "/".join(parts[:i]))
            ent = self._load_dirent(txn, parent.id, name)
            if ent is None:
                if i == len(parts) - 1:
                    return parent, name, None
                raise _err(Code.META_NOT_FOUND, "/" + "/".join(parts[: i + 1]))
            child = self._load_inode(txn, ent.inode_id)
            if child is None:
                raise _err(Code.META_NOT_FOUND, f"dangling dirent {ent.inode_id}")
            last = i == len(parts) - 1
            if child.is_symlink() and (follow_last or not last):
                target = child.symlink_target
                if not target.startswith("/"):
                    target = "/" + "/".join(parts[:i]) + "/" + target
                rest = "/".join(parts[i + 1 :])
                full = target + ("/" + rest if rest else "")
                return self._walk(
                    txn, full, user, follow_last=follow_last, _depth=_depth + 1
                )
            if last:
                return parent, name, child
            parent = child
        raise AssertionError("unreachable")

    # -- ops ---------------------------------------------------------------
    def stat(self, path: str, user: User = ROOT_USER, *, follow: bool = True) -> Inode:
        def op(txn: ITransaction) -> Inode:
            _, _, inode = self._walk(txn, path, user, follow_last=follow)
            if inode is None:
                raise _err(Code.META_NOT_FOUND, path)
            return inode

        return with_transaction(self._engine, op, read_only=True)

    def batch_stat(self, inode_ids: List[int],
                   user: Optional[User] = None) -> List[Optional[Inode]]:
        """With a user, inodes the user lacks read permission on come back
        as None (auth mode: inode-id access skips the path walk, so the
        per-inode read bit is the enforceable check)."""

        def op(txn: ITransaction):
            out = []
            for i in inode_ids:
                ino = self._load_inode(txn, i)
                if (ino is not None and user is not None
                        and not ino.acl.check_user(user, PERM_R)):
                    ino = None
                out.append(ino)
            return out

        return with_transaction(self._engine, op, read_only=True)

    def batch_stat_by_path(
        self, paths: List[str], user: User = ROOT_USER,
        *, txn_batch: int = 64,
    ) -> List[Optional[Inode]]:
        """Walk many paths per read-only transaction instead of one txn
        per path (the kvcache batch_get / prefix-probe shape: 64 stats
        used to pay 64 transaction setups). Missing/forbidden paths come
        back as None."""
        out: List[Optional[Inode]] = []
        for base in range(0, len(paths), txn_batch):
            chunk = paths[base:base + txn_batch]

            def op(txn: ITransaction, _chunk=chunk):
                res: List[Optional[Inode]] = []
                for p in _chunk:
                    try:
                        _, _, inode = self._walk(txn, p, user)
                        res.append(inode)
                    except FsError:
                        res.append(None)
                return res

            out.extend(with_transaction(self._engine, op, read_only=True))
        return out

    def mkdirs(
        self,
        path: str,
        user: User = ROOT_USER,
        perm: int = 0o755,
        *,
        recursive: bool = False,
    ) -> Inode:
        def op(txn: ITransaction) -> Inode:
            return self._mkdirs_in_txn(txn, path, user, perm,
                                       recursive=recursive)

        result = with_transaction(self._engine, op)
        self._emit("mkdir", path, inode_id=result.id, uid=user.uid)
        return result

    def _mkdirs_in_txn(
        self,
        txn: ITransaction,
        path: str,
        user: User,
        perm: int,
        *,
        recursive: bool = False,
        exist_ok: bool = False,
    ) -> Inode:
        """One mkdirs inside an already-open transaction — shared by
        mkdirs() and batch_mkdirs(). All reads and permission checks
        precede the first mutation, so a per-item FsError caught by the
        batch leaves zero buffered writes for that item."""
        parts = self._split(path)
        if not parts:
            raise _err(Code.META_EXISTS, "/")
        parent = self._load_inode(txn, ROOT_INODE_ID)
        created: Optional[Inode] = None
        for i, name in enumerate(parts):
            last = i == len(parts) - 1
            ent = self._load_dirent(txn, parent.id, name)
            if ent is not None:
                child = self._load_inode(txn, ent.inode_id)
                if last:
                    if exist_ok and child is not None and child.is_dir():
                        return child
                    raise _err(Code.META_EXISTS, path)
                if not child.is_dir():
                    raise _err(Code.META_NOT_DIRECTORY, name)
                parent = child
                continue
            if not last and not recursive:
                raise _err(Code.META_NOT_FOUND, name)
            self._check_dir_writable(parent, user)
            child = Inode.new_dir(
                self._ids.allocate(), Acl(user.uid, user.gid, perm), parent.id
            )
            self._store_inode(txn, child)
            self._store_dirent(
                txn, DirEntry(parent.id, name, child.id, InodeType.DIRECTORY)
            )
            parent = child
            created = child
        assert created is not None
        return created

    def batch_mkdirs(
        self,
        paths: List[str],
        user: User = ROOT_USER,
        perm: int = 0o755,
        *,
        recursive: bool = True,
        exist_ok: bool = True,
        txn_batch: int = 64,
    ) -> List[object]:
        """Ensure MANY directories in O(len/txn_batch) KV transactions
        instead of one round trip per directory — the kvcache cold-drain
        shape, where ``_ensure_dir`` used to pay one mkdirs RPC per
        uncached shard directory. ``exist_ok`` returns the existing dir
        inode instead of META_EXISTS (mkdir -p semantics). Each result is
        an Inode or an FsError; per-item failures don't poison their
        batch-mates, and a KV conflict retries the whole chunk via
        with_transaction."""
        results: List[object] = [None] * len(paths)
        for base in range(0, len(paths), txn_batch):
            chunk = list(enumerate(paths[base:base + txn_batch], start=base))

            def op(txn: ITransaction, _chunk=chunk):
                out = []
                for i, p in _chunk:
                    try:
                        out.append((i, self._mkdirs_in_txn(
                            txn, p, user, perm, recursive=recursive,
                            exist_ok=exist_ok)))
                    except FsError as e:
                        out.append((i, e))
                return out

            for i, res in with_transaction(self._engine, op):
                results[i] = res
        for p, res in zip(paths, results):
            if isinstance(res, Inode):
                self._emit("mkdir", p, inode_id=res.id, uid=user.uid)
        return results

    def _check_dir_writable(self, d: Inode, user: User) -> None:
        if not d.acl.check_user(user, PERM_W | PERM_X):
            raise _err(Code.META_NO_PERMISSION, f"dir {d.id}")
        if d.locked_by:
            raise _err(Code.META_NO_PERMISSION, f"dir {d.id} locked by {d.locked_by}")

    def create(
        self,
        path: str,
        user: User = ROOT_USER,
        perm: int = 0o644,
        *,
        flags: int = 0,
        chunk_size: Optional[int] = None,
        stripe: Optional[int] = None,
        client_id: str = "",
        layout: Optional[Layout] = None,
    ) -> OpenResult:
        """Create (and open) a regular file (ref src/meta/store/ops/Open.cc).

        An explicit `layout` overrides the chain allocator — callers that
        must place a file on specific chains (the checkpoint archiver
        re-encoding onto EC chains) pass the full Layout; everyone else
        gets allocator striping."""
        layout = self._resolve_create_layout(chunk_size, stripe, layout)

        def op(txn: ITransaction) -> OpenResult:
            return self._create_in_txn(txn, path, user, perm, flags,
                                       client_id, layout)

        result = with_transaction(self._engine, op)
        self._maybe_truncate_chunks(result, flags)
        self._emit("create", path, inode_id=result.inode.id, uid=user.uid)
        return result

    def _resolve_create_layout(
        self,
        chunk_size: Optional[int],
        stripe: Optional[int],
        layout: Optional[Layout],
    ) -> Layout:
        if layout is None:
            table_id, chains, seed = self._chains.allocate(
                stripe or self._default_stripe)
            return Layout(
                table_id=table_id,
                chains=chains,
                chunk_size=chunk_size or self._default_chunk_size,
                seed=seed,
            )
        if not layout.chains:
            raise _err(Code.META_BAD_LAYOUT, "explicit layout without chains")
        return layout

    def _create_in_txn(
        self,
        txn: ITransaction,
        path: str,
        user: User,
        perm: int,
        flags: int,
        client_id: str,
        layout: Layout,
    ) -> OpenResult:
        parent, name, existing = self._walk(txn, path, user)
        if name is None:
            raise _err(Code.META_IS_DIRECTORY, "/")
        if existing is not None:
            if flags & OpenFlags.EXCL:
                raise _err(Code.META_EXISTS, path)
            return self._do_open(txn, existing, user, flags, client_id)
        self._check_dir_writable(parent, user)
        inode = Inode.new_file(
            self._ids.allocate(), Acl(user.uid, user.gid, perm), layout
        )
        self._store_inode(txn, inode)
        self._store_dirent(
            txn, DirEntry(parent.id, name, inode.id, InodeType.FILE)
        )
        session_id = ""
        if flags & OpenFlags.WRITE:
            session_id = self._add_session(txn, inode.id, client_id,
                                           user.uid)
        return OpenResult(inode, session_id)

    def batch_create(
        self,
        items: List["BatchCreateItem"],
        user: User = ROOT_USER,
        *,
        txn_batch: int = 64,
    ) -> List[object]:
        """Create (and open) MANY regular files in O(len/txn_batch) KV
        transactions — the create fan-in behind KVCacheClient.batch_put
        and the ckpt archiver (one meta transaction per 64 files instead
        of one round trip per file). Each result is an OpenResult or an
        FsError: per-item failures (missing parent, EXCL conflict,
        permission) don't poison their batch-mates; a KV conflict retries
        the whole chunk via with_transaction. Chain allocation happens up
        front per item, so allocator striping is identical to N singleton
        creates."""
        prepped: List[object] = []
        for it in items:
            try:
                prepped.append(self._resolve_create_layout(
                    it.chunk_size or None, it.stripe or None, it.layout))
            except FsError as e:
                prepped.append(e)
        results: List[object] = [None] * len(items)
        for base in range(0, len(items), txn_batch):
            chunk = list(enumerate(items[base:base + txn_batch], start=base))

            def op(txn: ITransaction, _chunk=chunk):
                out = []
                for i, it in _chunk:
                    if isinstance(prepped[i], FsError):
                        out.append((i, prepped[i]))
                        continue
                    try:
                        out.append((i, self._create_in_txn(
                            txn, it.path, user, it.perm, it.flags,
                            it.client_id, prepped[i])))
                    except FsError as e:
                        out.append((i, e))
                return out

            for i, res in with_transaction(self._engine, op):
                results[i] = res
        for it, res in zip(items, results):
            if isinstance(res, OpenResult):
                self._maybe_truncate_chunks(res, it.flags)
                self._emit("create", it.path, inode_id=res.inode.id,
                           uid=user.uid)
        return results

    def open(
        self,
        path: str,
        user: User = ROOT_USER,
        *,
        flags: int = OpenFlags.READ,
        client_id: str = "",
    ) -> OpenResult:
        def op(txn: ITransaction) -> OpenResult:
            _, _, inode = self._walk(txn, path, user)
            if inode is None:
                raise _err(Code.META_NOT_FOUND, path)
            return self._do_open(txn, inode, user, flags, client_id)

        result = with_transaction(self._engine, op)
        self._maybe_truncate_chunks(result, flags)
        return result

    def _maybe_truncate_chunks(self, result: "OpenResult", flags: int) -> None:
        # O_TRUNC reclaims existing chunks through storage, outside the KV
        # transaction (storage truncate is idempotent, so a meta retry is safe)
        if (
            flags & OpenFlags.TRUNC
            and self._truncate_hook is not None
            and result.inode.is_file()
        ):
            self._truncate_hook(result.inode, 0)

    def _do_open(
        self, txn: ITransaction, inode: Inode, user: User, flags: int, client_id: str
    ) -> OpenResult:
        if inode.is_dir() and flags & (OpenFlags.WRITE | OpenFlags.TRUNC):
            raise _err(Code.META_IS_DIRECTORY, str(inode.id))
        want = 0
        if flags & OpenFlags.READ:
            want |= PERM_R
        if flags & OpenFlags.WRITE:
            want |= PERM_W
        if want and not inode.acl.check_user(user, want):
            raise _err(Code.META_NO_PERMISSION, str(inode.id))
        session_id = ""
        if inode.is_file() and flags & OpenFlags.WRITE:
            if flags & OpenFlags.TRUNC and inode.length:
                inode.length = 0
                inode.mtime = time.time()
                self._store_inode(txn, inode)
            session_id = self._add_session(txn, inode.id, client_id, user.uid)
        return OpenResult(inode, session_id)

    def _add_session(self, txn: ITransaction, inode_id: int, client_id: str,
                     uid: int = 0) -> str:
        session_id = uuid.uuid4().hex
        sess = FileSession(inode_id, client_id, session_id, time.time(), uid)
        txn.set(session_key(inode_id, session_id), serialize(sess))
        return session_id

    def list_sessions(self, inode_id: Optional[int] = None) -> List[FileSession]:
        def op(txn: ITransaction):
            begin, end = session_scan_range(inode_id)
            return [
                deserialize(p.value, FileSession)
                for p in txn.get_range(begin, end, snapshot=True)
            ]

        return with_transaction(self._engine, op, read_only=True)

    def close(
        self,
        inode_id: int,
        session_id: str,
        *,
        length_hint: Optional[int] = None,
        client_id: str = "",
        request_id: str = "",
        wrote: Optional[bool] = None,
        user: Optional[User] = None,
    ) -> Inode:
        """Close a write session; settle the precise file length
        (ref src/meta/store/ops/Close; FileHelper queryLastChunk).

        mtime only moves if the session wrote (wrote=True, or unspecified
        with a length hint present) — a read-only open+close must not look
        like a modification."""

        def op(txn: ITransaction) -> Inode:
            return self._close_in_txn(
                txn, inode_id, session_id, length_hint=length_hint,
                client_id=client_id, request_id=request_id, wrote=wrote,
                user=user)

        return with_transaction(self._engine, op)

    def _close_in_txn(
        self,
        txn: ITransaction,
        inode_id: int,
        session_id: str,
        *,
        length_hint: Optional[int] = None,
        client_id: str = "",
        request_id: str = "",
        wrote: Optional[bool] = None,
        user: Optional[User] = None,
    ) -> Inode:
        """One close inside an already-open transaction — shared by close()
        and batch_close() (ref BatchOperation.cc:750 batches exactly these
        inode settles into one transaction)."""
        # ORDER MATTERS for batch_close: every read/permission check and
        # the (possibly RPC-backed, possibly raising) length hook run
        # BEFORE the first mutation, so a per-item FsError caught by the
        # batch leaves zero buffered writes for that item in the shared
        # transaction — a failed item must not half-commit (session gone,
        # length unsettled).
        # the cache key is scoped to the caller's identity in auth mode:
        # a replay of another client's (client_id, request_id) by a
        # different user misses and must pass authorization below
        ckey = idempotent_key(client_id, request_id,
                              None if user is None else user.uid)
        if request_id:
            cached = txn.get(ckey)
            if cached is not None:
                return deserialize(cached, Inode)
        inode = self._load_inode(txn, inode_id)
        if inode is None:
            raise _err(Code.META_NOT_FOUND, str(inode_id))
        skey = session_key(inode_id, session_id)
        if session_id:
            raw = txn.get(skey)
            if raw is None:
                raise _err(Code.META_NO_SESSION, session_id)
            if user is not None:
                # the session is the capability granted at open: closing
                # authorizes against its owner, not the live ACL (a chmod
                # between open and close must not wedge the session)
                sess = deserialize(raw, FileSession)
                if not (user.is_root or sess.uid == user.uid):
                    raise _err(Code.META_NO_PERMISSION, session_id)
        elif user is not None and not inode.acl.check_user(user, PERM_W):
            # sessionless length settle falls back to the ACL
            raise _err(Code.META_NO_PERMISSION, str(inode_id))
        store_inode = False
        if inode.is_file():
            if self._file_length_hook is not None:
                inode.length = self._file_length_hook(inode)  # may raise
            elif length_hint is not None:
                inode.length = max(inode.length, length_hint)
            if wrote or (wrote is None and length_hint is not None):
                inode.mtime = time.time()
            store_inode = True
        # -- mutations (nothing above may raise past here) -------------------
        if session_id:
            txn.clear(skey)
        if store_inode:
            self._store_inode(txn, inode)
        if request_id:
            txn.set(ckey, serialize(inode))
        return inode

    def batch_close(
        self,
        items: List["BatchCloseItem"],
        user: Optional[User] = None,
        *,
        txn_batch: int = 64,
    ) -> List[object]:
        """Settle MANY write sessions' lengths in O(len/txn_batch) KV
        transactions instead of one per file (ref src/meta/store/ops/
        BatchOperation.cc:750 — batched inode updates behind the
        Distributor). Per-item failures (missing inode/session, permission)
        come back as FsError entries without failing their batch-mates;
        a KV conflict retries the whole chunk via with_transaction."""
        results: List[object] = [None] * len(items)
        for base in range(0, len(items), txn_batch):
            chunk = list(enumerate(items[base:base + txn_batch], start=base))

            def op(txn: ITransaction, _chunk=chunk):
                out = []
                for i, it in _chunk:
                    try:
                        out.append((i, self._close_in_txn(
                            txn, it.inode_id, it.session_id,
                            length_hint=(it.length_hint
                                         if it.length_hint >= 0 else None),
                            client_id=it.client_id,
                            request_id=it.request_id,
                            wrote=(None if it.wrote < 0 else bool(it.wrote)),
                            user=user)))
                    except FsError as e:
                        out.append((i, e))
                return out

            for i, res in with_transaction(self._engine, op):
                results[i] = res
        return results

    def sync(self, inode_id: int, *, length_hint: Optional[int] = None,
             user: Optional[User] = None) -> Inode:
        """fsync: refresh the length hint without closing the session.
        With a user, requires write permission on the inode OR a live write
        session the user opened (so a chmod after open cannot wedge an
        in-flight writer's fsync)."""

        def op(txn: ITransaction) -> Inode:
            inode = self._load_inode(txn, inode_id)
            if inode is None:
                raise _err(Code.META_NOT_FOUND, str(inode_id))
            if user is not None and not inode.acl.check_user(user, PERM_W):
                begin, end = session_scan_range(inode_id)
                owns = any(
                    deserialize(p.value, FileSession).uid == user.uid
                    for p in txn.get_range(begin, end, snapshot=True)
                )
                if not owns:
                    raise _err(Code.META_NO_PERMISSION, str(inode_id))
            if inode.is_file():
                if self._file_length_hook is not None:
                    inode.length = self._file_length_hook(inode)
                elif length_hint is not None and length_hint > inode.length:
                    inode.length = length_hint
                inode.length_hint_ver += 1
                self._store_inode(txn, inode)
            return inode

        return with_transaction(self._engine, op)

    def prune_session(self, client_id: str,
                      user: Optional[User] = None, *,
                      admin: bool = False) -> int:
        """Drop all sessions of a dead client (ref SessionManager prune).
        With a user, pruning requires root or the admin flag — it destroys
        other clients' live write sessions."""
        if user is not None and not (user.is_root or admin):
            raise _err(Code.META_NO_PERMISSION,
                       "prune-session requires admin")

        def op(txn: ITransaction) -> int:
            begin, end = session_scan_range()
            dropped = 0
            for pair in txn.get_range(begin, end, snapshot=True):
                sess = deserialize(pair.value, FileSession)
                if sess.client_id == client_id:
                    txn.clear(pair.key)
                    dropped += 1
            return dropped

        return with_transaction(self._engine, op)

    def symlink(self, path: str, target: str, user: User = ROOT_USER) -> Inode:
        def op(txn: ITransaction) -> Inode:
            parent, name, existing = self._walk(txn, path, user, follow_last=False)
            if name is None or existing is not None:
                raise _err(Code.META_EXISTS, path)
            self._check_dir_writable(parent, user)
            inode = Inode.new_symlink(
                self._ids.allocate(), Acl(user.uid, user.gid, 0o777), target
            )
            self._store_inode(txn, inode)
            self._store_dirent(
                txn, DirEntry(parent.id, name, inode.id, InodeType.SYMLINK)
            )
            return inode

        result = with_transaction(self._engine, op)
        self._emit("symlink", path, inode_id=result.id, uid=user.uid,
                   detail=target)
        return result

    def hard_link(self, src: str, dst: str, user: User = ROOT_USER) -> Inode:
        def op(txn: ITransaction) -> Inode:
            _, _, inode = self._walk(txn, src, user)
            if inode is None:
                raise _err(Code.META_NOT_FOUND, src)
            if inode.is_dir():
                raise _err(Code.META_IS_DIRECTORY, src)
            parent, name, existing = self._walk(txn, dst, user, follow_last=False)
            if name is None or existing is not None:
                raise _err(Code.META_EXISTS, dst)
            self._check_dir_writable(parent, user)
            inode.nlink += 1
            inode.ctime = time.time()
            self._store_inode(txn, inode)
            self._store_dirent(txn, DirEntry(parent.id, name, inode.id, inode.type))
            return inode

        return with_transaction(self._engine, op)

    def list_dir(
        self, path: str, user: User = ROOT_USER, *, limit: int = 0, prefix: str = ""
    ) -> List[DirEntry]:
        def op(txn: ITransaction) -> List[DirEntry]:
            _, _, inode = self._walk(txn, path, user)
            if inode is None:
                raise _err(Code.META_NOT_FOUND, path)
            if not inode.is_dir():
                raise _err(Code.META_NOT_DIRECTORY, path)
            if not inode.acl.check_user(user, PERM_R):
                raise _err(Code.META_NO_PERMISSION, path)
            begin, end = dirent_scan_range(inode.id)
            if prefix:
                begin = dirent_key(inode.id, prefix)
            ents = [
                deserialize(p.value, DirEntry)
                for p in txn.get_range(begin, end, limit=limit, snapshot=True)
            ]
            if prefix:
                ents = [e for e in ents if e.name.startswith(prefix)]
            return ents

        return with_transaction(self._engine, op, read_only=True)

    def remove(
        self,
        path: str,
        user: User = ROOT_USER,
        *,
        recursive: bool = False,
        client_id: str = "",
        request_id: str = "",
    ) -> None:
        """Unlink a file (chunks reclaimed by GC) or remove a directory
        (ref src/meta/store/ops/Remove.cc; GcManager)."""

        def op(txn: ITransaction) -> None:
            if request_id:
                if txn.get(idempotent_key(client_id, request_id)) is not None:
                    return
            parent, name, inode = self._walk(txn, path, user, follow_last=False)
            if name is None:
                raise _err(Code.META_INVALID_PATH, "cannot remove /")
            if inode is None:
                raise _err(Code.META_NOT_FOUND, path)
            self._check_dir_writable(parent, user)
            self._remove_inode(txn, parent.id, name, inode, recursive)
            if request_id:
                txn.set(idempotent_key(client_id, request_id), b"1")

        result = with_transaction(self._engine, op)
        self._emit("remove", path, uid=user.uid,
                   detail="recursive" if recursive else "")
        return result

    def _remove_inode(
        self, txn: ITransaction, parent_id: int, name: str, inode: Inode,
        recursive: bool,
    ) -> None:
        if inode.is_dir():
            begin, end = dirent_scan_range(inode.id)
            children = txn.get_range(begin, end, limit=0 if recursive else 1)
            if children and not recursive:
                raise _err(Code.META_NOT_EMPTY, name)
            for pair in children:
                ent = deserialize(pair.value, DirEntry)
                child = self._load_inode(txn, ent.inode_id)
                if child is not None:
                    self._remove_inode(txn, inode.id, ent.name, child, True)
            txn.clear(dirent_key(parent_id, name))
            txn.clear(inode_key(inode.id))
            return
        txn.clear(dirent_key(parent_id, name))
        inode.nlink -= 1
        if inode.nlink > 0:
            inode.ctime = time.time()
            self._store_inode(txn, inode)
            return
        # last link: park in the GC queue; chunks reclaimed asynchronously.
        # The inode record stays (like the ref's GC directories) so open
        # sessions can still close/fstat it; gc_finish deletes it.
        inode.nlink = 0
        inode.ctime = time.time()
        if inode.is_file():
            self._store_inode(txn, inode)
            txn.set(gc_key(inode.id), serialize(inode))
        else:
            txn.clear(inode_key(inode.id))

    def rename(self, src: str, dst: str, user: User = ROOT_USER) -> None:
        """Atomic rename with directory-loop detection
        (ref src/meta/store/ops/Rename.cc)."""

        def op(txn: ITransaction) -> None:
            sparent, sname, sinode = self._walk(txn, src, user, follow_last=False)
            if sname is None or sinode is None:
                raise _err(Code.META_NOT_FOUND, src)
            dparent, dname, dinode = self._walk(txn, dst, user, follow_last=False)
            if dname is None:
                raise _err(Code.META_EXISTS, "/")
            self._check_dir_writable(sparent, user)
            self._check_dir_writable(dparent, user)
            if sinode.is_dir():
                # dst parent must not be inside src (would orphan the subtree)
                cur = dparent
                while True:
                    if cur.id == sinode.id:
                        raise _err(Code.META_LOOP, f"{dst} inside {src}")
                    if cur.id == ROOT_INODE_ID:
                        break
                    cur = self._load_inode(txn, cur.parent)
                    if cur is None:
                        break
            if dinode is not None:
                if dinode.id == sinode.id:
                    return
                self._remove_inode(txn, dparent.id, dname, dinode, False)
            txn.clear(dirent_key(sparent.id, sname))
            self._store_dirent(txn, DirEntry(dparent.id, dname, sinode.id, sinode.type))
            if sinode.is_dir() and sparent.id != dparent.id:
                sinode.parent = dparent.id
                self._store_inode(txn, sinode)

        result = with_transaction(self._engine, op)
        self._emit("rename", src, uid=user.uid, detail=dst)
        return result

    def set_attr(
        self,
        path: str,
        user: User = ROOT_USER,
        *,
        perm: Optional[int] = None,
        uid: Optional[int] = None,
        gid: Optional[int] = None,
        atime: Optional[float] = None,
        mtime: Optional[float] = None,
    ) -> Inode:
        def op(txn: ITransaction) -> Inode:
            _, _, inode = self._walk(txn, path, user)
            if inode is None:
                raise _err(Code.META_NOT_FOUND, path)
            if not user.is_root and user.uid != inode.acl.uid:
                raise _err(Code.META_NO_PERMISSION, path)
            if perm is not None:
                inode.acl.perm = perm
            if uid is not None:
                if not user.is_root:
                    raise _err(Code.META_NO_PERMISSION, "chown requires root")
                inode.acl.uid = uid
            if gid is not None:
                inode.acl.gid = gid
            if atime is not None:
                inode.atime = atime
            if mtime is not None:
                inode.mtime = mtime
            inode.ctime = time.time()
            self._store_inode(txn, inode)
            return inode

        return with_transaction(self._engine, op)

    def batch_set_attr(
        self,
        paths: Optional[List[str]] = None,
        user: User = ROOT_USER,
        *,
        inode_ids: Optional[List[int]] = None,
        atime: Optional[float] = None,
        mtime: Optional[float] = None,
        txn_batch: int = 64,
    ) -> List[object]:
        """Settle atime/mtime on MANY inodes in O(len/txn_batch) KV
        transactions instead of one per item — the KVCache touch-on-get
        path, where every batched read otherwise pays one metadata round
        trip per hit. Address by path, or by inode id (``inode_ids``) to
        skip the path walks entirely when the caller already statted —
        like ``sync``, id addressing is the capability the stat handed
        out. Times only (ownership changes stay single-op: chmod/chown
        want per-path error surfaces). Per-item failures come back as
        FsError entries without failing their batch-mates."""
        if (paths is None) == (inode_ids is None):
            raise _err(Code.INVALID_ARG,
                       "batch_set_attr takes paths OR inode_ids")
        items: List[object] = list(paths if paths is not None
                                   else inode_ids)
        results: List[object] = [None] * len(items)
        for base in range(0, len(items), txn_batch):
            chunk = list(enumerate(items[base:base + txn_batch],
                                   start=base))

            def op(txn: ITransaction, _chunk=chunk):
                out = []
                for i, item in _chunk:
                    try:
                        # checks before mutation, like _close_in_txn: a
                        # failed item must leave no buffered writes
                        if isinstance(item, str):
                            _, _, inode = self._walk(txn, item, user)
                        else:
                            inode = self._load_inode(txn, int(item))
                        if inode is None:
                            raise _err(Code.META_NOT_FOUND, str(item))
                        if not user.is_root and user.uid != inode.acl.uid:
                            raise _err(Code.META_NO_PERMISSION, str(item))
                        if atime is not None:
                            inode.atime = atime
                        if mtime is not None:
                            inode.mtime = mtime
                        inode.ctime = time.time()
                        self._store_inode(txn, inode)
                        out.append((i, inode))
                    except FsError as e:
                        out.append((i, e))
                return out

            for i, res in with_transaction(self._engine, op):
                results[i] = res
        return results

    # -- extended attributes (ref fuse_lowlevel_ops setxattr/getxattr/
    # listxattr/removexattr, FuseOps.cc:2580-2613) --------------------------
    XATTR_CREATE = 1   # fail with META_EXISTS if the name exists
    XATTR_REPLACE = 2  # fail with META_NO_XATTR if the name is absent

    def set_xattr(self, path: str, name: str, value: bytes,
                  user: User = ROOT_USER, *, flags: int = 0) -> Inode:
        if not name or len(name) > 255 or len(value) > 64 << 10:
            raise _err(Code.INVALID_ARG, f"xattr {name!r}")

        def op(txn: ITransaction) -> Inode:
            _, _, inode = self._walk(txn, path, user)
            if inode is None:
                raise _err(Code.META_NOT_FOUND, path)
            if not inode.acl.check_user(user, PERM_W):
                raise _err(Code.META_NO_PERMISSION, path)
            # XATTR_CREATE/XATTR_REPLACE checked INSIDE the transaction:
            # create-exclusive xattr protocols (lock/claim via xattrs)
            # need the check and the write to be atomic
            if (flags & self.XATTR_CREATE) and name in inode.xattrs:
                raise _err(Code.META_EXISTS, f"xattr {name} on {path}")
            if (flags & self.XATTR_REPLACE) and name not in inode.xattrs:
                raise _err(Code.META_NO_XATTR, f"xattr {name} on {path}")
            inode.xattrs[name] = bytes(value)
            inode.ctime = time.time()
            self._store_inode(txn, inode)
            return inode

        return with_transaction(self._engine, op)

    def get_xattr(self, path: str, name: str,
                  user: User = ROOT_USER) -> bytes:
        inode = self.stat(path, user)
        if name not in inode.xattrs:
            raise _err(Code.META_NO_XATTR, f"xattr {name} on {path}")
        return inode.xattrs[name]

    def list_xattrs(self, path: str, user: User = ROOT_USER) -> List[str]:
        return sorted(self.stat(path, user).xattrs)

    def remove_xattr(self, path: str, name: str,
                     user: User = ROOT_USER) -> Inode:
        def op(txn: ITransaction) -> Inode:
            _, _, inode = self._walk(txn, path, user)
            if inode is None:
                raise _err(Code.META_NOT_FOUND, path)
            if not inode.acl.check_user(user, PERM_W):
                raise _err(Code.META_NO_PERMISSION, path)
            if name not in inode.xattrs:
                raise _err(Code.META_NO_XATTR, f"xattr {name} on {path}")
            del inode.xattrs[name]
            inode.ctime = time.time()
            self._store_inode(txn, inode)
            return inode

        return with_transaction(self._engine, op)

    def truncate(self, path: str, length: int, user: User = ROOT_USER) -> Inode:
        def op(txn: ITransaction) -> Inode:
            _, _, inode = self._walk(txn, path, user)
            if inode is None:
                raise _err(Code.META_NOT_FOUND, path)
            if not inode.is_file():
                raise _err(Code.META_NOT_FILE, path)
            if not inode.acl.check_user(user, PERM_W):
                raise _err(Code.META_NO_PERMISSION, path)
            inode.length = length
            inode.mtime = time.time()
            self._store_inode(txn, inode)
            return inode

        inode = with_transaction(self._engine, op)
        if self._truncate_hook is not None:
            self._truncate_hook(inode, length)
        return inode

    def get_real_path(self, path: str, user: User = ROOT_USER) -> str:
        def op(txn: ITransaction) -> str:
            parent, name, inode = self._walk(txn, path, user)
            if inode is None:
                raise _err(Code.META_NOT_FOUND, path)
            if inode.id == ROOT_INODE_ID:
                return "/"
            # walk parent pointers up for the directory part
            segs = [name] if name else []
            cur = parent
            while cur.id != ROOT_INODE_ID:
                begin, end = dirent_scan_range(cur.parent)
                found = None
                for pair in txn.get_range(begin, end, snapshot=True):
                    ent = deserialize(pair.value, DirEntry)
                    if ent.inode_id == cur.id:
                        found = ent.name
                        break
                if found is None:
                    raise _err(Code.META_NOT_FOUND, f"orphan dir {cur.id}")
                segs.append(found)
                nxt = self._load_inode(txn, cur.parent)
                if nxt is None:
                    break
                cur = nxt
            return "/" + "/".join(reversed(segs))

        return with_transaction(self._engine, op, read_only=True)

    def lock_directory(self, path: str, owner: str, user: User = ROOT_USER) -> None:
        """Restrict modifications of a directory to one owner
        (ref MetaSerde lockDirectory)."""

        def op(txn: ITransaction) -> None:
            _, _, inode = self._walk(txn, path, user)
            if inode is None or not inode.is_dir():
                raise _err(Code.META_NOT_DIRECTORY, path)
            if inode.locked_by and inode.locked_by != owner:
                # changing or clearing someone else's lock needs privilege
                # (root or the directory owner)
                if not user.is_root and user.uid != inode.acl.uid:
                    raise _err(
                        Code.META_NO_PERMISSION, f"locked by {inode.locked_by}"
                    )
            inode.locked_by = owner
            self._store_inode(txn, inode)

        return with_transaction(self._engine, op)

    def stat_fs(self) -> StatFs:
        def op(txn: ITransaction) -> StatFs:
            begin = inode_key(0)
            end = inode_key(2**64 - 1)
            files = used = 0
            for pair in txn.get_range(begin, end, snapshot=True):
                inode = deserialize(pair.value, Inode)
                if inode.is_file():
                    files += 1
                    used += inode.length
            return StatFs(capacity=0, used=used, files=files)

        sf = with_transaction(self._engine, op, read_only=True)
        if self._space_hook is not None:
            capacity, used = self._space_hook()
            sf.capacity = capacity
            sf.used = used
        return sf

    # -- GC (ref src/meta/components/GcManager.cc) --------------------------
    def gc_scan(self, limit: int = 64) -> List[Inode]:
        """Inodes waiting for chunk reclamation."""

        def op(txn: ITransaction):
            begin, end = gc_scan_range()
            return [
                deserialize(p.value, Inode)
                for p in txn.get_range(begin, end, limit=limit, snapshot=True)
            ]

        return with_transaction(self._engine, op, read_only=True)

    def gc_finish(self, inode_id: int) -> None:
        """Called after storage confirmed chunk removal: drop the GC record
        and the parked inode."""

        def op(txn: ITransaction) -> None:
            txn.clear(gc_key(inode_id))
            txn.clear(inode_key(inode_id))

        return with_transaction(self._engine, op)

    def has_sessions(self, inode_id: int) -> bool:
        return bool(self.list_sessions(inode_id))
