"""UserStore: token-authenticated users + TTL ACL cache.

The port's own copy of ``tpu3fs/core/user.py``,
unchanged but for its imports.

Re-expresses the reference's user subsystem (src/core/user/UserStore.cc,
UserToken.cc; cache src/meta/components/AclCache.h): user records live in
the shared transactional KV under the USER prefix, each with a bearer token;
services resolve request tokens to (uid, gid, groups, admin) server-side so
clients cannot claim arbitrary identities. The meta service authenticates
every op through an AclCache — a TTL map over the store so the hot path does
not pay one KV read per request (the reference's AclCache plays the same
role over FDB).
"""

from __future__ import annotations

import secrets
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from tpu3fs_torch.kv.kv import IKVEngine, ITransaction, KeyPrefix, with_transaction
from tpu3fs_torch.meta.store import User
from tpu3fs_torch.rpc.serde import deserialize, serialize
from tpu3fs_torch.utils.result import Code, FsError
from tpu3fs_torch.utils.result import err as _err


def _user_key(uid: int) -> bytes:
    return KeyPrefix.USER.value + b"U" + struct.pack(">Q", uid)


def _token_key(token: str) -> bytes:
    return KeyPrefix.USER.value + b"T" + token.encode()


def _user_scan_range() -> Tuple[bytes, bytes]:
    p = KeyPrefix.USER.value + b"U"
    return p, p + b"\xff" * 9


@dataclass
class UserRecord:
    uid: int = 0
    name: str = ""
    gid: int = 0
    groups: List[int] = field(default_factory=list)
    token: str = ""
    admin: bool = False
    root: bool = False
    # tenant binding: the ONE tenant this user's bearer token may declare
    # on the wire (``u1.<tenant>`` envelope token). "" = unbound — any
    # declared tenant passes (legacy users / internal daemons). Trailing
    # field on purpose: serde decoders default missing trailing fields,
    # so records written before the binding existed stay readable
    # (docs/tenancy.md "binding tenant ids to the user layer").
    tenant: str = ""

    def as_user(self) -> User:
        return User(uid=self.uid, gid=self.gid,
                    groups=tuple(self.groups), root=self.root)


class UserStore:
    """CRUD + token lookup over the shared KV (ref UserStore.cc)."""

    def __init__(self, engine: IKVEngine):
        self._engine = engine

    @staticmethod
    def new_token() -> str:
        return secrets.token_hex(16)

    def add_user(self, uid: int, name: str, *, gid: Optional[int] = None,
                 groups: Optional[List[int]] = None, admin: bool = False,
                 root: bool = False, token: Optional[str] = None,
                 tenant: str = "") -> UserRecord:
        rec = UserRecord(
            uid=uid, name=name, gid=uid if gid is None else gid,
            groups=list(groups or []), token=token or self.new_token(),
            admin=admin, root=root, tenant=tenant,
        )

        def op(txn: ITransaction) -> UserRecord:
            if txn.get(_user_key(uid)) is not None:
                raise _err(Code.META_EXISTS, f"uid {uid}")
            if txn.get(_token_key(rec.token)) is not None:
                raise _err(Code.META_EXISTS, "token already in use")
            txn.set(_user_key(uid), serialize(rec))
            txn.set(_token_key(rec.token), struct.pack(">Q", uid))
            return rec

        return with_transaction(self._engine, op)

    def get_user(self, uid: int) -> Optional[UserRecord]:
        def op(txn: ITransaction):
            raw = txn.get(_user_key(uid))
            return deserialize(raw, UserRecord) if raw else None

        return with_transaction(self._engine, op, read_only=True)

    def list_users(self) -> List[UserRecord]:
        def op(txn: ITransaction):
            begin, end = _user_scan_range()
            return [deserialize(p.value, UserRecord)
                    for p in txn.get_range(begin, end)]

        return with_transaction(self._engine, op, read_only=True)

    def remove_user(self, uid: int) -> bool:
        def op(txn: ITransaction) -> bool:
            raw = txn.get(_user_key(uid))
            if raw is None:
                return False
            rec = deserialize(raw, UserRecord)
            txn.clear(_user_key(uid))
            txn.clear(_token_key(rec.token))
            return True

        return with_transaction(self._engine, op)

    def rotate_token(self, uid: int) -> str:
        """Issue a fresh token, invalidating the old one (ref UserToken)."""
        token = self.new_token()

        def op(txn: ITransaction) -> str:
            raw = txn.get(_user_key(uid))
            if raw is None:
                raise _err(Code.META_NOT_FOUND, f"uid {uid}")
            rec = deserialize(raw, UserRecord)
            txn.clear(_token_key(rec.token))
            rec.token = token
            txn.set(_user_key(uid), serialize(rec))
            txn.set(_token_key(token), struct.pack(">Q", uid))
            return token

        return with_transaction(self._engine, op)

    def set_tenant(self, uid: int, tenant: str) -> UserRecord:
        """Bind (or clear, with "") the one tenant this user's token may
        declare on the wire. Takes effect within the AclCache TTL."""

        def op(txn: ITransaction) -> UserRecord:
            raw = txn.get(_user_key(uid))
            if raw is None:
                raise _err(Code.META_NOT_FOUND, f"uid {uid}")
            rec = deserialize(raw, UserRecord)
            rec.tenant = tenant
            txn.set(_user_key(uid), serialize(rec))
            return rec

        return with_transaction(self._engine, op)

    def authenticate(self, token: str) -> UserRecord:
        """token -> UserRecord; raises META_NO_PERMISSION on a bad token."""
        if not token:
            raise _err(Code.META_NO_PERMISSION, "missing token")

        def op(txn: ITransaction):
            raw = txn.get(_token_key(token))
            if raw is None:
                return None
            (uid,) = struct.unpack(">Q", raw)
            urow = txn.get(_user_key(uid))
            return deserialize(urow, UserRecord) if urow else None

        rec = with_transaction(self._engine, op, read_only=True)
        if rec is None:
            raise _err(Code.META_NO_PERMISSION, "invalid token")
        return rec


class AclCache:
    """TTL cache of token -> UserRecord (ref AclCache.h): the meta hot path
    resolves tokens from memory; misses and expiries fall through to the
    store. Invalid tokens are NOT negatively cached, so a token rotation
    takes effect immediately for the new token and within ttl for the old."""

    def __init__(self, store: UserStore, *, ttl_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self._store = store
        self._ttl = ttl_s
        self._clock = clock
        self._lock = threading.Lock()
        self._cache: Dict[str, Tuple[float, UserRecord]] = {}

    def authenticate(self, token: str) -> UserRecord:
        now = self._clock()
        with self._lock:
            hit = self._cache.get(token)
            if hit is not None and hit[0] > now:
                return hit[1]
        rec = self._store.authenticate(token)  # raises on bad token
        with self._lock:
            self._cache[token] = (now + self._ttl, rec)
            if len(self._cache) > 4096:  # bound growth
                self._cache = {
                    k: v for k, v in self._cache.items() if v[0] > now
                }
                if len(self._cache) > 4096:
                    # all live: evict the soonest-to-expire half so the
                    # prune actually shrinks the dict (else every insert
                    # rebuilds it O(n))
                    keep = sorted(self._cache.items(),
                                  key=lambda kv: kv[1][0])[2048:]
                    self._cache = dict(keep)
        return rec

    def invalidate(self, token: Optional[str] = None) -> None:
        with self._lock:
            if token is None:
                self._cache.clear()
            else:
                self._cache.pop(token, None)
