"""Transactional KV abstraction + retry driver.

The port's own copy of ``tpu3fs/kv/kv.py``,
unchanged but for its imports.

Re-expresses the reference's IKVEngine/ITransaction interfaces and the
transaction-with-retry loop every metadata/mgmtd operation runs inside
(src/common/kv/IKVEngine.h, ITransaction.h, WithTransaction.h:34-46). The
in-memory engine (kv/mem.py) emulates FoundationDB semantics — snapshot
isolation, read-set conflict detection, versionstamps — faithfully enough
that the meta test suite runs identically against it, which is the
reference's own trick (tests/common/kv/mem vs tests/common/kv/fdb).

Key prefixes mirror src/common/kv/KeyPrefix-def.h:6-23.
"""

from __future__ import annotations

import abc
import enum
import random
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, TypeVar

from tpu3fs_torch.utils.result import Code, FsError

T = TypeVar("T")


class KeyPrefix(bytes, enum.Enum):
    """4-byte key namespaces (ref KeyPrefix-def.h)."""

    INODE = b"INOD"          # inode id -> inode
    DIR_ENTRY = b"DENT"      # (parent, name) -> dirent
    META_SERVER = b"META"    # meta server heartbeat map (Distributor)
    USER = b"USER"           # user/token records
    NODE = b"NODE"           # mgmtd node infos
    LEASE = b"SING"          # mgmtd primary lease ("single" record)
    CHAIN_INFO = b"CHIT"     # chain infos
    CHAIN_TABLE = b"CHIF"    # chain tables
    INODE_SESSION = b"INOS"  # write-open file sessions
    IDEMPOTENT = b"IDEM"     # cached op results for client retries
    CONFIG = b"CONF"         # per-node-type config blobs
    TARGET_INFO = b"TGIF"    # target infos
    MIGRATION = b"MGJB"      # migration job records (+ b"MGJC" id counter)
    SERVING = b"SRVE"        # KVCache serving endpoints (peer directory)


def make_key(prefix: KeyPrefix, *parts: bytes) -> bytes:
    return prefix.value + b"".join(parts)


@dataclass
class KVPair:
    key: bytes
    value: bytes


class ITransaction(abc.ABC):
    """One transaction: snapshot reads + buffered writes + conflict commit."""

    @abc.abstractmethod
    def get(self, key: bytes) -> Optional[bytes]:
        """Read with conflict tracking."""

    @abc.abstractmethod
    def snapshot_get(self, key: bytes) -> Optional[bytes]:
        """Read WITHOUT adding to the conflict read-set."""

    @abc.abstractmethod
    def get_range(
        self,
        begin: bytes,
        end: bytes,
        *,
        limit: int = 0,
        reverse: bool = False,
        snapshot: bool = False,
    ) -> List[KVPair]:
        """Half-open [begin, end) ordered scan; limit 0 = unlimited."""

    @abc.abstractmethod
    def set(self, key: bytes, value: bytes) -> None: ...

    @abc.abstractmethod
    def set_versionstamped_key(self, prefix: bytes, suffix: bytes, value: bytes) -> None:
        """Write to prefix + 10-byte commit versionstamp + suffix."""

    @abc.abstractmethod
    def clear(self, key: bytes) -> None: ...

    @abc.abstractmethod
    def clear_range(self, begin: bytes, end: bytes) -> None: ...

    @abc.abstractmethod
    def add_read_conflict(self, key: bytes) -> None:
        """Manually add a key to the read conflict set."""

    @abc.abstractmethod
    def commit(self) -> None:
        """Raises FsError(KV_CONFLICT / KV_TXN_TOO_OLD) on failure."""

    @abc.abstractmethod
    def cancel(self) -> None: ...

    @property
    @abc.abstractmethod
    def committed_version(self) -> Optional[int]: ...


class IKVEngine(abc.ABC):
    @abc.abstractmethod
    def transaction(self) -> ITransaction: ...


@dataclass
class RetryConfig:
    """Backoff ladder for transaction retries (ref FDBRetryStrategy)."""

    max_retries: int = 10
    backoff_base_s: float = 0.001
    backoff_max_s: float = 0.1


def with_transaction(
    engine: IKVEngine,
    fn: Callable[[ITransaction], T],
    retry: Optional[RetryConfig] = None,
    *,
    read_only: bool = False,
) -> T:
    """Run fn inside a transaction, committing and retrying on conflicts.

    fn may be re-executed; it must be idempotent up to its KV effects (the
    same contract as the reference's WithTransaction::run retry loop).

    Traced ops get a ``meta.txn`` stage span covering the whole retry
    ladder — the "where did the meta op's time go" stage of the
    distributed trace (tpu3fs/analytics/spans.py).
    """
    from tpu3fs_torch.analytics import spans as _spans

    _tctx = _spans.current_trace()
    if _tctx is not None:
        with _spans.span("kv.with_transaction", "txn"):
            return _with_transaction_untraced(engine, fn, retry,
                                              read_only=read_only)
    return _with_transaction_untraced(engine, fn, retry,
                                      read_only=read_only)


def _with_transaction_untraced(
    engine: IKVEngine,
    fn: Callable[[ITransaction], T],
    retry: Optional[RetryConfig] = None,
    *,
    read_only: bool = False,
) -> T:
    retry = retry or RetryConfig()
    attempt = 0
    while True:
        txn = engine.transaction()
        try:
            result = fn(txn)
            if read_only:
                txn.cancel()
            else:
                txn.commit()
            return result
        except FsError as e:
            txn.cancel()
            # KV_NOT_PRIMARY: kvd failover mid-transaction — restart on the
            # new leader. KV_MAYBE_COMMITTED mirrors FDB's
            # commit_unknown_result, which its default retry loop DOES
            # retry; the meta layer's Idempotent records / existence checks
            # carry the same at-least-once burden as in the reference.
            if e.code not in (Code.KV_CONFLICT, Code.KV_TXN_TOO_OLD,
                              Code.KV_RETRYABLE, Code.KV_NOT_PRIMARY,
                              Code.KV_MAYBE_COMMITTED):
                raise
            attempt += 1
            if attempt > retry.max_retries:
                raise
            delay = min(retry.backoff_max_s, retry.backoff_base_s * (2 ** attempt))
            time.sleep(delay * (0.5 + random.random() / 2))
