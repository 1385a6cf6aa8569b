"""Result/Status error model.

The port's own copy of ``tpu3fs/utils/result.py``,
unchanged but for its imports.

Re-expresses the reference's ``Result<T> = Expected<T, Status>`` and the
per-subsystem error taxonomy (ref: src/common/utils/Result.h,
src/common/utils/StatusCode.h) as a small Python type. Services return
``Result`` values instead of raising, so RPC layers can serialize failures and
clients can drive retry ladders off the code class.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Generic, Optional, TypeVar

T = TypeVar("T")


class Code(enum.IntEnum):
    """Error taxonomy, grouped by subsystem in disjoint ranges.

    Mirrors the reference's StatusCode/MetaCode/StorageCode/RPCCode split
    (src/common/utils/StatusCode.h); numbering is our own.
    """

    OK = 0

    # generic 1xx
    INVALID_ARG = 100
    NOT_IMPLEMENTED = 101
    TIMEOUT = 102
    CANCELLED = 103
    INTERNAL = 104
    FAULT_INJECTION = 105
    QUEUE_FULL = 106
    SHUTTING_DOWN = 107
    OVERLOADED = 108         # QoS shed: retryable, carries retry-after hint
    DEADLINE_EXCEEDED = 109  # the op's absolute deadline passed: work shed
    #                          at RPC admission / update-queue dequeue, or a
    #                          client ladder gave up (docs/robustness.md)

    # RPC 2xx
    RPC_CONNECT_FAILED = 200
    RPC_SEND_FAILED = 201
    RPC_TIMEOUT = 202
    RPC_BAD_REQUEST = 203
    RPC_METHOD_NOT_FOUND = 204
    RPC_SERVICE_NOT_FOUND = 205
    RPC_PEER_CLOSED = 206
    PEER_UNHEALTHY = 207     # circuit breaker open for this peer: the call
    #                          failed FAST without touching the wire — retry
    #                          after a routing refresh (docs/robustness.md)

    # KV / transaction 3xx
    KV_CONFLICT = 300
    KV_NOT_FOUND = 301
    KV_TXN_TOO_OLD = 302
    KV_MAYBE_COMMITTED = 303
    KV_RETRYABLE = 304
    KV_NOT_PRIMARY = 305       # replicated kvd: this node is not the leader

    # meta 4xx
    META_NOT_FOUND = 400
    META_EXISTS = 401
    META_NOT_DIRECTORY = 402
    META_IS_DIRECTORY = 403
    META_NOT_EMPTY = 404
    META_NO_PERMISSION = 405
    META_TOO_MANY_SYMLINKS = 406
    META_LOOP = 407          # rename would create a directory cycle
    META_BUSY = 408          # open write sessions exist
    META_NO_SESSION = 409
    META_BAD_LAYOUT = 410
    META_NAME_TOO_LONG = 411
    META_INVALID_PATH = 412
    META_NOT_FILE = 413
    META_NO_XATTR = 414      # ENODATA, distinct from a missing path
    META_WRONG_PARTITION = 415  # op routed to a meta server that does not
    #                          own the partition (stale table / mid-
    #                          reassignment): refresh routing and retry —
    #                          correctness is never at stake, the shared
    #                          KV serializes either way (docs/metashard.md)
    META_TXN_EXPIRED = 416   # two-phase prepare refused: the intent's
    #                          deadline passed (the resolver may already
    #                          be aborting it) or it was never written

    # storage 5xx (update-code taxonomy, ref StorageOperator.cc:401-434)
    CHUNK_NOT_FOUND = 500
    CHUNK_NOT_COMMIT = 501        # read saw an uncommitted head version
    CHUNK_STALE_UPDATE = 502      # update ver <= committed ver (duplicate)
    CHUNK_MISSING_UPDATE = 503    # update ver > committed+1 (gap)
    CHUNK_ADVANCE_UPDATE = 504    # retry raced ahead of a pending update
    CHUNK_COMMITTED_UPDATE = 505  # commit for an already-committed ver
    CHUNK_CHECKSUM_MISMATCH = 506
    NO_SPACE = 507
    TARGET_NOT_FOUND = 508
    TARGET_OFFLINE = 509
    CHAIN_VERSION_MISMATCH = 510
    CHAIN_NOT_FOUND = 511
    NOT_HEAD = 512                # client write sent to a non-head target
    NO_SUCCESSOR = 513
    SYNCING = 514                 # target still receiving full-chunk-replace
    ENGINE_ERROR = 515
    NONHEAD_WRITE_REJECTED = 516
    WRITE_FENCED = 517            # head's mgmtd lease-fence expired: no acks
    #                               until it re-establishes mgmtd contact —
    #                               retryable, routing refresh finds the
    #                               promoted successor (docs/scale.md)

    # mgmtd 6xx
    MGMTD_NOT_PRIMARY = 600
    MGMTD_LEASE_EXPIRED = 601
    MGMTD_STALE_HEARTBEAT = 602
    MGMTD_NODE_NOT_FOUND = 603
    MGMTD_CHAIN_NOT_FOUND = 604
    MGMTD_INVALID_TRANSITION = 605
    MGMTD_REGISTERED = 606

    # client 7xx
    CLIENT_RETRIES_EXHAUSTED = 700
    CLIENT_NO_CHANNEL = 701
    CLIENT_ROUTING_STALE = 702
    CLIENT_BUSY = 703        # bounded queue/limiter full (backpressure)

    # checkpoint subsystem 8xx (tpu3fs/ckpt)
    CKPT_BUSY = 800          # another save session holds this root
    CKPT_NOT_FOUND = 801     # no committed checkpoint at this step
    CKPT_CORRUPT = 802       # manifest/shard failed decode or CRC check

    # dataload subsystem 9xx (tpu3fs/dataload)
    DATALOAD_CORRUPT = 900   # record file header/index/record CRC mismatch
    DATALOAD_STATE_MISMATCH = 901  # resume state does not fit this dataset

    # kvcache subsystem 10xx (tpu3fs/kvcache)
    KVCACHE_STALE = 1000     # entry bytes fail the array-header magic —
    #                          a cached inode outlived its entry (GC'd);
    #                          invalidate and re-stat
    KVCACHE_CORRUPT = 1001   # array header malformed beyond staleness
    KVCACHE_FLUSH_POISONED = 1002  # write-back flusher exhausted its
    #                          consecutive-failure budget: producers must
    #                          stop buffering (tier.py error budget)

    # tenant subsystem 11xx (tpu3fs/tenant)
    TENANT_THROTTLED = 1100  # the op's TENANT exceeded its quota (bytes/s,
    #                          IOPS or kvcache resident budget): retryable,
    #                          carries a retry-after hint like OVERLOADED —
    #                          but it names WHO was over, not that the
    #                          server was full (docs/tenancy.md)

    # usrbio shared-memory data plane 12xx (tpu3fs/usrbio)
    USRBIO_RING_FULL = 1200       # SQ has `entries` unreaped ops in flight;
    #                               the client waits or falls back to sockets
    USRBIO_BAD_IOV = 1201         # SQE region escapes the registered iov /
    #                               token field overflow / unregistered iov id
    USRBIO_AGENT_GONE = 1202      # no completion within the ring deadline or
    #                               registration dropped: the serving process
    #                               is gone — re-handshake or use sockets
    USRBIO_TORN_RING = 1203       # ring header failed magic/version check:
    #                               the segment is torn or foreign — neither
    #                               side may trust its counters
    USRBIO_REPLY_OVERFLOW = 1204  # the reply did not fit the SQE's reply
    #                               region; retry with a larger region or
    #                               fall back to sockets
    USRBIO_UNSUPPORTED = 1205     # SQE names a (service, method) outside the
    #                               ring allowlist (usrbio/transport.py
    #                               RING_METHODS) — never dispatched

    # migration / elasticity subsystem 13xx (tpu3fs/migration, placement)
    MIGRATION_QUORUM = 1300       # chain mutation refused: it would drop the
    #                               chain below its serving write-quorum
    #                               mid-plan (docs/placement.md invariants)
    MIGRATION_CONFLICT = 1301     # an ACTIVE job already reshapes this
    #                               chain / the claim belongs to another
    #                               live worker
    MIGRATION_JOB_NOT_FOUND = 1302


#: Codes on which a client-side retry ladder may re-issue the request.
RETRYABLE_CODES = frozenset(
    {
        Code.TIMEOUT,
        Code.RPC_CONNECT_FAILED,
        Code.RPC_SEND_FAILED,
        Code.RPC_TIMEOUT,
        Code.RPC_PEER_CLOSED,
        Code.KV_CONFLICT,
        Code.KV_TXN_TOO_OLD,
        Code.KV_RETRYABLE,
        Code.KV_NOT_PRIMARY,
        Code.CHUNK_NOT_COMMIT,
        Code.CHAIN_VERSION_MISMATCH,
        Code.CHUNK_ADVANCE_UPDATE,
        Code.TARGET_OFFLINE,
        Code.SYNCING,
        Code.CLIENT_ROUTING_STALE,
        # metashard ownership fence: the op reached a non-owner; a routing
        # refresh re-routes it (MetaRpcClient refreshes before the retry)
        Code.META_WRONG_PARTITION,
        Code.QUEUE_FULL,
        # QoS load shed: the server is telling the client to come back
        # after the carried retry-after hint (qos.retry_after_ms_of)
        Code.OVERLOADED,
        # forwarding found no route to the successor after server-side
        # retries: routing is lagging (startup/failover) — clients should
        # back off and ladder, not fail the write
        Code.NO_SUCCESSOR,
        # the server shed work whose deadline had already passed; a caller
        # with budget left may re-issue (ladders check their own deadline
        # before each retry, so an expired caller stops immediately)
        Code.DEADLINE_EXCEEDED,
        # lease-fenced head: it cannot ack until it re-establishes mgmtd
        # contact; mgmtd is (or will be) promoting a successor — clients
        # refresh routing and the ladder lands on the new head
        Code.WRITE_FENCED,
        # breaker fail-fast: the peer is suspected sick — refresh routing
        # and retry (the half-open probe re-tests the peer independently)
        Code.PEER_UNHEALTHY,
        # tenant quota shed: the server is telling this TENANT to come
        # back after its bucket refills (retry-after hint, like
        # OVERLOADED; a well-behaved client ladder waits it out)
        Code.TENANT_THROTTLED,
    }
)


@dataclass(frozen=True)
class Status:
    code: Code
    message: str = ""

    def is_ok(self) -> bool:
        return self.code == Code.OK

    def retryable(self) -> bool:
        return self.code in RETRYABLE_CODES

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"{self.code.name}({int(self.code)}): {self.message}"


OK_STATUS = Status(Code.OK)


class FsError(Exception):
    """Exception carrying a Status, for code that prefers raising."""

    def __init__(self, status: Status):
        super().__init__(str(status))
        self.status = status

    @property
    def code(self) -> Code:
        return self.status.code


class Result(Generic[T]):
    """Either a value or a Status error. ``Result.ok(v)`` / ``Result.err(...)``."""

    __slots__ = ("_value", "_status")

    def __init__(self, value: Optional[T], status: Status):
        self._value = value
        self._status = status

    @classmethod
    def ok(cls, value: T = None) -> "Result[T]":
        return cls(value, OK_STATUS)

    @classmethod
    def err(cls, code: Code, message: str = "") -> "Result[T]":
        return cls(None, Status(code, message))

    @classmethod
    def from_status(cls, status: Status) -> "Result[T]":
        return cls(None, status)

    def is_ok(self) -> bool:
        return self._status.is_ok()

    @property
    def status(self) -> Status:
        return self._status

    @property
    def code(self) -> Code:
        return self._status.code

    @property
    def value(self) -> T:
        """The success value; raises FsError if this is an error result."""
        if not self.is_ok():
            raise FsError(self._status)
        return self._value

    def value_or(self, default: T) -> T:
        return self._value if self.is_ok() else default

    def __bool__(self) -> bool:
        return self.is_ok()

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        if self.is_ok():
            return f"Result.ok({self._value!r})"
        return f"Result.err({self._status})"


def make_error(code: Code, message: str = "") -> Result:
    return Result.err(code, message)


def err(code: Code, message: str = "") -> FsError:
    """Shorthand constructor for raising: ``raise err(Code.X, "...")``."""
    return FsError(Status(code, message))
