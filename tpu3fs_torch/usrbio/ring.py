"""Shared-memory Iov buffers and SQ/CQ rings — the USRBIO data plane.

The port's own copy of ``tpu3fs/usrbio/ring.py``: the same segment
layouts, header magic and version, SQE/CQE structs, name prefixes and
semaphore names, byte for byte, so either package's client drives the
other's rings.

Re-expresses the reference's shared-memory machinery (src/fuse/IoRing.h:
43-264 — submission/completion rings in shm with semaphore wakeups;
src/lib/common/Shm.cc — user-registered buffers): a client process creates a
buffer (Iov) and a ring (IoRing) in /dev/shm, hands their names to the agent,
then submits batched IO by writing SQEs and posting the submit semaphore.
The agent moves bytes directly between storage and the client's Iov (the
zero-copy contract the reference implements with RDMA into user shm) and
posts CQEs + the completion semaphore.

ABI v2 (docs/usrbio_abi.md is the normative spec): the SQE carries the
full request-envelope identity — service/method ids, the QoS-class flag
bits at their envelope positions, and a token field holding the same
version-tolerant ``t1.*``/``d1.*``/``u1.*`` string the socket envelopes
ride in their message field — so trace context, deadlines and tenant
identity cross the shm boundary exactly like they cross the wire, and
admission at ring dequeue sees everything RPC admission sees. RPC-mode
SQEs additionally name a reply region so whole serde RPCs (batch reads/
writes) ride one SQE with replies landing in the client's registered shm.

Layouts are fixed C structs (struct module) so non-Python clients can speak
the ABI (native/usrbio_loadgen.cpp is the in-repo C++ speaker).
"""

from __future__ import annotations

import os
import mmap
import re
import stat
import struct
import time
import uuid
from typing import List, Optional, Tuple

from tpu3fs_torch.usrbio.sem import NamedSemaphore
from tpu3fs_torch.utils.result import Code, FsError, Status

SHM_DIR = "/dev/shm"

# header: magic, entries, sq_head, sq_tail, cq_head, cq_tail, version,
# owner_pid. v1 rings wrote 0 in the last two slots (then "flags"/"pad"),
# so a v2 agent refuses them by version, never by misparsing slots.
_HDR = struct.Struct("<IIQQQQII")
# SQE v2 (224 bytes): iov_offset, length, file_offset, rsp_offset,
# rsp_capacity, fd, flags, service_id, method_id, userdata, iov_id,
# token_len, reserved, token[156]
_SQE = struct.Struct("<QQQQQiIHHQIHH156s")
_CQE = struct.Struct("<qQQ")               # result, userdata, reserved
MAGIC = 0x3F5B10
VERSION = 2

SQE_FLAG_READ = 1   # bit 0: file-mode read (else file-mode write)
SQE_FLAG_RPC = 2    # bit 1: RPC-mode SQE (service/method/regions valid)
SQE_FLAG_BULK = 4   # bit 2: request region carries a bulk section
# bits 8-11 carry the QoS traffic class in the SAME position as the
# socket envelope's flag bits (qos/core.py class_to_flags) — the agent
# forwards them verbatim into the dispatched packet.

TOKEN_CAP = 156

HDR_SIZE = 64
SQE_SIZE = _SQE.size
CQE_SIZE = _CQE.size
assert _HDR.size <= HDR_SIZE
assert SQE_SIZE == 224

# RPC-mode reply region header: status, msg_len, payload_len, bulk_len
# (then msg, payload, bulk section back to back). Written by the agent,
# validated by the client against the CQE result (torn replies surface
# as USRBIO errors, never as silently-wrong bytes).
RSP_HDR = struct.Struct("<IIII")


#: handshake nonce files (usrbio/server.py): name embeds the serving pid
#: as ``tpu3fs-hs-<pid>-<hex>`` so the reaper can collect crashed hosts'
HS_PREFIX = "tpu3fs-hs-"


def _shm_name_prefixes() -> Tuple[str, str]:
    return "tpu3fs-iov-", "tpu3fs-ior-"


_NAME_RE = re.compile(r"^[A-Za-z0-9_-]+$")


def validate_shm_name(name: str, prefix: str) -> None:
    """Segment names are path COMPONENTS, never paths. Client-supplied
    names reach ``os.path.join(SHM_DIR, name)`` in the mapping process
    (the storage agent), so a '/' — let alone '../' — would let a client
    steer the agent into opening an arbitrary path O_RDWR."""
    if not name.startswith(prefix) or not _NAME_RE.match(name):
        raise FsError(Status(
            Code.USRBIO_BAD_IOV,
            f"bad shm segment name {name!r} "
            f"(want {prefix}[A-Za-z0-9_-]+)"))


def _map_shm(path: str, size: int, *, create: bool) -> mmap.mmap:
    """Open + mmap a /dev/shm segment. O_NOFOLLOW refuses a symlink
    planted under the expected name; on map (create=False) the fd is
    fstat'd so a non-regular file or a segment smaller than the claimed
    size is rejected up front — mmap past EOF succeeds on Linux and then
    SIGBUSes the mapping process on first touch, a one-request kill of
    whoever trusted the claimed size."""
    flags = os.O_RDWR | getattr(os, "O_NOFOLLOW", 0) \
        | (os.O_CREAT if create else 0)
    fd = os.open(path, flags, 0o600)
    try:
        if create:
            os.ftruncate(fd, size)
        else:
            st = os.fstat(fd)
            if not stat.S_ISREG(st.st_mode):
                raise FsError(Status(
                    Code.USRBIO_BAD_IOV,
                    f"shm segment {path}: not a regular file"))
            if st.st_size < size:
                raise FsError(Status(
                    Code.USRBIO_BAD_IOV,
                    f"shm segment {path}: {st.st_size}B on disk "
                    f"< claimed {size}B"))
        return mmap.mmap(fd, size)
    finally:
        os.close(fd)


class Iov:
    """A registered shared-memory buffer (ref hf3fs_iov)."""

    def __init__(self, size: int, name: Optional[str] = None, create: bool = True):
        self.name = name or f"tpu3fs-iov-{uuid.uuid4().hex[:12]}"
        validate_shm_name(self.name, "tpu3fs-iov-")
        self.size = size
        self.path = os.path.join(SHM_DIR, self.name)
        self._created = bool(create)
        self.buf = _map_shm(self.path, size, create=create)

    def write(self, offset: int, data: bytes) -> None:
        self.buf[offset : offset + len(data)] = data

    def read(self, offset: int, length: int) -> bytes:
        return bytes(self.buf[offset : offset + length])

    def view(self, offset: int, length: int) -> memoryview:
        """Writable window over the registered shm: storage read replies
        land HERE directly (the RDMA-WRITE-into-user-memory analogue,
        ref StorageOperator.cc:176-226), no intermediate assembly buffer."""
        return memoryview(self.buf)[offset : offset + length]

    def close(self, unlink: Optional[bool] = None) -> None:
        """Close the mapping. ``unlink`` defaults to whether THIS object
        created the segment — the creating side cleans /dev/shm up on any
        orderly close (the crash path is the agent reaper's job), while a
        mapper (the agent) never unlinks a client's live buffer."""
        try:
            self.buf.close()
        except BufferError:
            # exported views still alive (zero-copy replies in flight):
            # the mmap stays mapped until they die; the shm FILE can
            # still be unlinked below, which is what stops the leak
            pass
        if self._created if unlink is None else unlink:
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass


class IoRing:
    """SQ/CQ ring pair in one shm segment + submit/complete semaphores.

    Single-producer SQ (the client), single-consumer agent; monotonically
    increasing head/tail counters, slot = counter % entries. ``priority``
    selects which of the agent's priority lanes serves this ring (ref
    IoRing.h:259-264's three submit semaphores). The creating process
    stamps its pid into the header so an agent-side reaper can collect
    segments whose owner died without deregistering.
    """

    def __init__(
        self,
        entries: int,
        name: Optional[str] = None,
        create: bool = True,
        for_read: bool = True,
        io_depth: int = 0,
        priority: int = 1,
    ):
        assert entries > 0 and (entries & (entries - 1)) == 0, "entries: power of 2"
        self.name = name or f"tpu3fs-ior-{uuid.uuid4().hex[:12]}"
        validate_shm_name(self.name, "tpu3fs-ior-")
        self.entries = entries
        self.for_read = for_read
        self.io_depth = io_depth
        self.priority = priority
        self.path = os.path.join(SHM_DIR, self.name)
        self._created = bool(create)
        size = HDR_SIZE + entries * (SQE_SIZE + CQE_SIZE)
        self.buf = _map_shm(self.path, size, create=create)
        self._sq_base = HDR_SIZE
        self._cq_base = HDR_SIZE + entries * SQE_SIZE
        if create:
            self._write_header(MAGIC, entries, 0, 0, 0, 0, VERSION, os.getpid())
        else:
            magic, n, _, _, _, _, version, _ = _HDR.unpack(
                self.buf[: _HDR.size])
            if magic != MAGIC or version != VERSION or n != entries:
                self.buf.close()
                raise FsError(Status(
                    Code.USRBIO_TORN_RING,
                    f"ring {self.name}: magic=0x{magic:x} version={version} "
                    f"entries={n} (want 0x{MAGIC:x}/v{VERSION}/{entries})"))
        self.submit_sem = NamedSemaphore(f"{self.name}-sq", create=create)
        self.complete_sem = NamedSemaphore(f"{self.name}-cq", create=create)

    # -- header accessors ----------------------------------------------------
    def _write_header(self, *vals) -> None:
        self.buf[: _HDR.size] = _HDR.pack(*vals)

    @property
    def owner_pid(self) -> int:
        return struct.unpack_from("<I", self.buf, 44)[0]

    def _counters(self):
        magic, entries, sq_h, sq_t, cq_h, cq_t, version, _ = _HDR.unpack(
            self.buf[: _HDR.size]
        )
        if magic != MAGIC or entries != self.entries:
            # torn/overwritten header: surface as a typed USRBIO error so
            # neither side trusts garbage counters (a crashed writer or a
            # truncated segment must never read as "billions of SQEs")
            raise FsError(Status(
                Code.USRBIO_TORN_RING,
                f"ring {self.name}: header torn "
                f"(magic=0x{magic:x} entries={entries})"))
        return sq_h, sq_t, cq_h, cq_t

    def _set_counter(self, index: int, value: int) -> None:
        # counters sit at offsets 8, 16, 24, 32 (8-byte aligned: atomic store)
        off = 8 + index * 8
        self.buf[off : off + 8] = struct.pack("<Q", value)

    # -- client side ---------------------------------------------------------
    def prep_io(
        self,
        iov_offset: int,
        length: int,
        file_offset: int,
        fd: int,
        *,
        read: bool,
        userdata: int = 0,
        iov_id: int = 0,
        token: str = "",
        class_flags: int = 0,
    ) -> int:
        """Queue one file-mode SQE; returns its slot or -1 if the ring is
        full. ``token`` carries the envelope-message tokens (trace/
        deadline/tenant) and ``class_flags`` the envelope QoS-class bits —
        the agent scopes all of them around the op exactly like RPC
        dispatch scopes an inbound socket envelope.

        Fullness is measured against cq_head (submitted-but-unreaped), not
        sq_head: that bounds total in-flight ops at `entries`, which in turn
        guarantees the agent can never overwrite an unreaped CQE."""
        return self._prep(
            iov_offset, length, file_offset, 0, 0, fd,
            (SQE_FLAG_READ if read else 0) | class_flags,
            0, 0, userdata, iov_id, token)

    def prep_rpc(
        self,
        service_id: int,
        method_id: int,
        req_offset: int,
        req_length: int,
        rsp_offset: int,
        rsp_capacity: int,
        *,
        userdata: int = 0,
        iov_id: int = 0,
        token: str = "",
        class_flags: int = 0,
        bulk: bool = False,
    ) -> int:
        """Queue one RPC-mode SQE: the request region holds a serialized
        request (+ optional bulk section), the reply region receives
        [RSP_HDR][msg][payload][bulk] — a whole serde RPC per SQE."""
        return self._prep(
            req_offset, req_length, 0, rsp_offset, rsp_capacity, 0,
            SQE_FLAG_RPC | (SQE_FLAG_BULK if bulk else 0) | class_flags,
            service_id, method_id, userdata, iov_id, token)

    def _prep(self, iov_offset, length, file_offset, rsp_offset, rsp_cap,
              fd, flags, service_id, method_id, userdata, iov_id,
              token: str) -> int:
        tok = token.encode("utf-8") if token else b""
        if len(tok) > TOKEN_CAP:
            # never truncate mid-token (a cut u1.* could rename the
            # tenant): the caller falls back to the socket transport
            raise FsError(Status(
                Code.USRBIO_BAD_IOV,
                f"envelope token {len(tok)}B exceeds SQE field {TOKEN_CAP}B"))
        sq_h, sq_t, cq_h, _ = self._counters()
        if sq_t - cq_h >= self.entries:
            return -1
        slot = sq_t % self.entries
        off = self._sq_base + slot * SQE_SIZE
        self.buf[off : off + SQE_SIZE] = _SQE.pack(
            iov_offset, length, file_offset, rsp_offset, rsp_cap, fd,
            flags, service_id, method_id, userdata, iov_id,
            len(tok), 0, tok,
        )
        self._set_counter(1, sq_t + 1)  # sq_tail
        return slot

    def submit(self) -> None:
        """Wake the agent (ref hf3fs_submit_ios: a hint, batching-friendly)."""
        self.submit_sem.post()

    def wait_for_ios(self, min_results: int, timeout: Optional[float] = None):
        """Block until >= min_results CQEs have been reaped; returns the
        accumulated list of (result, userdata) — possibly partial on timeout."""
        out = []
        while True:
            out.extend(self.reap())
            if len(out) >= min_results:
                return out
            if not self.complete_sem.wait(timeout):
                return out  # timeout: possibly partial

    def reap(self):
        """Consume all available CQEs (non-blocking)."""
        _, _, cq_h, cq_t = self._counters()
        out = []
        while cq_h < cq_t:
            slot = cq_h % self.entries
            off = self._cq_base + slot * CQE_SIZE
            result, userdata, _ = _CQE.unpack(self.buf[off : off + CQE_SIZE])
            out.append((result, userdata))
            cq_h += 1
        self._set_counter(2, cq_h)  # cq_head
        return out

    # -- agent side ----------------------------------------------------------
    def drain_sqes(self):
        """Consume all pending SQEs; returns list of Sqe."""
        sq_h, sq_t, _, _ = self._counters()
        out = []
        while sq_h < sq_t:
            slot = sq_h % self.entries
            off = self._sq_base + slot * SQE_SIZE
            vals = _SQE.unpack(self.buf[off : off + SQE_SIZE])
            out.append(Sqe(*vals))
            sq_h += 1
        self._set_counter(0, sq_h)  # sq_head
        return out

    def push_cqe(self, result: int, userdata: int) -> None:
        _, _, cq_h, cq_t = self._counters()
        slot = cq_t % self.entries
        off = self._cq_base + slot * CQE_SIZE
        self.buf[off : off + CQE_SIZE] = _CQE.pack(result, userdata, 0)
        self._set_counter(3, cq_t + 1)  # cq_tail
        self.complete_sem.post()

    def close(self, unlink: Optional[bool] = None) -> None:
        """Close the mapping + semaphores; unlink defaults to whether this
        object created the segment (see Iov.close)."""
        try:
            self.buf.close()
        except BufferError:
            pass
        self.submit_sem.close()
        self.complete_sem.close()
        if self._created if unlink is None else unlink:
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass
            NamedSemaphore.unlink(f"{self.name}-sq")
            NamedSemaphore.unlink(f"{self.name}-cq")


class Sqe:
    __slots__ = ("iov_offset", "length", "file_offset", "rsp_offset",
                 "rsp_capacity", "fd", "flags", "service_id", "method_id",
                 "userdata", "iov_id", "token")

    def __init__(self, iov_offset, length, file_offset, rsp_offset,
                 rsp_capacity, fd, flags, service_id, method_id,
                 userdata, iov_id, token_len=0, _reserved=0, token=b""):
        self.iov_offset = iov_offset
        self.length = length
        self.file_offset = file_offset
        self.rsp_offset = rsp_offset
        self.rsp_capacity = rsp_capacity
        self.fd = fd
        self.flags = flags
        self.service_id = service_id
        self.method_id = method_id
        self.userdata = userdata
        self.iov_id = iov_id
        self.token = token[:token_len].decode("utf-8", "replace") \
            if token_len else ""

    @property
    def is_read(self) -> bool:
        return bool(self.flags & SQE_FLAG_READ)

    @property
    def is_rpc(self) -> bool:
        return bool(self.flags & SQE_FLAG_RPC)

    @property
    def has_bulk(self) -> bool:
        return bool(self.flags & SQE_FLAG_BULK)


class Cqe:
    __slots__ = ("result", "userdata")

    def __init__(self, result, userdata):
        self.result = result
        self.userdata = userdata


# -- stale-shm reaping --------------------------------------------------------

def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    return True


def reap_stale_shm(*, keep: Optional[set] = None,
                   iov_max_age_s: float = 3600.0,
                   shm_dir: str = SHM_DIR) -> List[str]:
    """Collect leaked USRBIO shm: rings whose header owner pid is dead
    (crashed clients never unlink) and orphan iov buffers older than
    ``iov_max_age_s`` that no live registration references (``keep``).
    Registered segments of live owners are untouched. -> removed names.

    This is the agent-side half of the lifecycle contract: the creating
    side unlinks on orderly close; the reaper owns the crash path."""
    iov_prefix, ior_prefix = _shm_name_prefixes()
    keep = keep or set()
    removed: List[str] = []
    try:
        names = os.listdir(shm_dir)
    except OSError:
        return removed
    now = time.time()
    for name in names:
        path = os.path.join(shm_dir, name)
        if name.startswith(ior_prefix) and name not in keep:
            try:
                with open(path, "rb") as f:
                    hdr = f.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    raise ValueError("short header")
                magic, _, _, _, _, _, version, owner = _HDR.unpack(hdr)
            except (OSError, ValueError):
                continue
            if magic != MAGIC:
                continue  # not ours despite the name
            if version >= VERSION:
                # v2+ rings stamp their owner pid: liveness is the ONLY
                # reap signal. No age fallback — mmap writes never touch
                # tmpfs mtime, so a busy ring looks "old" forever, and
                # with several storage processes per host one node's
                # reaper must not unlink another node's live clients.
                if _pid_alive(owner):
                    continue
            else:
                # v1 rings carry no pid: only age can reap them
                try:
                    if now - os.stat(path).st_mtime <= iov_max_age_s:
                        continue
                except OSError:
                    continue
            try:
                os.unlink(path)
                removed.append(name)
            except OSError:
                continue
            NamedSemaphore.unlink(f"{name}-sq")
            NamedSemaphore.unlink(f"{name}-cq")
        elif name.startswith(iov_prefix) and name not in keep:
            try:
                st = os.stat(path)
            except OSError:
                continue
            if not stat.S_ISREG(st.st_mode):
                continue
            if now - st.st_mtime > iov_max_age_s:
                try:
                    os.unlink(path)
                    removed.append(name)
                except OSError:
                    pass
        elif name.startswith(HS_PREFIX) and name not in keep:
            # handshake nonce of a SIGKILLed serving process: the pid is
            # in the name (tpu3fs-hs-<pid>-<hex>)
            try:
                owner = int(name[len(HS_PREFIX):].split("-", 1)[0])
            except ValueError:
                continue
            if not _pid_alive(owner):
                try:
                    os.unlink(path)
                    removed.append(name)
                except OSError:
                    pass
    return removed
