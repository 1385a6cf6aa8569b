"""The USRBIO agent: serves registered rings against the storage cluster.

The port's own copy of ``tpu3fs/usrbio/agent.py``, over the port's
``FileIoClient`` and ``MetaStore`` (or ``MetaRpcClient``): the stripe
codec of the file client runs on its device.

The FUSE-daemon half of the reference (src/fuse/IovTable.h:10-39 iov
registration; src/fuse/FuseClients.cc:150,218 — watch threads poll submit
semaphores, ioRingWorkers run IoRing::process; src/fuse/PioV.cc splits ring
entries into chunk IOs). Here the agent owns Meta/Storage clients and worker
threads: each ring gets a dedicated worker (the reference multiplexes rings
over 3 priority-lane semaphores, IoRing.h:259-264; with a worker per ring
priorities never contend, so the ring's priority is recorded but does not
schedule), SQEs are translated to chunk reads/writes through FileIoClient,
and data moves directly between the chunk store and the client's registered
shm buffer.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from tpu3fs_torch.client.file_io import FileIoClient
from tpu3fs_torch.meta.store import MetaStore, OpenFlags
from tpu3fs_torch.meta.types import Inode
from tpu3fs_torch.usrbio.ring import Iov, IoRing, reap_stale_shm
from tpu3fs_torch.utils.result import Code, FsError, Status


def _sqe_scopes(sqe):
    """The SQE-borne request context, scoped like an inbound RPC envelope:
    QoS class from the flag bits (same positions as the wire envelope),
    trace/deadline/tenant from the token field's ``t1.*``/``d1.*``/``u1.*``
    string — so IO the agent issues on a client's behalf is admitted,
    attributed and shed exactly as if the client had spoken sockets."""
    import contextlib

    from tpu3fs_torch.analytics import spans as _spans
    from tpu3fs_torch.qos.core import class_from_flags, tagged
    from tpu3fs_torch.rpc import deadline as _deadline
    from tpu3fs_torch.tenant import identity as _tenant_id

    stack = contextlib.ExitStack()
    tclass = class_from_flags(sqe.flags)
    if tclass is not None:
        stack.enter_context(tagged(tclass))
    tok = sqe.token
    if tok:
        dl = _deadline.decode_deadline(tok)
        if dl is not None:
            stack.enter_context(_deadline.deadline_scope(dl))
        tenant = _tenant_id.decode_tenant(tok)
        if tenant is not None:
            stack.enter_context(_tenant_id.tenant_scope(tenant))
        if _spans.tracer().enabled:
            in_ctx = _spans.decode_wire(tok)
            if in_ctx is not None:
                stack.enter_context(_spans.trace_scope(in_ctx.child()))
    return stack


class _RingState:
    def __init__(self, ring: IoRing, iovs: List[Iov]):
        self.ring = ring
        self.iovs = iovs
        self.worker: Optional[threading.Thread] = None
        self.running = True
        # set when deregister gives up joining a busy worker: the worker
        # then owns the mapping and closes it on exit
        self.close_on_exit = False


class UsrbioAgent:
    """One agent per host, shared by all local USRBIO clients."""

    def __init__(self, meta: MetaStore, file_client: FileIoClient,
                 client_id: str = "usrbio-agent", *,
                 max_concurrent_ios: int = 64):
        self._meta = meta
        self._fio = file_client
        self._client_id = client_id
        # fd table (ref hf3fs_reg_fd): small int -> [inode, session, wrote]
        self._fds: Dict[int, List] = {}
        self._next_fd = 100
        self._rings: Dict[str, _RingState] = {}
        self._lock = threading.Lock()
        # host-wide IO throttle across ALL rings (the reference bounds
        # in-flight usrbio IO with semaphores per priority lane,
        # IoRing.h:259-264): one misbehaving client with a deep ring
        # cannot monopolize the storage backend
        from tpu3fs_torch.utils.executor import ConcurrencyLimiter

        self._io_limiter = ConcurrencyLimiter("usrbio-io",
                                              max_concurrent_ios)

    # -- control plane (the reference's ClientAgent service, fbs/lib) --------
    def open(self, path: str, *, write: bool = False) -> int:
        """Open + register a file; returns the fd for prep_io."""
        flags = OpenFlags.READ | (OpenFlags.WRITE if write else 0)
        try:
            res = self._meta.open(path, flags=flags, client_id=self._client_id)
        except FsError as e:
            if e.code == Code.META_NOT_FOUND and write:
                res = self._meta.create(
                    path, flags=flags, client_id=self._client_id
                )
            else:
                raise
        with self._lock:
            fd = self._next_fd
            self._next_fd += 1
            self._fds[fd] = [res.inode, res.session_id, False]
        return fd

    def close_fd(self, fd: int, length_hint: Optional[int] = None) -> None:
        with self._lock:
            entry = self._fds.pop(fd, None)
        if entry is None:
            raise FsError(Status(Code.INVALID_ARG, f"unknown fd {fd}"))
        inode, session, wrote = entry
        if session:
            self._meta.close(inode.id, session, length_hint=length_hint,
                             wrote=wrote)

    def register_iov(self, name: str, size: int) -> Iov:
        """Map a client's shm buffer into the agent (ref IovTable.addIov —
        where the reference also registers it for RDMA)."""
        return Iov(size, name=name, create=False)

    def register_ring(self, name: str, entries: int, iovs: List[Iov],
                      *, for_read: bool = True, priority: int = 1) -> None:
        ring = IoRing(entries, name=name, create=False, for_read=for_read,
                      priority=priority)
        state = _RingState(ring, iovs)
        t = threading.Thread(
            target=self._ring_worker, args=(state,), daemon=True,
            name=f"usrbio-{name}",
        )
        state.worker = t
        with self._lock:
            self._rings[name] = state
        t.start()

    def deregister_ring(self, name: str) -> None:
        with self._lock:
            state = self._rings.pop(name, None)
        if state is not None:
            state.running = False
            state.ring.submit_sem.post()  # wake the worker so it exits
            if state.worker:
                state.worker.join(timeout=5)
                if state.worker.is_alive():
                    # worker is mid-IO (slow storage op); closing the mmap
                    # under it would crash the thread and drop the in-flight
                    # completion — hand it the mapping to close on exit
                    state.close_on_exit = True
                    return
            state.ring.close()

    # -- data plane ----------------------------------------------------------
    def _ring_worker(self, state: _RingState) -> None:
        ring = state.ring
        try:
            while state.running:
                if not ring.submit_sem.wait(timeout=0.5):
                    continue
                if not state.running:
                    return
                for sqe in ring.drain_sqes():
                    with self._io_limiter, _sqe_scopes(sqe):
                        result = self._process_sqe(state, sqe)
                    ring.push_cqe(result, sqe.userdata)
        except (ValueError, FsError):
            # ring mmap closed under us during deregistration (ValueError)
            # or the header tore (USRBIO_TORN_RING): exit quietly — the
            # reaper owns cleanup of torn/abandoned segments
            return
        finally:
            if state.close_on_exit:
                state.ring.close()

    def _process_sqe(self, state: _RingState, sqe) -> int:
        """-> bytes moved, or negative Code on failure."""
        entry = self._fds.get(sqe.fd)
        if entry is None:
            return -int(Code.META_NOT_FOUND)
        inode = entry[0]
        if sqe.iov_id >= len(state.iovs):
            return -int(Code.INVALID_ARG)
        iov = state.iovs[sqe.iov_id]
        if sqe.iov_offset + sqe.length > iov.size:
            return -int(Code.INVALID_ARG)
        try:
            if sqe.is_read:
                # refresh length so EOF clamping sees recent writes
                fresh = self._meta.batch_stat([inode.id])[0]
                src = fresh if fresh is not None else inode
                # replies land directly in the registered shm window — no
                # assembly buffer, no iov copy (round-2 weak: zero-copy
                # reads into usrbio iovs)
                return self._fio.read_into(
                    src, sqe.file_offset, sqe.length,
                    iov.view(sqe.iov_offset, sqe.length))
            data = iov.read(sqe.iov_offset, sqe.length)
            # flag before issuing so a close_fd racing this write still
            # sees the session as written
            entry[2] = True
            written = self._fio.write(inode, sqe.file_offset, data)
            self._meta.sync(inode.id, length_hint=sqe.file_offset + written)
            return written
        except FsError as e:
            return -int(e.code)
        except Exception:
            # transport/storage faults must surface as a CQE error, never
            # kill the ring worker (clients would block forever)
            return -int(Code.INTERNAL)

    def reap_stale(self, *, iov_max_age_s: float = 3600.0) -> list:
        """Reaper pass over /dev/shm: unlink rings whose stamped owner pid
        is dead and orphan iov buffers nothing live references — the crash
        half of the shm lifecycle (the creating side unlinks on orderly
        close). Live registrations served by this agent are protected."""
        with self._lock:
            keep = set(self._rings)
            for state in self._rings.values():
                keep.update(v.name for v in state.iovs)
        return reap_stale_shm(keep=keep, iov_max_age_s=iov_max_age_s)

    def stop(self) -> None:
        for name in list(self._rings):
            self.deregister_ring(name)
