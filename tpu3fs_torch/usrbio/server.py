"""USRBIO ring agent hosted INSIDE the storage process.

The port's own copy of ``tpu3fs/usrbio/server.py``; the serving binary
hosts it too, for peers' peerRead rings. One change: ``stop`` waits for
the dispatch pool's threads (queued SQEs are cancelled), so a stopped
app leaves no thread behind.

The serving half of the shm data plane: clients register (ring, iov) pairs
through a small control-plane RPC service (same-host proof via a /dev/shm
nonce the client must be able to read), then a worker per ring drains
RPC-mode SQEs and dispatches every one through ``tpu3fs_torch.rpc.net.
dispatch_packet`` — the SAME admission entry the socket transports run —
so deadline sheds, tenant quota charges, QoS class admission, fault
injection, tracing and the storage service's internal gates all apply to
shm traffic identically (check 7 in tools/check_rpc_registry.py pins this
statically: this module may not call service handlers any other way).

Read replies gather engine buffer views straight into the client's
registered shm region (one memcpy, engine -> user memory — the RDMA-WRITE
analogue); write payloads arrive as views over the client's staging region
and take the engine's usual single owned copy at install. No sockets, no
syscalls beyond the semaphore doorbells.
"""

from __future__ import annotations

import os
import pathlib
import secrets
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from tpu3fs_torch.rpc.net import (
    FLAG_BULK,
    FLAG_IS_REQ,
    MessagePacket,
    ServiceDef,
    dispatch_packet,
)
from tpu3fs_torch.usrbio.ring import (
    SHM_DIR,
    Iov,
    IoRing,
    reap_stale_shm,
    validate_shm_name,
)
from tpu3fs_torch.usrbio.transport import (
    HANDSHAKE_PREFIX,
    RING_METHODS,
    USRBIO_SERVICE_ID,
    UsrbioDeregisterReq,
    UsrbioHandshakeRsp,
    UsrbioRegisterReq,
    UsrbioRegisterRsp,
    parse_request,
    recorders,
    write_reply,
)
from tpu3fs_torch.utils.result import Code, FsError, Status

# the QoS-class flag bits ride the SQE at their envelope positions; only
# they may pass through into the dispatched packet's flags
from tpu3fs_torch.qos.core import TC_FLAG_MASK


class _RingState:
    def __init__(self, ring: IoRing, iov: Iov, owner_pid: int):
        self.ring = ring
        self.iov = iov
        self.owner_pid = owner_pid
        self.worker: Optional[threading.Thread] = None
        self.running = True
        self.cq_lock = threading.Lock()   # pool threads push CQEs


class UsrbioRpcHost:
    """One per storage process: owns the handshake nonce, the registered
    rings, their worker threads and the dispatch pool. ``server`` is the
    process's RpcServer/NativeRpcServer — dispatch_packet reads its
    service table and admission state, so whatever the socket path
    enforces, the ring path enforces."""

    def __init__(self, server, *, dispatch_workers: int = 4,
                 reap_interval_s: float = 60.0):
        self._server = server
        self._rings: Dict[str, _RingState] = {}
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, dispatch_workers),
            thread_name_prefix="usrbio-dispatch")
        self._depth = 0            # SQEs currently dispatching
        self._depth_lock = threading.Lock()
        self.reap_interval_s = reap_interval_s
        self._stopped = False
        # the same-host proof: a nonce file in /dev/shm only a co-located
        # client can read (the magic-symlink handshake's RPC-era analogue)
        self._nonce_name = f"{HANDSHAKE_PREFIX}{os.getpid()}-" \
                           f"{secrets.token_hex(4)}"
        self._nonce = secrets.token_hex(16)
        pathlib.Path(SHM_DIR, self._nonce_name).write_text(self._nonce)

    # -- control plane -------------------------------------------------------
    def handshake(self) -> UsrbioHandshakeRsp:
        return UsrbioHandshakeRsp(
            supported=not self._stopped, nonce_name=self._nonce_name,
            pid=os.getpid())

    def register(self, req: UsrbioRegisterReq) -> UsrbioRegisterRsp:
        if self._stopped:
            return UsrbioRegisterRsp(False, "host stopped")
        if req.nonce != self._nonce:
            # the client could not read our /dev/shm: different host (or
            # a stale nonce from before a restart) — sockets it is
            return UsrbioRegisterRsp(False, "nonce mismatch: not same-host")
        try:
            # names come from the client and are joined under /dev/shm in
            # THIS process: prefix + charset gating here (and O_NOFOLLOW +
            # fstat inside Iov/IoRing) is what keeps a hostile co-located
            # client from steering the storage process into mapping an
            # arbitrary file read-write
            validate_shm_name(req.iov_name, "tpu3fs-iov-")
            validate_shm_name(req.ring_name, "tpu3fs-ior-")
        except FsError as e:
            return UsrbioRegisterRsp(False, str(e))
        try:
            iov = Iov(req.iov_size, name=req.iov_name, create=False)
        except (OSError, FsError) as e:
            return UsrbioRegisterRsp(False, f"iov map failed: {e}")
        try:
            ring = IoRing(req.entries, name=req.ring_name, create=False)
        except (OSError, FsError) as e:
            iov.close()
            return UsrbioRegisterRsp(False, f"ring map failed: {e}")
        state = _RingState(ring, iov, req.owner_pid or ring.owner_pid)
        t = threading.Thread(target=self._ring_worker, args=(state,),
                             daemon=True, name=f"usrbio-{req.ring_name}")
        state.worker = t
        with self._lock:
            if req.ring_name in self._rings:
                ring.close()
                iov.close()
                return UsrbioRegisterRsp(False, "ring already registered")
            self._rings[req.ring_name] = state
        t.start()
        return UsrbioRegisterRsp(True, "")

    def deregister(self, req: UsrbioDeregisterReq) -> UsrbioRegisterRsp:
        self._drop_ring(req.ring_name)
        return UsrbioRegisterRsp(True, "")

    def _drop_ring(self, name: str, *, unlink: bool = False) -> None:
        with self._lock:
            state = self._rings.pop(name, None)
        if state is None:
            return
        state.running = False
        try:
            state.ring.submit_sem.post()  # wake the worker so it exits
        except OSError:
            pass
        if state.worker is not None and \
                state.worker is not threading.current_thread():
            state.worker.join(timeout=5)
        state.ring.close(unlink=unlink)
        state.iov.close(unlink=unlink)

    # -- data plane ----------------------------------------------------------
    def _ring_worker(self, state: _RingState) -> None:
        ring = state.ring
        recs = recorders()
        while state.running and not self._stopped:
            try:
                if not ring.submit_sem.wait(timeout=0.5):
                    continue
                if not state.running:
                    return
                sqes = ring.drain_sqes()
            except (ValueError, FsError):
                # mmap closed under us / header torn: the owner is gone
                # or the segment corrupt — stop serving it; the reaper
                # collects the files if the owner died
                self._drop_ring_async(ring.name)
                return
            if not sqes:
                continue
            recs["submitted"].add(len(sqes))
            # hand every SQE to the dispatch pool and go straight back to
            # draining: a cross-process client preps stripes while the
            # first is already being served, and the drain loop must
            # never sit behind a dispatch (stripe overlap is the whole
            # pipelining story; in-flight work is bounded by the ring's
            # own entries, so the pool queue cannot run away)
            for sqe in sqes:
                self._pool.submit(self._dispatch_sqe, state, sqe)

    def _drop_ring_async(self, name: str) -> None:
        threading.Thread(target=self._drop_ring, args=(name,),
                         daemon=True).start()

    def _dispatch_sqe(self, state: _RingState, sqe) -> None:
        recs = recorders()
        with self._depth_lock:
            self._depth += 1
            recs["agent_depth"].set(self._depth)
        try:
            result = self._process_rpc_sqe(state, sqe)
        except FsError as e:
            result = -int(e.code)
        except Exception:
            # a transport bug must surface as a CQE error, never kill
            # the ring worker (the client would block forever)
            result = -int(Code.INTERNAL)
        finally:
            with self._depth_lock:
                self._depth -= 1
                recs["agent_depth"].set(self._depth)
        try:
            with state.cq_lock:
                state.ring.push_cqe(result, sqe.userdata)
        except (ValueError, FsError):
            pass  # ring torn down mid-op
        recs["completed"].add()

    def _process_rpc_sqe(self, state: _RingState, sqe) -> int:
        """One RPC-mode SQE -> dispatched reply staged in the client's
        reply region; -> total reply bytes or -Code."""
        if not sqe.is_rpc:
            return -int(Code.USRBIO_UNSUPPORTED)
        if (sqe.service_id, sqe.method_id) not in RING_METHODS:
            return -int(Code.USRBIO_UNSUPPORTED)
        iov = state.iov
        if sqe.iov_id != 0:
            return -int(Code.USRBIO_BAD_IOV)
        if sqe.iov_offset + sqe.length > iov.size \
                or sqe.rsp_offset + sqe.rsp_capacity > iov.size:
            return -int(Code.USRBIO_BAD_IOV)
        region = iov.view(sqe.iov_offset, sqe.length)
        payload, bulk = parse_request(region, sqe.has_bulk)
        pkt = MessagePacket(
            uuid="",  # shm is a point-to-point queue: no stream to match
            service_id=sqe.service_id,
            method_id=sqe.method_id,
            flags=FLAG_IS_REQ | (sqe.flags & TC_FLAG_MASK)
            | (FLAG_BULK if bulk is not None else 0),
            status=int(Code.OK),
            payload=payload,
            message=sqe.token,
        )
        pkt.timestamps.server_receive = time.monotonic()
        # THE shared admission entry (tools/check_rpc_registry.py check 7):
        # deadline shed at ring dequeue, tenant + class admission, context
        # scoping, the handler — identical to a socket dispatch
        reply, reply_iovs = dispatch_packet(self._server, pkt, bulk)
        total = write_reply(iov, sqe.rsp_offset, sqe.rsp_capacity,
                            reply.status, reply.message, reply.payload,
                            reply_iovs)
        if total < 0:
            return -int(Code.USRBIO_REPLY_OVERFLOW)
        nbytes = (sum(len(b) for b in bulk) if bulk else 0) + total
        recorders()["bytes"].add(nbytes)
        return total

    # -- lifecycle -----------------------------------------------------------
    def reap_pass(self, *, iov_max_age_s: float = 3600.0) -> List[str]:
        """Stale-shm reaper: drop registrations whose owner pid died, then
        collect leaked /dev/shm segments (dead-owner rings, aged orphan
        iovs) — live registrations are protected by name."""
        dead = []
        with self._lock:
            for name, state in self._rings.items():
                if state.owner_pid and not _pid_alive(state.owner_pid):
                    dead.append(name)
        for name in dead:
            self._drop_ring(name, unlink=True)
        with self._lock:
            keep = set(self._rings)
            for state in self._rings.values():
                keep.add(state.iov.name)
            keep.add(self._nonce_name)
        return reap_stale_shm(keep=keep, iov_max_age_s=iov_max_age_s)

    def stop(self) -> None:
        self._stopped = True
        for name in list(self._rings):
            self._drop_ring(name)
        self._pool.shutdown(wait=True, cancel_futures=True)
        try:
            os.unlink(os.path.join(SHM_DIR, self._nonce_name))
        except OSError:
            pass


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


# -- service binding ---------------------------------------------------------

def bind_usrbio_service(server, host: UsrbioRpcHost) -> None:
    """Control plane for ring registration (the RPC-era analogue of the
    reference's magic-symlink protocol): handshake names the same-host
    nonce, register/deregister manage ring workers. The DATA plane never
    touches these sockets again."""
    from tpu3fs_torch.rpc.services import Empty

    s = ServiceDef(USRBIO_SERVICE_ID, "Usrbio")
    s.method(1, "usrbioHandshake", Empty, UsrbioHandshakeRsp,
             lambda r: host.handshake())
    s.method(2, "usrbioRegister", UsrbioRegisterReq, UsrbioRegisterRsp,
             host.register)
    s.method(3, "usrbioDeregister", UsrbioDeregisterReq, UsrbioRegisterRsp,
             host.deregister)
    server.add_service(s)
