"""Client-side USRBIO API — the hf3fs_usrbio.h surface, Python-shaped.

The port's own copy of ``tpu3fs/usrbio/api.py``.

Mirrors src/lib/api/hf3fs_usrbio.h:71-165:

  hf3fs_iovcreate   -> UsrbioClient.iovcreate(size)
  hf3fs_iorcreate4  -> UsrbioClient.iorcreate(entries, for_read, io_depth,
                                              priority)
  hf3fs_reg_fd      -> UsrbioClient.reg_fd(path, write=...)
  hf3fs_prep_io     -> UsrbioClient.prep_io(ior, iov, ...)
  hf3fs_submit_ios  -> UsrbioClient.submit_ios(ior)
  hf3fs_wait_for_ios-> UsrbioClient.wait_for_ios(ior, min_results, timeout)

The shm segments + named semaphores are the real cross-process transport;
the control handshake (registration) goes to the agent, playing the role of
the reference's magic-symlink protocol in the FUSE virtual directory.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from tpu3fs_torch.usrbio.agent import UsrbioAgent
from tpu3fs_torch.usrbio.ring import Iov, IoRing


class UsrbioClient:
    def __init__(self, agent: UsrbioAgent):
        self._agent = agent
        self._ring_iovs: Dict[str, List[Iov]] = {}

    # -- setup ---------------------------------------------------------------
    def iovcreate(self, size: int) -> Iov:
        return Iov(size, create=True)

    def iorcreate(
        self,
        entries: int,
        iovs: List[Iov],
        *,
        for_read: bool = True,
        io_depth: int = 0,
        priority: int = 1,
    ) -> IoRing:
        ring = IoRing(entries, create=True, for_read=for_read,
                      io_depth=io_depth, priority=priority)
        # registration handshake: agent maps the same shm by name
        agent_iovs = [self._agent.register_iov(v.name, v.size) for v in iovs]
        self._agent.register_ring(
            ring.name, entries, agent_iovs, for_read=for_read, priority=priority
        )
        self._ring_iovs[ring.name] = iovs
        return ring

    def reg_fd(self, path: str, *, write: bool = False) -> int:
        return self._agent.open(path, write=write)

    def dereg_fd(self, fd: int, length_hint: Optional[int] = None) -> None:
        self._agent.close_fd(fd, length_hint)

    # -- IO ------------------------------------------------------------------
    def prep_io(
        self,
        ior: IoRing,
        iov: Iov,
        iov_offset: int,
        length: int,
        fd: int,
        file_offset: int,
        *,
        read: bool,
        userdata: int = 0,
    ) -> int:
        iov_id = self._ring_iovs[ior.name].index(iov)
        return ior.prep_io(
            iov_offset, length, file_offset, fd,
            read=read, userdata=userdata, iov_id=iov_id,
        )

    @staticmethod
    def submit_ios(ior: IoRing) -> None:
        ior.submit()

    @staticmethod
    def wait_for_ios(ior: IoRing, min_results: int, timeout: Optional[float] = None):
        return ior.wait_for_ios(min_results, timeout)

    def iordestroy(self, ior: IoRing) -> None:
        self._agent.deregister_ring(ior.name)
        self._ring_iovs.pop(ior.name, None)
        # the client side owns the shm segment + named semaphores: unlink
        # here or each create/destroy cycle leaks /dev/shm entries
        ior.close(unlink=True)

    def iovdestroy(self, iov: Iov) -> None:
        iov.close(unlink=True)
