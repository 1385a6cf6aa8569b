"""POSIX named semaphores via ctypes (librt/libpthread sem_open family).

The port's own copy of ``tpu3fs/usrbio/sem.py``. On glibc 2.34 and later
libpthread and librt are folded into libc (their names remain as stubs
that resolve ``sem_open`` through it); where neither name is found, libc
itself is loaded. ``LIBRARY`` names the library that was loaded.

The USRBIO handshake uses named semaphores for cross-process submit/complete
wakeups, exactly like the reference (sem_open in src/lib/api/UsrbIo.cc:
254-386). No pybind11 in this image, so ctypes it is.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno
import os

_libname = (ctypes.util.find_library("pthread")
            or ctypes.util.find_library("rt")
            or ctypes.util.find_library("c") or "libc.so.6")
_lib = ctypes.CDLL(_libname, use_errno=True)
LIBRARY = _libname

_lib.sem_open.restype = ctypes.c_void_p
_lib.sem_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_uint, ctypes.c_uint]
_lib.sem_post.argtypes = [ctypes.c_void_p]
_lib.sem_wait.argtypes = [ctypes.c_void_p]
_lib.sem_trywait.argtypes = [ctypes.c_void_p]
_lib.sem_timedwait.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
_lib.sem_close.argtypes = [ctypes.c_void_p]
_lib.sem_unlink.argtypes = [ctypes.c_char_p]

_O_CREAT = 0o100

_SEM_FAILED = ctypes.c_void_p(0).value  # SEM_FAILED == (sem_t*)0 on Linux


class _timespec(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_nsec", ctypes.c_long)]


class NamedSemaphore:
    def __init__(self, name: str, create: bool = False, value: int = 0):
        if not name.startswith("/"):
            name = "/" + name
        self.name = name
        flags = _O_CREAT if create else 0
        handle = _lib.sem_open(name.encode(), flags, 0o644, value)
        if handle in (None, _SEM_FAILED):
            raise OSError(ctypes.get_errno(), f"sem_open({name})")
        self._h = handle

    def post(self) -> None:
        if _lib.sem_post(self._h) != 0:
            raise OSError(ctypes.get_errno(), "sem_post")

    def wait(self, timeout: float | None = None) -> bool:
        """True if acquired; False on timeout."""
        if timeout is None:
            while True:
                if _lib.sem_wait(self._h) == 0:
                    return True
                if ctypes.get_errno() != errno.EINTR:
                    raise OSError(ctypes.get_errno(), "sem_wait")
        import time as _time

        deadline = _timespec()
        t = _time.time() + timeout  # sem_timedwait takes CLOCK_REALTIME
        deadline.tv_sec = int(t)
        deadline.tv_nsec = int((t - int(t)) * 1e9)
        while True:
            if _lib.sem_timedwait(self._h, ctypes.byref(deadline)) == 0:
                return True
            e = ctypes.get_errno()
            if e == errno.ETIMEDOUT:
                return False
            if e != errno.EINTR:
                raise OSError(e, "sem_timedwait")

    def try_wait(self) -> bool:
        if _lib.sem_trywait(self._h) == 0:
            return True
        e = ctypes.get_errno()
        if e == errno.EAGAIN:
            return False
        raise OSError(e, "sem_trywait")

    def close(self) -> None:
        if self._h:
            _lib.sem_close(self._h)
            self._h = None

    @staticmethod
    def unlink(name: str) -> None:
        if not name.startswith("/"):
            name = "/" + name
        _lib.sem_unlink(name.encode())
