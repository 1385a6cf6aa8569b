"""The C allocator a configuration's processes run with.

3FS's services replace malloc with jemalloc or mimalloc (its
``src/memory/``), which keep freed memory in the process for the next
request. glibc's malloc instead maps every block over its mmap threshold
(128 KiB at first, at most 32 MiB) afresh and unmaps it when it is freed,
and hands the heap's free top back: a client's buffers of whole stripes
then fault every page in again on every call. A configuration's
``allocator`` entry names the glibc ``mallopt(3)`` settings that keep freed
memory in the process, as those allocators do. The harness sets them before
it imports the program and before any of its threads start.
"""

from __future__ import annotations

import ctypes
import ctypes.util

# mallopt(3) parameters, by the names a configuration gives them
PARAMS = {"trim_threshold": -1, "top_pad": -2, "mmap_threshold": -3,
          "mmap_max": -4, "arena_max": -8}
INT_MAX = 2 ** 31 - 1


def check(settings: dict) -> None:
    """Raise ValueError unless every setting is a known name with a value
    that a C int holds."""
    for name, value in settings.items():
        if name not in PARAMS:
            raise ValueError(f"no mallopt setting {name!r}; known: "
                             f"{', '.join(sorted(PARAMS))}")
        if not isinstance(value, int) or not 0 <= value <= INT_MAX:
            raise ValueError(f"allocator {name}: {value!r} is not an int "
                             f"from 0 to {INT_MAX}")


def apply(settings: dict) -> list:
    """Set each of ``settings`` (name -> value) in this process.
    -> one line a setting. Raises where the C library has no mallopt or
    refuses a setting, so that no run goes on with another allocator than
    its configuration states."""
    check(settings)
    if not settings:
        return []
    libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
    mallopt = getattr(libc, "mallopt", None)
    if mallopt is None:
        raise RuntimeError("the C library has no mallopt: the allocator "
                           "the configuration states cannot be set")
    mallopt.argtypes = (ctypes.c_int, ctypes.c_int)
    mallopt.restype = ctypes.c_int
    lines = []
    for name, value in settings.items():
        if mallopt(PARAMS[name], value) != 1:
            raise RuntimeError(f"mallopt refused {name} = {value}")
        lines.append(f"{name} {value}")
    return lines
