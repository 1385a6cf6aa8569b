"""Build and load the host C++ libraries (``hostsrc/*.cpp``) on first use.

``hostsrc/`` holds the port's own copies of the JAX package's native
sources: ``chunk_engine.cpp`` (the chunk engine on disk) and ``rpc_net.cpp``
(the epoll transport and its storage fast paths). Each is compiled by
``g++`` with ``native/Makefile``'s flags into its own shared library with
a plain C interface, loaded with ``ctypes``. ``usrbio_loadgen.cpp`` (the
foreign-process USRBIO load generator, which speaks the ring ABI and the
``3fs-virt`` handshake through a FUSE mount) is built the same way into
an executable (``executable``). A built file's name carries a digest of
its source and flags, so a changed source builds a new one and a stale
one is never used; nothing is written outside ``_build/`` (git-ignored). The first use builds every missing library at once, one
``g++`` a source, under a file lock in ``_build/``: processes started
together on a fresh tree build once, the first builds and the others wait
for it. A failed build raises with the compiler's output; there is no
fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent
SRC_DIR = _PKG_DIR / "hostsrc"
BUILD_DIR = _PKG_DIR / "_build"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]
LIBS = ["-lpthread"]
SOURCES = ("chunk_engine", "rpc_net")
#: sources built into executables (no ``-shared``, no ``-fPIC`` needed)
PROGRAMS = ("usrbio_loadgen",)
EXE_FLAGS = [f for f in CXX_FLAGS if f != "-shared"]


def compiler() -> str:
    """``$CXX``, else ``g++`` from PATH; raise if absent."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found on PATH (and CXX unset): the host "
                           "C++ libraries cannot be built")
    return cxx


def _flags(name: str):
    return EXE_FLAGS if name in PROGRAMS else CXX_FLAGS


def library_path(name: str) -> Path:
    """Where the library (or, for ``PROGRAMS``, the executable) built from
    ``hostsrc/<name>.cpp`` lives: its name carries a digest of the source
    and the flags."""
    src = SRC_DIR / f"{name}.cpp"
    h = hashlib.sha256(" ".join(_flags(name) + LIBS).encode())
    h.update(src.read_bytes())
    if name in PROGRAMS:
        return BUILD_DIR / f"tpu3fs_torch_{name}_{h.hexdigest()[:16]}"
    return BUILD_DIR / f"libtpu3fs_torch_{name}_{h.hexdigest()[:16]}.so"


def _build(names) -> None:
    """Compile each of ``names`` with its own ``g++``, all started
    together; each file lands by an atomic rename."""
    cxx = compiler()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in names:
            out = Path(tmp) / library_path(name).name
            procs.append((name, out, subprocess.Popen(
                [cxx, *_flags(name), "-o", str(out),
                 str(SRC_DIR / f"{name}.cpp"), *LIBS],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, out, proc in procs:
            log = proc.communicate()[0]
            target = library_path(name)
            target.with_suffix(".log").write_text(log)
            if proc.returncode:
                failed.append(f"{name}.cpp:\n{log}")
            else:
                os.replace(out, target)  # a reader never sees half a file
        if failed:
            raise RuntimeError("g++ failed for " + "\n".join(failed))


_lock = threading.Lock()
_loaded: dict = {}


def _ensure_built(names) -> None:
    """Build whichever of ``names`` is missing, under the file lock (the
    caller holds ``_lock``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "hostbuild.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            missing = [n for n in names if not library_path(n).exists()]
            if missing:
                _build(missing)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``hostsrc/<name>.cpp``, every missing host
    library built first. Loaded with ctypes' default ``RTLD_LOCAL``, so
    the JAX package's libraries (the same C symbols) may share the
    process: each package binds its own."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        _ensure_built(SOURCES)
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def executable(name: str) -> Path:
    """The path of the executable built from ``hostsrc/<name>.cpp`` (one
    of ``PROGRAMS``), built first if missing; a failed build raises."""
    if name not in PROGRAMS:
        raise ValueError(f"{name} is not one of {PROGRAMS}")
    with _lock:
        _ensure_built([name])
        return library_path(name)
