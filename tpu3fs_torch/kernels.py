"""Build and load the CUDA kernel library (``csrc/*.cu``) on first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object, all of
them at once, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``. Nothing here includes PyTorch's
headers, so a build takes seconds. The library is named by a hash of the
sources and flags and lives in ``_build/`` (git-ignored); a changed source
builds a new one. A failed build raises: there is no fallback. The build
holds a file lock in ``_build/``, so service processes started together on
a fresh tree run ``nvcc`` once: the first builds, the others wait for it
and load its library.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
# C entry -> argument types; every entry returns cudaGetLastError()
_SIGNATURES = {
    "tpu3fs_gf2_matmul": [_P, _P, _P, _I64, _I64, _I64, _I64, _P],
    "tpu3fs_gf2_mma": [_P, _P, _P, _I64, _I64, _I64, _I64, _P],
    "tpu3fs_crc32c_blocks": [_P, _P, _P, _I64, _I64, _I64, _P],
    "tpu3fs_crc32c_mma": [_P, _P, _P, _P, _I64, _I64, _I64, _P],
    "tpu3fs_mma_rate": [_I64, _I64, _I64, _P, _P],
    "tpu3fs_xor_reduce": [_P, _P, _I64, _I64, _I64, _P],
    "tpu3fs_xor_fold": [_P, _P, _P] + [_I64] * 6 + [_P],
    "tpu3fs_xor_fold_atomic": [_P, _P, _I64, _I64, _P],
    "tpu3fs_placement_score": [_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P],
    "tpu3fs_swap_score": [_P] * 8 + [_I64] * 4 + [_P],
    "tpu3fs_swap_apply": [_P] * 7 + [_I64] * 5 + [_P],
    "tpu3fs_copy2d_h2d": [_P, _I64, _P, _I64, _I64, _I64, _P],
}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda/bin or PATH; raise if absent."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found in CUDA_HOME, /usr/local/cuda/bin or "
                       "PATH: the CUDA kernels cannot be built")


def _sources() -> list:
    return sorted(SRC_DIR.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(sources, target: Path) -> None:
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources:  # one nvcc per source, all started together
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        failed = [s.name for s, p in zip(sources, procs) if p.returncode]
        if not failed:
            tmp_so = Path(tmp) / target.name
            link = subprocess.run(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                 *map(str, objs), "-o", str(tmp_so)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs.append(link.stdout)
            if link.returncode:
                failed.append("link")
        log = "\n".join(logs)
        target.with_suffix(".log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
        os.replace(tmp_so, target)  # atomic: a reader never sees half a file


_library_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first when its hash is new. The
    first launch may come from several threads at once (the loader's fetch
    workers, the readahead): the lock makes one of them build and load,
    and the others wait for it and take its library."""
    with _library_lock:
        return _load()


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    target = BUILD_DIR / f"libtpu3fs_torch_{_digest(sources)}.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # across processes: one builds, the others block here and then find
    # the library (the thread lock in library() covers one process)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not target.exists():
                _build(sources, target)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    lib = ctypes.CDLL(str(target))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tpu3fs_error_string.argtypes = [ctypes.c_int]
    lib.tpu3fs_error_string.restype = ctypes.c_char_p
    return lib


library.cache_info = _load.cache_info
library.cache_clear = _load.cache_clear


def build_log() -> str:
    """nvcc's output (ptxas register and shared-memory report) of the
    library that ``library()`` loaded."""
    target = BUILD_DIR / f"libtpu3fs_torch_{_digest(_sources())}.log"
    return target.read_text() if target.exists() else ""


def launch(entry: str, device, *args) -> None:
    """Call C entry ``entry`` on ``device``'s current stream: tensors are
    passed as their data pointers, other arguments as they are; a nonzero
    return raises."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        rc = getattr(library(), entry)(*ptrs, stream)
    check(rc, entry)


_count_lock = threading.Lock()


def count(fn, attr: str = "launches") -> None:
    """Add one to the counter ``fn.<attr>`` (a wrapper's launches or a
    plain version's calls) under one lock: the storage services' forward
    helpers and update workers and the client's hedged reads reach one
    codec from several threads, and ``+=`` on an attribute is not atomic."""
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + 1)


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry."""
    if rc:
        what = library().tpu3fs_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {what} ({rc})")


#: every kernel wrapper's launch counter and every plain version's call
#: counter: name -> (module, dotted object, attribute)
COUNTERS = {
    "gf2_matmul": ("tpu3fs_torch.ops.gf2_matmul", "gf2_matmul", "launches"),
    "gf2_matmul_bitslice": ("tpu3fs_torch.ops.gf2_matmul",
                            "gf2_matmul_bitslice", "launches"),
    "gf2_matmul_plain": ("tpu3fs_torch.ops.gf2_matmul", "gf2_matmul_plain",
                         "calls"),
    "crc32c_blocks": ("tpu3fs_torch.ops.crc32c", "crc32c_blocks",
                      "launches"),
    "crc32c_blocks_table": ("tpu3fs_torch.ops.crc32c", "crc32c_blocks_table",
                            "launches"),
    "crc32c_plain": ("tpu3fs_torch.ops.crc32c", "BatchCrc32c.compute",
                     "calls"),
    "xor_reduce": ("tpu3fs_torch.ops.xor_reduce", "xor_reduce", "launches"),
    "xor_reduce_plain": ("tpu3fs_torch.ops.xor_reduce", "xor_reduce_plain",
                         "calls"),
    "xor_fold_crc": ("tpu3fs_torch.ops.xor_fold", "xor_fold_crc",
                     "launches"),
    "xor_fold_crc_plain": ("tpu3fs_torch.ops.xor_fold", "xor_fold_crc_plain",
                           "calls"),
    "xor_fold_crc_atomic": ("tpu3fs_torch.ops.xor_fold",
                            "xor_fold_crc_atomic", "launches"),
    "score_batch": ("tpu3fs_torch.ops.placement_score", "score_batch",
                    "launches"),
    "score_batch_plain": ("tpu3fs_torch.ops.placement_score",
                          "score_batch_plain", "calls"),
    "swap_score": ("tpu3fs_torch.ops.swap_score", "swap_score", "launches"),
    "swap_score_plain": ("tpu3fs_torch.ops.swap_score", "swap_score_plain",
                         "calls"),
    "swap_apply": ("tpu3fs_torch.ops.swap_score", "swap_apply", "launches"),
    "swap_apply_plain": ("tpu3fs_torch.ops.swap_score", "swap_apply_plain",
                         "calls"),
}


def counter_objects() -> dict:
    """name -> (object, attribute) of each of ``COUNTERS``: where its count
    lives, to read or to set to 0."""
    import importlib

    out = {}
    for name, (module, path, attr) in COUNTERS.items():
        obj = importlib.import_module(module)
        for part in path.split("."):
            obj = getattr(obj, part)
        out[name] = (obj, attr)
    return out


def counts() -> dict:
    """name -> the current value of each of ``COUNTERS``."""
    return {n: getattr(o, a) for n, (o, a) in counter_objects().items()}


def launch_recorder(tags=None):
    """A monitor recorder of this process's kernel launches: each
    collection reports, as ``kernel.launches`` tagged ``kernel=<name>``
    (and ``tags``),
    how much each of ``COUNTERS`` grew since the one before (nothing for a
    counter that did not). A service that pushes samples to the collector
    so shows which kernels its requests launched. The caller keeps the
    recorder alive (the monitor holds it weakly)."""
    from tpu3fs_torch.monitor.recorder import Sample, _Recorder

    class LaunchRecorder(_Recorder):
        def __init__(self):
            super().__init__("kernel.launches", tags)
            self._last = counts()

        def collect(self, now: float):
            with self._lock:
                cur = counts()
                grew = {n: cur[n] - self._last.get(n, 0) for n in cur}
                self._last = cur
            return [Sample(self.name, now, {**self.tags, "kernel": n},
                           value=float(v), count=int(v))
                    for n, v in sorted(grew.items()) if v > 0]

    return LaunchRecorder()
