"""Build and load the CUDA kernel library (``csrc/*.cu``) on first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object, all of
them at once, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``. Nothing here includes PyTorch's
headers, so a build takes seconds. The library is named by a hash of the
sources and flags and lives in ``_build/`` (git-ignored); a changed source
builds a new one. A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
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


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first when its hash is new."""
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    target = BUILD_DIR / f"libtpu3fs_torch_{_digest(sources)}.so"
    if not target.exists():
        _build(sources, target)
    lib = ctypes.CDLL(str(target))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tpu3fs_error_string.argtypes = [ctypes.c_int]
    lib.tpu3fs_error_string.restype = ctypes.c_char_p
    return lib


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


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry."""
    if rc:
        what = library().tpu3fs_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {what} ({rc})")
