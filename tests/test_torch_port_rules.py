"""Rules the port keeps: tpu3fs_torch and chip_smoke.py import neither jax
nor tpu3fs; importing the package touches no CUDA and no triton; entry
points default to the card and raise without one; the kernel build
directory is git-ignored."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from tpu3fs_torch import kernels
from tpu3fs_torch.ops.stripe import StripeCodec

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "tpu3fs_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_neither_jax_nor_tpu3fs(path):
    bad = {"jax", "jaxlib", "tpu3fs"} & set(_imported_roots(path))
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_import_touches_no_cuda_and_no_triton():
    code = ("import sys, torch, tpu3fs_torch, tpu3fs_torch.entry, "
            "tpu3fs_torch.convert, tpu3fs_torch.kernels, tpu3fs_torch.kv, "
            "tpu3fs_torch.rpc.serde, tpu3fs_torch.rpc.health, "
            "tpu3fs_torch.meta, tpu3fs_torch.mgmtd, tpu3fs_torch.qos, "
            "tpu3fs_torch.client, tpu3fs_torch.fabric; "
            "print(torch.cuda.is_initialized(), 'triton' in sys.modules, "
            "tpu3fs_torch.kernels.library.cache_info().currsize)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["False", "False", "0"]


def test_import_parallel_starts_no_process_group():
    code = ("import torch, torch.distributed as dist, tpu3fs_torch.parallel, "
            "tpu3fs_torch.entry; "
            "print(dist.is_initialized(), torch.cuda.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["False", "False"]


def test_cpu_only_machine_raises_without_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StripeCodec(12, 4, 4096)


def test_gitignore_lists_the_build_directory():
    ignored = (ROOT / ".gitignore").read_text().split()
    rel = kernels.BUILD_DIR.relative_to(ROOT).as_posix()
    assert rel in ignored or rel + "/" in ignored


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "Path", lambda p: tmp_path / "absent")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.nvcc_path()


def test_import_kvcache_and_serving_touches_no_cuda():
    code = ("import sys, torch, tpu3fs_torch.kvcache, tpu3fs_torch.serving, "
            "tpu3fs_torch.serving.service; "
            "print(torch.cuda.is_initialized(), 'triton' in sys.modules, "
            "tpu3fs_torch.kernels.library.cache_info().currsize)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["False", "False", "0"]


def test_get_blocks_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is usable")
    import numpy as np

    from tpu3fs_torch.kvcache import PrefixBlockStore, encode_array

    raw = encode_array(np.ones((2, 4), np.float16))

    class Cache:
        def batch_get(self, keys):
            return [raw] * len(keys)

    store = PrefixBlockStore(Cache(), block_tokens=2)
    assert len(store.get_blocks([1, 2], device="cpu")) == 1
    for device in ("cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            store.get_blocks([1, 2], device=device)


TRAIN_FILES = sorted((ROOT / "tpu3fs_torch" / "ckpt").glob("*.py")) + sorted(
    (ROOT / "tpu3fs_torch" / "dataload").glob("*.py"))


@pytest.mark.parametrize("path", TRAIN_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_training_modules_never_call_the_scalar_crc(path):
    """The scalar CRC is a Python loop over every byte: checkpoint and
    data-loading modules checksum through crc32c_pieces (one K2 launch a
    batch) and never name crc32c or crc32c_py."""
    scalar = {"crc32c", "crc32c_py"}
    named = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.ImportFrom):
            named |= {a.name for a in node.names} & scalar
        elif isinstance(node, ast.Name) and node.id in scalar:
            named.add(node.id)
        elif isinstance(node, ast.Attribute) and node.attr in scalar:
            named.add(node.attr)
    assert not named, f"{path.name} names {sorted(named)}"


def test_import_ckpt_and_dataload_touches_no_cuda():
    code = ("import sys, torch, tpu3fs_torch.ckpt, tpu3fs_torch.dataload, "
            "tpu3fs_torch.utils.trash; "
            "print(torch.cuda.is_initialized(), 'triton' in sys.modules, "
            "tpu3fs_torch.kernels.library.cache_info().currsize)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["False", "False", "0"]
