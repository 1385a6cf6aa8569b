"""Rules the port keeps: tpu3fs_torch and chip_smoke.py import neither jax
nor tpu3fs (the USRBIO rings of ``tpu3fs_torch/usrbio/`` keep their own
copy, semaphores included); importing the package (its transport, rings,
service layer, apps and binaries included) touches no CUDA and no triton,
and the ring-hosting apps default to the card and raise without one; the
kvd and the
collector boot without a CUDA context; entry points default to the card
and raise without one; the kernel build directory is git-ignored, and
processes that load the library at once on a fresh tree run nvcc once."""

import ast
import os
import pathlib
import subprocess
import sys
import time

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


def test_import_transport_apps_and_binaries_touches_no_cuda():
    code = ("import sys, torch, tpu3fs_torch.rpc.net, "
            "tpu3fs_torch.rpc.services, tpu3fs_torch.app, "
            "tpu3fs_torch.bin.mgmtd_main, tpu3fs_torch.bin.storage_main, "
            "tpu3fs_torch.bin.meta_main, tpu3fs_torch.client.stubs, "
            "tpu3fs_torch.monitor.collector, tpu3fs_torch.core, "
            "tpu3fs_torch.metashard, tpu3fs_torch.bin.fuse_main, "
            "tpu3fs_torch.bin.migration_main, tpu3fs_torch.bin.ckpt_gc_main, "
            "tpu3fs_torch.bin.dataload_pack_main, "
            "tpu3fs_torch.bin.kvcache_gc_main, tpu3fs_torch.cli, "
            "tpu3fs_torch.fuse, tpu3fs_torch.fuse.mount, "
            "tpu3fs_torch.migration, tpu3fs_torch.hostbuild; "
            "print(torch.cuda.is_initialized(), 'triton' in sys.modules, "
            "tpu3fs_torch.kernels.library.cache_info().currsize)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["False", "False", "0"]


def test_import_service_layer_touches_no_cuda():
    """The rest of the service layer (the kvd and its group, the sharded
    metadata plane, the collector, the serving socket half and every
    binary) imports without touching CUDA or triton."""
    code = ("import sys, torch, tpu3fs_torch.kv, tpu3fs_torch.kv.service, "
            "tpu3fs_torch.kv.replica, tpu3fs_torch.kv.remote, "
            "tpu3fs_torch.metashard, tpu3fs_torch.metashard.store, "
            "tpu3fs_torch.meta.distributor, tpu3fs_torch.monitor, "
            "tpu3fs_torch.monitor.agg, tpu3fs_torch.monitor.slo, "
            "tpu3fs_torch.monitor.collector, tpu3fs_torch.serving, "
            "tpu3fs_torch.serving.service, tpu3fs_torch.client.inmem, "
            "tpu3fs_torch.bin.kv_main, tpu3fs_torch.bin.monitor_main, "
            "tpu3fs_torch.bin.serving_main, tpu3fs_torch.bin.mgmtd_main, "
            "tpu3fs_torch.bin.meta_main, tpu3fs_torch.bin.storage_main; "
            "print(torch.cuda.is_initialized(), 'triton' in sys.modules, "
            "tpu3fs_torch.kernels.library.cache_info().currsize)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["False", "False", "0"]


_BOOT_KVD_AND_COLLECTOR = r"""
import sys, torch
from tpu3fs_torch.bin.kv_main import KvApp
from tpu3fs_torch.bin.monitor_main import MonitorApp
out = sys.argv[1]
apps = [KvApp(["--device", "cpu"]),
        MonitorApp(["--device", "cpu", f"--config.out_path={out}"])]
for app in apps:
    app.run_background()
booted = [app.info.port > 0 for app in apps]
for app in apps:
    app.stop()
print(all(booted), all(app.join(10.0) for app in apps),
      torch.cuda.is_initialized())
"""


def test_kvd_and_collector_boot_without_cuda(tmp_path):
    """``KvApp`` and ``MonitorApp`` do no device work: after construction
    and boot their process holds no CUDA context."""
    out = subprocess.run(
        [sys.executable, "-c", _BOOT_KVD_AND_COLLECTOR,
         str(tmp_path / "samples.jsonl")], cwd=ROOT, check=True,
        capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["True", "True", "False"]


# one child: waits for the parent's go, then loads the library from a
# fake build tree (one source) through a stub nvcc, the loader stubbed
_LOAD_CHILD = r"""
import sys, time
from pathlib import Path
from tpu3fs_torch import kernels
tmp = Path(sys.argv[1])
kernels.BUILD_DIR = tmp / "build"
kernels.SRC_DIR = tmp / "src"
class Lib:
    def __getattr__(self, name):
        return type("Fn", (), {})()
kernels.ctypes.CDLL = lambda path: Lib()
(tmp / f"ready-{sys.argv[2]}").touch()
while not (tmp / "go").exists():
    time.sleep(0.01)
kernels.library()
print("loaded")
"""

# a stub nvcc: count the call, take a while, write its -o output
_STUB_NVCC = """#!/bin/sh
echo "$*" >> "{count}"
sleep 1
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; : > "$1"; fi
  shift
done
"""


def test_kernel_build_runs_nvcc_once_across_processes(tmp_path):
    """Two processes load the library at once on a fresh tree: the build's
    file lock lets one run nvcc (one compile and one link) and the other
    waits and loads the result."""
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "a.cu").write_text("// one source\n")
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    count = tmp_path / "nvcc-calls"
    nvcc.write_text(_STUB_NVCC.format(count=count))
    nvcc.chmod(0o755)
    env = {**os.environ, "CUDA_HOME": str(tmp_path / "cuda")}
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD_CHILD,
                               str(tmp_path), str(i)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(2)]
    try:
        deadline = time.monotonic() + 60
        while not all((tmp_path / f"ready-{i}").exists() for i in range(2)):
            assert time.monotonic() < deadline, "children did not start"
            assert all(p.poll() is None for p in procs)
            time.sleep(0.02)
        (tmp_path / "go").touch()
        outs = [p.communicate(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    assert [p.returncode for p in procs] == [0, 0], outs
    assert all(o.strip() == "loaded" for o, _ in outs)
    calls = count.read_text().splitlines()
    assert len(calls) == 2, calls  # one compile of a.cu and one link
    assert sum("-shared" in c for c in calls) == 1


USRBIO_MODULES = ("__init__", "sem", "ring", "transport", "server", "agent",
                  "api")


@pytest.mark.parametrize("name", USRBIO_MODULES)
def test_usrbio_module_is_the_ports_own(name):
    """Each USRBIO module is the port's own file, scanned by the import
    rule above, and none loads a module of the JAX package at run time."""
    path = ROOT / "tpu3fs_torch" / "usrbio" / f"{name}.py"
    assert path in PORT_FILES
    text = path.read_text()
    assert "importlib" not in text and "__import__" not in text


def test_import_usrbio_touches_no_cuda_and_loads_no_jax_package():
    code = ("import sys, torch, tpu3fs_torch.usrbio, "
            "tpu3fs_torch.usrbio.sem, tpu3fs_torch.usrbio.agent, "
            "tpu3fs_torch.usrbio.api, tpu3fs_torch.usrbio.server; "
            "print(torch.cuda.is_initialized(), 'triton' in sys.modules, "
            "any(m == 'jax' or m == 'tpu3fs' or m.startswith(('jax.', "
            "'tpu3fs.')) for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["False", "False", "False"]


@pytest.mark.parametrize("module,cls", [
    ("tpu3fs_torch.bin.storage_main", "StorageApp"),
    ("tpu3fs_torch.bin.serving_main", "ServingApp")],
    ids=["storage", "serving"])
def test_ring_hosting_apps_default_to_the_card(module, cls):
    """The apps that host rings by default resolve their device to the
    card unless asked otherwise, and raise without one."""
    import importlib

    app_cls = getattr(importlib.import_module(module), cls)
    app = app_cls([], device="cpu")
    assert int(app.config.get("usrbio")) == 1 and app.device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        app_cls([])



@pytest.mark.parametrize("module,cls", [
    ("tpu3fs_torch.bin.fuse_main", "FuseApp"),
    ("tpu3fs_torch.bin.migration_main", "MigrationApp")],
    ids=["fuse", "migration"])
def test_operator_apps_default_to_the_card(module, cls):
    """The FUSE daemon and the migration worker resolve their device to
    the card unless asked otherwise (keyword or ``--device``), and raise
    without one."""
    import importlib

    app_cls = getattr(importlib.import_module(module), cls)
    assert app_cls([], device="cpu").device.type == "cpu"
    assert app_cls(["--device", "cpu"]).device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        app_cls([])


@pytest.mark.parametrize("module", ["ckpt_gc_main", "dataload_pack_main",
                                    "kvcache_gc_main"])
def test_operator_tools_take_a_device_defaulting_to_the_card(module):
    """Every tool parses ``--device`` (default: none given, so the card)
    and hands it to ``RpcFabricView``."""
    import importlib
    import inspect

    mod = importlib.import_module(f"tpu3fs_torch.bin.{module}")
    extra = ["--out", "/x"] if module == "dataload_pack_main" else []
    assert mod.parse_args(extra).device is None
    assert mod.parse_args(extra + ["--device", "cpu"]).device == "cpu"
    assert "device=args.device" in inspect.getsource(mod.main)