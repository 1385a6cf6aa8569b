"""Whole runs of the harness on the CPU at a tiny size (the card check
skipped): the result line, the traced line, the refusals, and the
comparison failing for the control and for every fault a cell can have.
The test ``test_controls_on_the_card`` runs the controls on a card."""

import json
import random
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness, spec, trace
from portbench.tests.cells import load_cell, tiny_cell

read_driver = spec.driver("file_read")

CPU = torch.device("cpu")


@pytest.fixture
def card():
    """The card, decided when the test runs; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)
CELLS = ("ec-write", "ec-degraded-read")
CONTROLS = {"ec-write": "rs12_3", "ec-degraded-read": "no_decode"}


def _run(name, *, control=None, trace_on=False, seconds=0.6, seed=2**31 + 3):
    return harness.run_cell(tiny_cell(name), seed, seconds, trace_on, CPU,
                            control=control, log=lambda s: None)


@pytest.mark.parametrize("name", CELLS)
def test_result_line(name):
    result, checks = _run(name)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    cell = load_cell(name)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert set(result["checks"]) == {c.name for c in checks}
    json.dumps(result)


class _FakeTrace:
    """The card's events, made up: one kernel of every job a call."""

    def __init__(self, device):
        self.t0 = None

    def start(self):
        import time

        self.t0 = time.perf_counter_ns()

    def stop(self):
        import time

        t1 = time.perf_counter_ns()
        step = (t1 - self.t0) // 10
        names = ["gf2_mma_kernel", "crc32c_mma_kernel", "xor_reduce_kernel",
                 "Memcpy HtoD (Pageable -> Device)"]
        return [(names[i % 4], self.t0 + i * step, self.t0 + i * step + step
                 // 2) for i in range(10)]


@pytest.mark.parametrize("name", CELLS)
def test_traced_line(monkeypatch, name):
    monkeypatch.setattr(trace, "DeviceTrace", _FakeTrace)
    monkeypatch.setattr(spec, "peak", lambda *a, **k: 3.35e12)
    cell = tiny_cell(name)
    result, _ = harness.run_cell(cell, 7, 0.6, True, CPU, log=lambda s: None)
    assert result["correct"] is True
    assert result["device"]["busy_s"] > 0
    assert result["device"]["window_s"] > 0
    want = {m["name"] for m in cell.per_layer}
    assert set(result["metrics"]) <= want
    # rooflines need the card's peak; every other layer reads on the CPU
    assert want - set(result["metrics"]) <= {
        "encode_roofline.write", "crc_roofline.write",
        "decode_roofline.degraded"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert 1 <= len(result["breakdown"]["device_ops"]) <= 10
    assert list(result)[-1] == "checks"


def test_a_new_end_to_end_metric_is_picked_up(tmp_path, monkeypatch):
    """An end-to-end metric is a file under metrics/ and an entry: the
    harness reads it with no edit."""
    pkg = tmp_path / "pb"
    shutil.copytree(spec.PKG, pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (pkg / "metrics" / "calls_per_s.py").write_text(
        "def read(rec):\n"
        "    return len(rec.done()) / ((rec.t1 - rec.t0) / 1e9)\n")
    monkeypatch.setattr(spec, "PKG", pkg)
    cell = tiny_cell("ec-degraded-read")
    cell.end_to_end = cell.end_to_end + [{"name": "calls_per_s",
                                          "unit": "1/s"}]
    result, _ = harness.run_cell(cell, 5, 0.4, False, CPU,
                                 log=lambda s: None)
    assert result["correct"] is True
    assert result["metrics"]["calls_per_s"]["value"] > 0
    assert set(result["metrics"]) == {"read_gibps", "setup_s",
                                      "calls_per_s"}


def test_the_write_sample_spans_the_window():
    """The files that check_files names stay to the end and the sample
    takes calls from each of them and from those live at the end; every
    other older file is removed."""
    lines = []
    cell = tiny_cell("ec-write")
    stripe = cell.config["chunk_size"]
    cell.traffic.update(call_bytes=stripe, file_bytes=stripe,  # a call a file
                        writers=1)
    result, checks = harness.run_cell(cell, 9, 6.0, False, CPU,
                                      log=lines.append)
    assert result["correct"] is True
    said = [s for s in lines if s.startswith("# check: calls")][0]
    files = [int(x) for x in re.findall(r"of file (\d+)", said)]
    assert {2, 4} <= set(files) and max(files) > 5 and len(files) <= 4, said
    assert not {1, 3} & set(files), said  # removed once a newer one closed
    assert all(int(n) > 0 for n in re.findall(r"(\d+) of file", said))


def test_the_read_sample_draws_from_every_call():
    draw = random.Random(3)
    kept = []
    for i in range(1000):
        read_driver.offer(kept, 8, i, i, draw)
    assert len(kept) == 8 and len(set(kept)) == 8
    assert max(kept) > 500 and sum(k >= 8 for k in kept) >= 6


def test_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", "ec-degraded-read", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc == 2 and "{" not in out and "CUDA" in err


def test_refuses_in_a_copy_without_the_program(tmp_path):
    root = spec.find_root()
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(root / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", "ec-degraded-read",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


def test_refuses_with_jax_loaded(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    with pytest.raises(harness.ForbiddenModules):
        _run("ec-degraded-read")


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference in the program's place, a guarantee broken (or the
    pages in the next lower precision), fails the comparison."""
    result, checks = _run(name, control=CONTROLS[name])
    assert result["correct"] is False
    assert any(not c.ok for c in checks)


# -- faults planted under the timed path -------------------------------------

def _unchanged_write(self, inode, offset, data):
    return len(memoryview(data).cast("B"))  # acknowledged, nothing stored


def _half_write(orig):
    def write(self, inode, offset, data):
        mv = memoryview(data).cast("B")
        orig(self, inode, offset, mv[:len(mv) // 2])
        return len(mv)
    return write


def _altered_install(orig):
    def own(self, data):
        out = orig(self, data)
        arr = np.frombuffer(out, dtype=np.uint8).copy()
        if arr.size:
            arr[arr.size // 2] ^= 0x5A
        return arr.tobytes()
    return own


def _unchanged_read(self, inode, offset, size):
    return bytes(size)


def _half_read(orig):
    def read(self, inode, offset, size):
        return orig(self, inode, offset, size)[: size // 2]
    return read


def _altered_decode(orig):
    def reconstruct(self, present_idx, lost_idx, present):
        out = orig(self, present_idx, lost_idx, present)
        out = out.copy() if isinstance(out, np.ndarray) else out.clone()
        out[..., 0] ^= 1
        return out
    return reconstruct


def _plant(monkeypatch, fault):
    from tpu3fs_torch.client.file_io import FileIoClient
    from tpu3fs_torch.ops.stripe import StripeCodec
    from tpu3fs_torch.storage.engine import MemChunkEngine

    if fault == "write-unchanged":
        monkeypatch.setattr(FileIoClient, "write", _unchanged_write)
    elif fault == "write-half":
        monkeypatch.setattr(FileIoClient, "write",
                            _half_write(FileIoClient.write))
    elif fault == "write-altered":
        monkeypatch.setattr(MemChunkEngine, "_own_content",
                            _altered_install(MemChunkEngine._own_content))
    elif fault == "read-unchanged":
        monkeypatch.setattr(FileIoClient, "read", _unchanged_read)
    elif fault == "read-half":
        monkeypatch.setattr(FileIoClient, "read",
                            _half_read(FileIoClient.read))
    elif fault == "read-altered":
        monkeypatch.setattr(StripeCodec, "reconstruct_batch",
                            _altered_decode(StripeCodec.reconstruct_batch))


@pytest.mark.parametrize("name, fault", [
    ("ec-write", "write-unchanged"), ("ec-write", "write-half"),
    ("ec-write", "write-altered"),
    ("ec-degraded-read", "read-unchanged"), ("ec-degraded-read", "read-half"),
    ("ec-degraded-read", "read-altered"),
])
def test_fault_is_not_correct(monkeypatch, name, fault):
    """A state left unchanged, half of a batch left out, an answer altered
    where it is produced: each run comes out not correct (one chip: no
    exchange between chips to leave out)."""
    _plant(monkeypatch, fault)
    result, checks = _run(name)
    assert result["correct"] is False, result["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_controls_on_the_card(card, name):
    """The card's run of the tiny cell is correct, its control is not."""
    cell = tiny_cell(name)
    ok, _ = harness.run_cell(cell, 11, 1.0, False, card, log=lambda s: None)
    bad, _ = harness.run_cell(cell, 11, 1.0, False, card,
                              control=CONTROLS[name], log=lambda s: None)
    assert ok["correct"] is True and bad["correct"] is False
