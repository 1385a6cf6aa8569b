"""A configuration, traffic mix, driver, per-layer metric and kernel job
added as files only are found by name; the committed BENCHMARK.json
keeps to the contract's shape."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import allocator, spec

ROOT = spec.find_root()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _write(path: Path, text: str) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


@pytest.fixture
def added(tmp_path):
    """A checkout whose benchmark package holds one cell of new files."""
    pkg = tmp_path / "pb"
    _write(pkg / "configs" / "cfg-new.json", json.dumps({"width": 7}))
    _write(pkg / "traffic" / "mix-new.json",
           json.dumps({"driver": "drv_new", "reports": "rate_new"}))
    _write(pkg / "drivers" / "drv_new.py", "class Driver:\n    unit = 'op'\n")
    _write(pkg / "metrics" / "lat_new.x.py",
           "def read(rec):\n    return rec * 2\n")
    _write(pkg / "kernels" / "encode.fused.json",
           json.dumps({"job": "encode", "kernels": ["fused_kernel"]}))
    _write(pkg / "kernels" / "encode.json",
           json.dumps({"job": "encode", "kernels": ["gf2_mma_kernel"]}))
    _write(pkg / "peaks.json",
           json.dumps({"Card X": {"hbm_bytes_per_s": 1e12}}))
    bench = {
        "configs": [{"name": "cfg-new", "file": "pb/configs/cfg-new.json"}],
        "workloads": [{"name": "cell-new", "config": "cfg-new",
                       "traffic": "mix-new", "chips": 1, "why": "w"}],
        "end_to_end": [{"name": "rate_new", "unit": "GiB/s",
                        "workloads": ["cell-new"]},
                       {"name": "setup_s", "unit": "s"},
                       {"name": "other", "unit": "s",
                        "workloads": ["elsewhere"]}],
        "per_layer": [{"name": "lat_new.x", "unit": "ms",
                       "workloads": ["cell-new"]}],
    }
    _write(tmp_path / "BENCHMARK.json", json.dumps(bench))
    return tmp_path, pkg


def test_files_added_are_found_by_name(added):
    root, pkg = added
    assert spec.find_root(pkg / "metrics") == root
    cell = spec.load_cell("cell-new", root, pkg)
    assert cell.config == {"width": 7}
    assert cell.traffic["driver"] == "drv_new"
    assert [m["name"] for m in cell.end_to_end] == ["rate_new", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["lat_new.x"]
    assert spec.driver("drv_new", pkg).Driver.unit == "op"
    assert spec.metric_reader("lat_new.x", pkg)(21) == 42
    assert spec.kernel_jobs(pkg) == {"encode": ["fused_kernel",
                                                "gf2_mma_kernel"]}
    assert spec.peak("Card X 80GB", "hbm_bytes_per_s", pkg) == 1e12


def test_missing_names_raise(added):
    root, pkg = added
    with pytest.raises(spec.SpecError):
        spec.load_cell("no-such-cell", root, pkg)
    with pytest.raises(spec.SpecError):
        spec.metric_reader("no_such_metric", pkg)
    with pytest.raises(spec.SpecError):
        spec.peak("Card Y", "hbm_bytes_per_s", pkg)


def test_benchmark_json_keeps_the_contract():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert "portbench" in b["paths"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in b[k]}) == len(b[k])
    cells = {w["name"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file()
        assert all(NAME.match(r) for r in c["reduced"])
        stated = json.loads((ROOT / c["file"]).read_text())
        assert stated.get("reduced", c["reduced"]) == c["reduced"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json") \
            .is_file()
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert set(m["workloads"]) <= cells
    for w in cells:  # each cell reports setup_s, a rate and a layer
        assert sum(w in m.get("workloads", [w]) for m in b["end_to_end"]) >= 2
        assert any(w in m["workloads"] for m in b["per_layer"])


def test_allocator_settings_are_checked():
    allocator.check({"mmap_max": 0, "trim_threshold": allocator.INT_MAX,
                     "arena_max": 1})
    with pytest.raises(ValueError):
        allocator.check({"mmap_threshhold": 1})
    with pytest.raises(ValueError):
        allocator.check({"trim_threshold": 1 << 40})


def test_every_configuration_allocator_is_set_in_a_process():
    """Each configuration's settings, set in a process of their own: mallopt
    takes every one, and where no block is to be mapped afresh, a buffer of
    a whole call lies in the heap."""
    code = (
        "import ctypes, json, sys\n"
        "from portbench import allocator\n"
        "lines = allocator.apply(json.loads(sys.argv[1]))\n"
        "b = bytearray(48 << 20)\n"
        "at = ctypes.addressof((ctypes.c_char * len(b)).from_buffer(b))\n"
        "heap = [ln.split()[0] for ln in open('/proc/self/maps')\n"
        "        if ln.rstrip().endswith('[heap]')]\n"
        "lo, hi = (int(x, 16) for x in heap[0].split('-'))\n"
        "print(json.dumps([lines, lo <= at < hi]))\n")
    for path in sorted((spec.PKG / "configs").glob("*.json")):
        settings = json.loads(path.read_text()).get("allocator", {})
        out = subprocess.run([sys.executable, "-c", code,
                              json.dumps(settings)],
                             capture_output=True, text=True, check=True,
                             cwd=spec.PKG.parent)
        lines, in_heap = json.loads(out.stdout.strip().splitlines()[-1])
        assert len(lines) == len(settings), path.name
        assert in_heap == (settings.get("mmap_max") == 0), path.name
