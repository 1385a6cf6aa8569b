"""Finds what a run needs by the names in BENCHMARK.json.

Everything that belongs to one configuration, traffic mix, driver, per-layer
metric or kernel job sits in files of its own under this package, found by
name, so a new cell, metric or kernel name is a new file and no edit:

- ``configs/<config>.json``: the deployment (the file BENCHMARK.json names)
- ``traffic/<traffic>.json``: the mix's parameters; its ``driver`` names
  ``drivers/<driver>.py``
- ``metrics/<metric>.py``: ``read(rec)`` -> a number, or None when the run
  holds nothing to read; end-to-end and per-layer metrics alike
- ``kernels/*.json``: ``{"job": ..., "kernels": [...]}``, kernel names (as
  substrings of the profiler's names) that do one job; several files may
  name the same job
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

PKG = Path(__file__).resolve().parent


class SpecError(RuntimeError):
    """BENCHMARK.json or a file it leads to is missing or malformed."""


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list = field(default_factory=list)   # metric entries
    per_layer: list = field(default_factory=list)    # metric entries


def _load_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SpecError(f"{path} not found")
    except json.JSONDecodeError as e:
        raise SpecError(f"{path}: {e}")


def find_root(start: Path = PKG) -> Path:
    """The checkout: the nearest directory above the package that holds
    BENCHMARK.json."""
    for d in [start, *start.parents]:
        if (d / "BENCHMARK.json").is_file():
            return d
    raise SpecError("no BENCHMARK.json above the benchmark's package")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path, pkg: Optional[Path] = None) -> Cell:
    pkg = pkg or PKG
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench.get("workloads", [])}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                        f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench.get("configs", [])}
    if w["config"] not in configs:
        raise SpecError(f"workload {name} names config {w['config']!r}, "
                        "which BENCHMARK.json does not list")
    config = _load_json(root / configs[w["config"]]["file"])
    traffic = _load_json(pkg / "traffic" / f"{w['traffic']}.json")
    return Cell(
        name=name, config=config, traffic=traffic, chips=int(w["chips"]),
        end_to_end=[m for m in bench.get("end_to_end", [])
                    if _applies(m, name)],
        per_layer=[m for m in bench.get("per_layer", [])
                   if _applies(m, name)])


def _load_module(path: Path, qualname: str):
    if not path.is_file():
        raise SpecError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(qualname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, pkg: Optional[Path] = None):
    """The driver module ``drivers/<name>.py``."""
    pkg = pkg or PKG
    return _load_module(pkg / "drivers" / f"{name}.py",
                        f"portbench_driver_{name}")


def metric_reader(name: str, pkg: Optional[Path] = None):
    """``read(rec)`` of ``metrics/<name>.py``."""
    pkg = pkg or PKG
    mod = _load_module(pkg / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))
    if not callable(getattr(mod, "read", None)):
        raise SpecError(f"metrics/{name}.py has no read(rec)")
    return mod.read


def kernel_jobs(pkg: Optional[Path] = None) -> dict:
    """job -> kernel names, merged over every file in ``kernels/``."""
    pkg = pkg or PKG
    jobs: dict = {}
    for path in sorted((pkg / "kernels").glob("*.json")):
        d = _load_json(path)
        jobs.setdefault(d["job"], [])
        jobs[d["job"]] += [k for k in d["kernels"] if k not in jobs[d["job"]]]
    return jobs


def peak(device_name: str, key: str, pkg: Optional[Path] = None) -> float:
    """A published peak of the card whose name starts with an entry of
    ``peaks.json``; raises for a card the table does not know."""
    pkg = pkg or PKG
    table = _load_json(pkg / "peaks.json")
    for prefix, entry in table.items():
        if device_name.startswith(prefix):
            return float(entry[key])
    raise SpecError(f"no peaks for {device_name!r} in peaks.json")
