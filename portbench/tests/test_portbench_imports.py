"""Nothing under portbench/ imports JAX or the JAX package (top-level
names compared whole: ``tpu3fs_torch`` is the program, ``tpu3fs`` is not),
reads the JAX benchmark's files, or lets the reference import the program."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu3fs"}
SOURCES = sorted(p for p in PKG.rglob("*.py") if "__pycache__" not in p.parts)


def _imported(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_the_scan_sees_every_source():
    assert len(SOURCES) > 20
    assert "tpu3fs_torch" in set().union(*map(_imported, SOURCES))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_or_jax_package(path):
    assert not (_imported(path) & FORBIDDEN)


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert _imported(path) <= {"__future__", "functools", "numpy", "torch"}


def test_no_code_names_the_jax_benchmark():
    """No source outside the tests names a file of the JAX benchmark, so
    none reads, imports or runs one."""
    for path in SOURCES:
        if "tests" not in path.relative_to(PKG).parts:
            text = path.read_text()
            for name in ("chip_smoke", "bench.py", "benchmarks", "BENCH_"):
                assert name not in text, (path, name)
