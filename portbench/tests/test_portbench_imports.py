"""What the benchmark's modules import: never JAX or the JAX package, and
the plain reference nothing of the program. Names are compared whole, by
the part before the first dot."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest

from _small import ROOT

from portbench import harness

BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "ibu_tpu"}


def _top_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _top_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not _top_imports(path) & (FORBIDDEN | {"ibu_tpu_torch", "torch", "portbench"})


@pytest.mark.parametrize("path", [p for p in SOURCES if p.resolve() != Path(__file__).resolve()],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_reads_the_jax_benchmarks(path):
    text = path.read_text()
    assert "benchmarks/" not in text and "bench.py" not in text


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ibu_tpu_torch_fake", object())
    assert "ibu_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ibu_tpu.fake", object())
    assert "ibu_tpu" in harness.forbidden_modules()
