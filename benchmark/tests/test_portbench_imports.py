"""No module the benchmark runs imports JAX or the JAX package, and the
plain references import nothing of the program. Imports are compared by
their top-level name (the part before the first dot), whole: the port's
name begins with the JAX package's."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "octic_vits_tpu"}
PROGRAM = "octic_vits_tpu_torch"


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".", 1)[0])
            elif isinstance(arg, ast.JoinedStr):  # f"benchmark.<dir>.{name}"
                names.add(str(arg.values[0].value).split(".", 1)[0])
    return names


MODULES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)
REFERENCE = sorted((BENCH / "reference").glob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_in_any_module(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert PROGRAM not in names
    assert names <= {"__future__", "math", "re", "typing", "numpy", "torch", "benchmark"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith("benchmark"):
            assert node.module.startswith("benchmark.reference"), node.module


def test_forbidden_modules_compares_whole_top_level_names():
    assert harness.forbidden_modules([PROGRAM, f"{PROGRAM}.ops", "torch", "jaxtyping"]) == []
    assert harness.forbidden_modules(["jax.numpy", "octic_vits_tpu.models", "flax"]) == [
        "flax", "jax", "octic_vits_tpu"]
