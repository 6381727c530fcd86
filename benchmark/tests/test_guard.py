"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program (top-level names compared whole:
``densepose_tpu_torch`` begins with ``densepose_tpu``)."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "densepose_tpu"}
MODULES = sorted(HERE.rglob("*.py"))


def imported(path: Path):
    """Top-level names of every import in the module (relative ones as
    ``benchmark``)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("benchmark" if node.level else node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "densepose_tpu_torch" not in imported(path)
    assert imported(path) <= {"__future__", "math", "typing", "numpy", "torch", "benchmark"}


def test_names_compared_whole():
    assert "densepose_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "densepose_tpu.models".split(".")[0] in FORBIDDEN
