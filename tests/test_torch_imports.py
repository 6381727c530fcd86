"""The PyTorch port stands alone: no file of ``densepose_tpu_torch/``, not
``chip_smoke.py`` and not the test inputs it shares (``tests/torch_cases.py``)
imports ``jax`` or anything of ``densepose_tpu``, and
``yaml``/``cv2`` (absent on the GPU machine) are imported only inside
functions, off the flagship path."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "densepose_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_cases.py"]  # chip_smoke.py imports the latter


def _imports(tree):
    """(module name, is_module_level) of every absolute import. An import
    runs when the module is imported unless a function body holds it, so one
    under a module-level ``try``, ``if``, ``with`` or class body counts as
    module level (the JAX visualizer's ``try: import cv2`` would)."""
    def walk(node, in_function):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                for alias in child.names:
                    yield alias.name, not in_function
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module, not in_function
            yield from walk(child, in_function or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)))
    yield from walk(tree, False)


def test_nested_module_level_imports_count():
    """A guarded import at module level is a module-level import; one in a
    function body is not."""
    src = ("try:\n    import cv2\nexcept ImportError:\n    cv2 = None\n"
           "if True:\n    import yaml\n"
           "class C:\n    import cv2 as c2\n"
           "def f():\n    try:\n        import yaml\n    except ImportError:\n        pass\n")
    assert list(_imports(ast.parse(src))) == [("cv2", True), ("yaml", True), ("cv2", True),
                                              ("yaml", False)]
    jax_visualizer = ast.parse((ROOT / "densepose_tpu" / "visualizer.py").read_text())
    assert ("cv2", True) in set(_imports(jax_visualizer))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports(path):
    for name, module_level in _imports(ast.parse(path.read_text())):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "densepose_tpu"), f"{path.name} imports {name}"
        if root in ("yaml", "cv2"):
            assert not module_level, f"{path.name} imports {name} at module level"


def test_port_files_found():
    assert len(FILES) > 15 and (ROOT / "chip_smoke.py").exists()
