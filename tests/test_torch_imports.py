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
    """(module name, is_module_level) of every absolute import."""
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, id(node) in top


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports(path):
    for name, module_level in _imports(ast.parse(path.read_text())):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "densepose_tpu"), f"{path.name} imports {name}"
        if root in ("yaml", "cv2"):
            assert not module_level, f"{path.name} imports {name} at module level"


def test_port_files_found():
    assert len(FILES) > 15 and (ROOT / "chip_smoke.py").exists()
