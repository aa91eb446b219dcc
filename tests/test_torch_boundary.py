"""The port's import boundary: no module of `repro_torch` and no line of
`chip_smoke.py` imports JAX or the JAX package `repro` (only `repro_torch`),
so the port runs on a machine that has PyTorch and nothing of JAX."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(tree):
    """Top-level package of every absolute import in the module."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr",
                                                     getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_module_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [f"{path.name}:{line} imports {top}"
           for line, top in _imported(tree) if top in FORBIDDEN]
    assert not bad, bad


def test_boundary_check_catches_forbidden_imports():
    for src in ("import jax", "import jax.numpy as jnp", "from repro import x",
                "from repro.core import drs", "import repro.models",
                "importlib.import_module('jax')"):
        assert any(top in FORBIDDEN for _, top in _imported(ast.parse(src))), src
    for src in ("import repro_torch", "from repro_torch.core import drs",
                "from . import ops", "import torch"):
        assert not any(top in FORBIDDEN
                       for _, top in _imported(ast.parse(src))), src


def test_port_tree_is_covered():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "ops.py", "scheduler.py", "bridge.py"} <= names
