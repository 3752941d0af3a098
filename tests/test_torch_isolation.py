"""The port stands alone: no module of ``xvr_tpu_torch``, not
``chip_smoke.py`` and not the port's chip scripts (``scripts/chip_*.py``)
imports JAX, the JAX package, ``click`` or ``msgpack``, and importing the
port leaves them unloaded. At module level they import only the standard
library and what the card's machine has: numpy, scipy, torch, einops,
triton and the port itself (an import in a function, or in a ``try`` that
catches ImportError, is the caller's to guard)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "xvr_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", *sorted((REPO / "scripts").glob("chip_*.py"))]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "xvr_tpu", "click", "msgpack")
ALLOWED_AT_MODULE_LEVEL = set(sys.stdlib_module_names) | {
    "numpy", "scipy", "torch", "einops", "triton", "xvr_tpu_torch"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


class _ModuleLevelImports(ast.NodeVisitor):
    """Absolute import roots a module runs when it is imported: function
    bodies and ``try`` blocks that catch ImportError are skipped."""

    def __init__(self):
        self.roots = set()

    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Try(self, node):
        caught = {getattr(h.type, "id", None) for h in node.handlers}
        if caught & {"ImportError", "ModuleNotFoundError"}:
            for stmt in node.handlers + node.orelse + node.finalbody:
                self.visit(stmt)
        else:
            self.generic_visit(node)

    def visit_Import(self, node):
        self.roots |= {a.name.split(".")[0] for a in node.names}

    def visit_ImportFrom(self, node):
        if node.level == 0 and node.module:
            self.roots.add(node.module.split(".")[0])


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_module_imports_no_jax(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_module_level_imports_are_allowed(path):
    visitor = _ModuleLevelImports()
    visitor.visit(ast.parse(path.read_text(), filename=str(path)))
    bad = visitor.roots - ALLOWED_AT_MODULE_LEVEL
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)} when it is imported"


def test_module_level_allow_list_catches_imports():
    tree = ast.parse(
        "import os\nimport click\nfrom msgpack import packb\n"
        "try:\n    import ants\nexcept ImportError:\n    ants = None\n"
        "def f():\n    import yaml\n"
        "class C:\n    import flax\n"
    )
    visitor = _ModuleLevelImports()
    visitor.visit(tree)
    assert visitor.roots - ALLOWED_AT_MODULE_LEVEL == {"click", "msgpack", "flax"}


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, xvr_tpu_torch, xvr_tpu_torch.registrar, xvr_tpu_torch.render, "
        "xvr_tpu_torch.render.pallas, xvr_tpu_torch.models, xvr_tpu_torch.train, "
        "xvr_tpu_torch.cli, xvr_tpu_torch.config, xvr_tpu_torch.io.msgpack, "
        "xvr_tpu_torch.io, xvr_tpu_torch.metrics, xvr_tpu_torch.utils, xvr_tpu_torch.state, "
        "xvr_tpu_torch.parallel, xvr_tpu_torch.visualization, xvr_tpu_torch.io.dcm2nii; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
