"""The port stands alone: no module of ``xvr_tpu_torch``, not
``chip_smoke.py`` and not the port's chip scripts (``scripts/chip_*.py``)
imports JAX or the JAX package, and importing the port leaves JAX
unloaded."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "xvr_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "scripts" / "chip_mtre_spread.py",
    REPO / "scripts" / "chip_slab_times.py", REPO / "scripts" / "chip_warp_times.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "xvr_tpu")


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


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_module_imports_no_jax(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, xvr_tpu_torch, xvr_tpu_torch.registrar, xvr_tpu_torch.render, "
        "xvr_tpu_torch.render.pallas, "
        "xvr_tpu_torch.io, xvr_tpu_torch.metrics, xvr_tpu_torch.utils, xvr_tpu_torch.state; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
