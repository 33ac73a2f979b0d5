"""The port imports neither jax nor the JAX package: the card's machine
has no jax, and importing any ``raweditor_tpu`` module imports jax."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "raweditor_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "raweditor_tpu")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    src = path.read_text()
    bad = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0 and _forbidden(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            bad.append(node.args[0].value)
    assert not bad, f"{path.name} imports {bad}"
    for line in src.splitlines():
        s = line.strip()
        assert not s.startswith(("import jax", "from jax")), line


def test_guard_catches_violations(tmp_path):
    for src in ("import jax.numpy as jnp\n",
                "from raweditor_tpu.ops import develop\n",
                "def f():\n    import raweditor_tpu\n"):
        tree = ast.parse(src)
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names] + [n.module for n in ast.walk(tree)
                                      if isinstance(n, ast.ImportFrom)]
        assert any(_forbidden(n) for n in names), src
    assert not _forbidden("raweditor_tpu_torch.ops")
