"""The PyTorch port stands alone: no file of `rohm_tpu_torch/`, and not
`chip_smoke.py`, imports jax, flax, optax, orbax or the JAX package
`rohm_tpu` (an AST scan, so a lazy import inside a function counts too),
nor cv2 or pandas, which the machine with the card does not have."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "rohm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "rohm_tpu", "cv2", "pandas")


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def _forbidden(module: str) -> bool:
    # "rohm_tpu" and "rohm_tpu.x" are the JAX package; "rohm_tpu_torch" is not
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [f"{path.name}:{line} imports {mod}" for line, mod in _imported_modules(tree) if _forbidden(mod)]
    assert not bad, bad


def test_scan_catches_forbidden_imports():
    src = ("import jax.numpy as jnp\nfrom rohm_tpu.ops import x\nfrom rohm_tpu_torch import y\nimport flax\n"
           "import optax\nimport orbax.checkpoint as ocp\nimport optree\nimport cv2\nfrom pandas import read_csv\n")
    mods = [m for _, m in _imported_modules(ast.parse(src))]
    assert [m for m in mods if _forbidden(m)] == ["jax.numpy", "rohm_tpu.ops", "flax", "optax", "orbax.checkpoint",
                                                  "cv2", "pandas"]
