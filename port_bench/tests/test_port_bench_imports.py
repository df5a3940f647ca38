"""A rehearsal run at the tiny preset on the CPU loads neither JAX, jaxlib,
flax nor the JAX package (top-level names compared whole), and the
reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

SCRIPT = """
import sys, time, torch
sys.path[:0] = [{bench!r}, {root!r}, {tests!r}]
from conftest import tiny
from harness import spec
import run
cell = tiny(spec.cell("amass_leg3_int8.b256", spec.benchmark()))
torch.set_num_threads(2)
out = spec.driver(cell["config"]).run_cell(cell, 2**31 + 77, 0.0, False, torch.device("cpu"), time.perf_counter())
assert out["correct"], out["checks"]
print("FORBIDDEN", run.forbidden_loaded())
print("ALL", sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_rehearsal_loads_no_jax():
    code = SCRIPT.format(bench=str(BENCH), root=str(BENCH.parent), tests=str(BENCH / "tests"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(BENCH.parent), "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    forbidden = [line for line in r.stdout.splitlines() if line.startswith("FORBIDDEN")]
    assert forbidden == ["FORBIDDEN []"]
    assert "rohm_tpu_torch" in r.stdout


def test_forbidden_names_compared_whole():
    import run

    saved = dict(sys.modules)
    try:
        sys.modules.pop("jax", None)
        sys.modules["rohm_tpu_torch_fake"] = sys
        assert "rohm_tpu" not in run.forbidden_loaded()
        sys.modules["rohm_tpu.pipeline"] = sys
        assert run.forbidden_loaded() == ["rohm_tpu"] or "rohm_tpu" in run.forbidden_loaded()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level else [])
            for n in names:
                assert n.split(".")[0] not in ("rohm_tpu", "rohm_tpu_torch", "jax", "jaxlib", "flax"), (path, n)
