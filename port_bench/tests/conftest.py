"""The benchmark's own tests: CPU tests at a tiny preset, and tests marked
`cuda` that run at the cells' own sizes on the card (skipped without one).

Run from the repo root: python -m pytest port_bench/tests -q
"""

import copy
import sys
from pathlib import Path

import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

from harness import spec  # noqa: E402


def tiny(cell: dict) -> dict:
    """The cell at a size the CPU runs in seconds: the same code paths,
    widths and steps cut (never used for a measurement)."""
    cell = copy.deepcopy(cell)
    cfg = cell["config"]
    cfg["trajnet"]["mid_dim"] = 64
    cfg["posenet"]["latent_dim"] = 64
    cfg["clip_len"] = 17
    cfg["diffusion_steps_trajnet"] = 5
    cfg["diffusion_steps_posenet"] = 60
    cfg["body"]["num_verts"] = 512
    cell["traffic"].update(batch_size=2, pool_batches=2, warmup_traj_steps=2, warmup_pose_steps=3)
    return cell


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: runs at the cell's own size on the card")
    return torch.device("cuda", 0)
