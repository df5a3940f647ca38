"""The port's PROX/EgoBody path against the benchmark's plain reference, on
the CPU at the benchmark's tiny preset with seeded random weights:
`RohmPipeline.run_batch` with the 'prox' guidance (2-D reprojection and
skating at t <= 100), early stop (the PoseNet chains stop at t = 20), the
data's per-window visibility masks and iteration 2 conditioned on
iteration 1's outputs, followed at every step of its four chains
(port_bench/drivers/prox.py's StepObserver), and each step's x_{t-1}
recomputed by port_bench/reference/prox.py from the program's x_t.

The preset's PoseNet schedule has 105 steps, so each PoseNet chain runs 85:
81 guided (t = 100..20) and 4 unguided (t = 104..101). The batch holds two
windows of two recordings, each with its own camera."""

import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

BENCH = Path(__file__).resolve().parents[1] / "port_bench"
SEED = 2**31 + 2727
CPU = torch.device("cpu")
# the step gap's limit: the f32 program on the CPU against the reference in
# f32 reads at most 1.4e-7 over every step (a few f32 roundings of the
# state); the reference with TF32 products (10-bit mantissas) reads 2.3e-5
# and 2.7e-5 at its worst steps of the two PoseNet chains, 1.6e-4 of the
# TrajNet ones
STEP_TOL = 1e-6


def prox_tiny():
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from harness import spec

    tiny = spec.load_module(BENCH / "tests" / "conftest.py").tiny
    cell = tiny(spec.cell("prox_rgb_f32.v128", spec.benchmark()))
    cell["config"]["diffusion_steps_posenet"] = 105
    cell["traffic"].update(recordings_per_batch=2, windows_per_recording=1, warmup_pose_steps=23)
    return cell, spec.driver(cell["config"])


@pytest.fixture(scope="module")
def followed():
    """The cell, its driver, inputs and program, and one batch followed at
    every step: [(index, generator seed, seconds, records, plan, links,
    (pose, traj))] as drivers/prox.py's window gives it."""
    cell, drv = prox_tiny()
    cfg = cell["config"]
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        body, stats, batches = drv.make_inputs(cfg, cell["traffic"], SEED, CPU)
        prog = drv.Program(cfg, body, stats["mean"], stats["std"], SEED, CPU)
        plan = {c: set(range(cfg["early_stop_steps"], cfg["diffusion_steps_posenet"]) if c % 2
                       else range(cfg["diffusion_steps_trajnet"])) for c in range(2 * cfg["sample_iter"])}
        with drv.StepObserver() as obs:
            records, links = obs.arm(plan)
            pose, traj = prog.run_batch(batches[0], torch.Generator().manual_seed(SEED))
            obs.disarm()
        yield cell, drv, (body, stats, batches, prog), [(0, SEED, 0.0, records, plan, links, (pose, traj))]
    finally:
        torch.set_num_threads(n)


def checks(followed):
    cell, drv, (body, stats, batches, prog), done = followed
    return drv.run_checks(cell["config"], body, stats, batches, done, SEED, CPU, prog.layouts)


def test_the_batch_carries_a_camera_per_row(followed):
    _, _, (_, _, batches, _), _ = followed
    b = batches[0]
    assert b["cam_r"].shape == (2, 3, 3) and b["cam_t"].shape == (2, 3)
    assert not torch.equal(b["cam_r"][0], b["cam_r"][1])
    assert b["pose_mask"].shape == (2, 15, 294) and 0 < float(b["pose_mask"].mean()) < 1


def test_chains_stop_early_and_return_the_last_pred_x0(followed):
    """The PoseNet chains run t = 104..20 (the last step guided, its pred_x0
    kept), the TrajNet chains t = 4..0; run_batch returns the last PoseNet
    chain's pred_x0 at t = 20 and the last TrajNet chain's x_{-1}."""
    _, _, _, done = followed
    records, (pose, traj) = done[0][3], done[0][6]
    for c in range(4):
        steps = sorted(t for cc, t in records if cc == c)
        assert steps == (list(range(20, 105)) if c % 2 else list(range(0, 5))), c
        if c % 2:
            guided = sorted(t for cc, t in records if cc == c and records[(cc, t)][2] is not None)
            assert guided == list(range(20, 101)), c
    assert torch.equal(pose, records[(3, 20)][2])
    assert torch.equal(traj, records[(2, 0)][1])


def test_every_step_matches_the_reference(followed):
    """Start and links exact; every step's x_{t-1}, guided and unguided,
    within STEP_TOL of the reference's from the program's x_t."""
    _, _, _, done = followed
    gaps = checks(followed)
    assert gaps["start"] == 0.0 and gaps["link"] == 0.0
    records = done[0][3]
    keys = sorted(records)
    step = gaps["step"].view(len(keys), -1)  # per recorded step, per row
    guided = [i for i, k in enumerate(keys) if records[k][2] is not None]
    unguided = [i for i, k in enumerate(keys) if k[0] % 2 and records[k][2] is None]
    assert len(guided) == 2 * 81 and len(unguided) == 2 * 4
    assert float(step[guided].max()) < STEP_TOL
    assert float(step[unguided].max()) < STEP_TOL
    assert float(step.max()) < STEP_TOL


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10-bit mantissa (round to nearest)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def test_tf32_products_fail_the_check(followed, monkeypatch):
    """The reference with every linear product's operands rounded to TF32,
    as the card's control computes them: the step gap goes past STEP_TOL,
    in each PoseNet chain too."""
    linear = F.linear
    monkeypatch.setattr(F, "linear", lambda x, w, b=None: linear(_tf32(x), _tf32(w), b))
    gaps = checks(followed)
    assert float(gaps["step"].max()) > 10 * STEP_TOL
    assert all(gaps["by_chain"][c][0] > 10 * STEP_TOL for c in (1, 3))


def test_posenet_control_fails_in_the_posenet_chains_alone(followed, monkeypatch):
    """The driver's PoseNet-only control (TF32 on while the reference's
    PoseNet runs, nothing else), its TF32 emulated here by rounding a
    linear product's operands wherever TF32 is switched on: both PoseNet
    chains go past the cell's step limit, the TrajNet chains stay within
    STEP_TOL."""
    linear = F.linear

    def maybe_tf32(x, w, b=None):
        if torch.backends.cuda.matmul.allow_tf32:
            return linear(_tf32(x), _tf32(w), b)
        return linear(x, w, b)

    monkeypatch.setattr(F, "linear", maybe_tf32)
    cell, drv, (body, stats, batches, prog), done = followed
    gaps = drv.run_checks(cell["config"], body, stats, batches, done, SEED, CPU, prog.layouts, tf32="posenet")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert all(gaps["by_chain"][c][0] > max(10 * STEP_TOL, cell["limits"]["step_gap"]) for c in (1, 3))
    assert all(gaps["by_chain"].get(c, (0.0,))[0] < STEP_TOL for c in (0, 2))


def test_one_camera_repeated_per_row_gives_the_same_batch(followed):
    """run_batch with the first window's camera as [3, 3] and [3], and as
    that camera on every row: the same outputs, bit for bit."""
    _, _, (_, _, batches, prog), _ = followed
    b = dict(batches[0])
    outs = []
    for cam_r, cam_t in ((b["cam_r"][0], b["cam_t"][0]), (b["cam_r"][0].repeat(2, 1, 1), b["cam_t"][0].repeat(2, 1))):
        outs.append(prog.run_batch(dict(b, cam_r=cam_r, cam_t=cam_t), torch.Generator().manual_seed(5)))
    assert all(torch.equal(x, y) for x, y in zip(*outs))




def test_whole_unguided_batch_agrees_with_the_reference(followed):
    """The reference's own early-stopped batch (reference/prox.py's
    run_batch: its draws, conditions, masks and early stop) from the same
    generator seed against the program's, both unguided: measured 1.5e-6
    (pose) and 1.4e-6 (traj) relative, held to 1e-5. Guided, the two
    whole chains drift apart (5.8e-2 at this seed, the batch's two rows
    taking the whole reprojection mean) though every step agrees to 1e-6
    from the same state: the guidance amplifies rounding over its 81 steps,
    so the guided steps are held one by one (above)."""
    cell, drv, (body, stats, batches, prog), _ = followed
    ref = drv._reference(cell["config"], body, stats["mean"], stats["std"], SEED, CPU, "f32", prog.layouts)
    ref.prox_guided = False
    prog.pipeline.grad_type = None
    try:
        pose_p, traj_p = prog.run_batch(batches[0], torch.Generator().manual_seed(SEED))
    finally:
        prog.pipeline.grad_type = "prox"
    pose_r, traj_r = ref.run_batch(batches[0], torch.Generator().manual_seed(SEED))
    assert float((pose_p - pose_r).norm() / pose_r.norm()) < 1e-5
    assert float((traj_p - traj_r).norm() / traj_r.norm()) < 1e-5
