"""The --fused_posenet kernel modes against the plain path, with trained
weights: the port's RohmPipeline on the fixture's flagship batch (the first
4 clips, tests/torch_trained/), full chains and the fixture's replayed
noise, in "f32" and "bf16" here, "int8" and "int8qa" in
test_torch_trained_modes_int8.py (on the CPU, the kernels' plain
versions; about a minute each, the f32 one two), each against False (the
plain PoseNet module). Each mode's eval metrics are held to False's within
the JAX round's budgets
(tests/test_e2e_parity_trained.py::test_fused_modes_metric_budget_trained):
the MPJPEs within rel 2e-2, the other metrics within rel 8e-2, or abs 1e-6
(fixture.mode_budget).
No JAX here: the card runs the same gate (chip_smoke.py's trained phase).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_trained_parity import few_threads  # noqa: F401 (a fixture)
from tests.torch_trained import fixture as fx

N = 4
CONFIG = "flagship"
MODES = ("f32", "bf16")


@pytest.fixture(scope="module")
def trained(few_threads):
    b = fx.batch(CONFIG, N)
    noise = fx.preset_noise(N)

    def run(mode):
        pipe = fx.port_pipeline(CONFIG, mode)
        pose, _ = pipe.run_batch(*(b[k] for k in fx.BATCH_INPUTS), torch.Generator().manual_seed(0),
                                 preset_noise=noise)
        return pose, fx.port_metrics(pipe, pose, b, CONFIG)

    return run, run(False)


def test_contact_margins_in_the_port():
    """The fixture's margins, recomputed by the port's PoseNet on the same
    x_t (numpy draws) at t = 25 under each config's evaluation mask."""
    from rohm_tpu_torch.diffusion.schedule import make_schedule

    meta = fx.meta()["contact_margin"]
    sched = make_schedule("cosine", fx.STEPS_POSE)
    posenet = fx.port_pipeline(CONFIG).posenet
    for name in fx.CONFIGS:
        b = fx.batch(name)
        planted = np.asarray(fx.meta()["planted_contact_frames"])
        x0 = torch.as_tensor(b["pose_clean"][:, :fx.CLIP_LEN - 2]).clone()
        x0[:, planted, -4:] = 1.0
        noise = torch.as_tensor(np.random.default_rng(meta["noise_seed"]).standard_normal(x0.shape)
                                .astype(np.float32))
        t = meta["t"]
        x_t = sched.sqrt_alphas_cumprod[t] * x0 + sched.sqrt_one_minus_alphas_cumprod[t] * noise
        cond = torch.as_tensor(b["pose_noisy"][:, :fx.CLIP_LEN - 2] * b["pose_mask"])
        with torch.no_grad():
            out = posenet(x_t, cond, t)
        margin = (out[..., -4:] - 0.5).abs()
        assert margin.mean() > 0.4 and margin.min() > 0.2, (name, margin.mean(), margin.min())
        assert abs(margin.mean().item() - meta[name]["mean"]) < 1e-3, name


@pytest.mark.parametrize("mode", MODES)
def test_mode_metrics_within_budget(trained, mode):
    run, (plain_pose, plain_m) = trained
    pose, m = run(mode)
    assert pose.shape == plain_pose.shape and torch.isfinite(pose).all()
    for k in plain_m:
        print(f"[trained-modes] {mode} {k}: {m[k]:.6f} (False {plain_m[k]:.6f})")
    assert fx.metric_gaps(m, plain_m, fx.mode_budget) == []
