"""The plain reference against the port's plain path at a tiny preset on
the CPU: the same inputs, weights and generator, pieces and whole batches."""

import numpy as np
import pytest
import torch
from conftest import tiny
from harness import spec

from reference.denoisers import make_posenet_fn
from reference.pipeline import traj_to_pose_bridge as ref_bridge

CPU = torch.device("cpu")


def build(bench, workload, seed=11, guided=True):
    cell = tiny(spec.cell(workload, bench))
    cell["config"]["cond_fn_with_grad"] = guided
    drv = spec.driver(cell["config"])
    body_arrays, stats, batches = drv.make_inputs(cell["config"], cell["traffic"], seed, CPU)
    prog = drv.Program(cell["config"], body_arrays, stats["mean"], stats["std"], seed, CPU)
    ref = drv._reference(cell["config"], body_arrays, stats["mean"], stats["std"], seed, CPU,
                         cell["config"]["fused_posenet"], prog.layouts)
    return cell, prog, ref, batches


def rel(a, b):
    return float((a - b).detach().norm() / b.detach().norm())


def test_inputs_mask_is_the_clis(bench, few_threads):
    from rohm_tpu_torch.pipeline import amass_eval_pose_mask

    _, _, _, batches = build(bench, "amass_leg3_int8.b256")
    m = batches[0]["pose_mask"].numpy()
    assert np.array_equal(m, amass_eval_pose_mask("lower", m.shape[0], m.shape[1]))


@pytest.mark.parametrize("workload", ["amass_leg3_int8.b256", "amass_leg3_f32.b64"])
def test_nets_agree(bench, workload, few_threads):
    cell, prog, ref, batches = build(bench, workload)
    p, b = prog.pipeline, batches[0]
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, 13, generator=g)
    cc = torch.randn(2, 16, 272, generator=g)
    assert torch.equal(p.trajnet(x, b["traj_cond"], 7), ref.trajnet(x, b["traj_cond"], 7))
    assert torch.equal(p.trajcontrol(x, b["traj_cond"], 7, control_cond=cc),
                       ref.trajcontrol(x, b["traj_cond"], 7, control_cond=cc))
    cond = b["pose_noisy"][:, :15] * b["pose_mask"]
    xp = torch.randn(2, 15, 294, generator=g)
    out_p = p._pose_model_fn(cond)(xp, 17)
    out_r = make_posenet_fn(ref.posenet, cond, cell["config"]["fused_posenet"])(xp, 17)
    # int8: a code that rounds the other way moves a row by about one step
    assert rel(out_p, out_r) < (2e-2 if cell["config"]["fused_posenet"] == "int8" else 1e-5)


def test_bridge_agrees(bench, few_threads):
    from rohm_tpu_torch.pipeline import traj_to_pose_bridge

    _, prog, ref, batches = build(bench, "amass_leg3_f32.b64")
    b = batches[0]
    out = torch.randn(2, 16, 13, generator=torch.Generator().manual_seed(5)) * 0.1 + b["traj_cond"]
    p = prog.pipeline
    assert rel(traj_to_pose_bridge(out, b["traj_clean"], p.mean, p.std, p.body_model),
               ref_bridge(out, b["traj_clean"], ref.mean, ref.std, ref.body_model)) < 1e-5


@pytest.mark.parametrize("guided,tol", [(False, 1e-4), (True, 2e-2)])
def test_whole_batch_agrees_in_f32(bench, few_threads, guided, tol):
    """The f32 path end to end with the same draws from the same generator
    seed. Guided, the skating loss's thresholds (speed > 0.1 m/s, contact >
    0.5) turn rounding differences into steps of the guidance, so whole
    chains drift apart; the benchmark's check therefore compares steps."""
    _, prog, ref, batches = build(bench, "amass_leg3_f32.b64", guided=guided)
    b = batches[0]
    pose_p, traj_p = prog.run_batch(b, torch.Generator().manual_seed(9))
    pose_r, traj_r = ref.run_batch(b, torch.Generator().manual_seed(9))
    assert rel(pose_p, pose_r) < tol and rel(traj_p, traj_r) < tol
