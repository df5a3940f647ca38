"""`test_amass_full --infill_traj=True`: the port's CLI hands the flag to
its pipeline, so iteration 2 conditions TrajControl on the visible noisy
trajectory plus iteration 1's prediction inside the window (reference
test_amass_full.py:233-237). The JAX CLI builds its RohmPipeline without the
flag (its iteration 2 sees zeros in the window), so the port's pickle
differs from the JAX CLI's at this flag, and only here; the reference for
the port's CLI is the JAX `RohmPipeline(infill_traj=True)` called directly.

The port's CLI runs on the CPU on a tiny synthetic tree with JAX-initialised
`.npz` checkpoints and replayed noise; its one batch's inputs, as the CLI
hands them to `run_batch`, then go through the JAX pipeline built with the
same params, schedules, stats and noise. Without the skating guidance
(`--cond_fn_with_grad=False`): the flag acts on TrajControl's condition,
and over 80 frames the guidance's contact and velocity thresholds flip on
f32 rounding between the frameworks (measured 3.05 apart on the pose with
it, 7.8e-4 without, on values up to |125|).
"""

import os
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "cfg_files" / "test_cfg" / "amass_occ_leg_noise_3.yaml")
# the CLI's infill window starts at frame 65 (reference test_amass_full.py:
# 137-141): 81-frame clips hold its 14 frames
CLIP_LEN, STEPS_TRAJ, STEPS_POSE, ITERS = 81, 3, 4, 2


def _preset_noise(b: int, t_traj: int, tf: int) -> dict:
    rng = np.random.default_rng(11)
    shapes = {
        "traj_init": (ITERS, b, t_traj, tf),
        "traj_step": (ITERS, STEPS_TRAJ, b, t_traj, tf),
        "pose_init": (ITERS, b, t_traj - 1, 294),
        "pose_step": (ITERS, STEPS_POSE, b, t_traj - 1, 294),
    }
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


@pytest.fixture(scope="module")
def infill(tmp_path_factory):
    """The port's CLI run (recording each run_batch call's inputs, output
    and pipeline) and the checkpoints."""
    import flax
    import jax

    from rohm_tpu.body import synthetic_model as jax_synthetic_model
    from rohm_tpu.cli import common as jcommon
    from rohm_tpu.data import write_synthetic_amass as jax_write_amass
    from rohm_tpu_torch.cli import test_amass_full as tcli
    from rohm_tpu_torch.pipeline import RohmPipeline

    tmp = tmp_path_factory.mktemp("infill")
    args = SimpleNamespace(mid_dim=64, latent_dim=32)
    rng = np.random.default_rng(0)
    control = jax.tree.map(np.asarray, jcommon.init_trajnet_params(
        jcommon.build_trajnet(args, 13, True), CLIP_LEN, 0))
    made = {
        "trajnet": {"params": {k: v for k, v in control["params"].items() if k != "ControlNet_0"}},
        "trajcontrol": control,
        "posenet": jax.tree.map(np.asarray, jcommon.init_posenet_params(jcommon.build_posenet(args), CLIP_LEN, 0)),
    }
    paths, params = {}, {}
    for name, tree in made.items():
        flat = flax.traverse_util.flatten_dict(tree, sep="/")
        flat = {k: (0.05 * rng.standard_normal(v.shape)).astype(np.float32) if not v.any() else v
                for k, v in flat.items()}
        os.makedirs(tmp / "ckpt" / name)
        paths[name] = str(tmp / "ckpt" / name / f"{name}.npz")
        np.savez(paths[name], **flat)
        params[name] = flax.traverse_util.unflatten_dict(flat, sep="/")
    jax_write_amass(str(tmp / "amass"), jax_synthetic_model(),
                    datasets={n: 1 for n in ("TCDHands", "TotalCapture", "SFU")}, seq_len=CLIP_LEN + 4)

    calls = []
    run_batch = RohmPipeline.run_batch

    def recording(self, traj_cond, traj_clean, pose_noisy, pose_mask, traj_mask, generator, **kw):
        kw["preset_noise"] = _preset_noise(*np.shape(traj_cond))
        out = run_batch(self, traj_cond, traj_clean, pose_noisy, pose_mask, traj_mask, generator, **kw)
        calls.append({"pipeline": self, "inputs": [np.array(a) for a in (
            traj_cond, traj_clean, pose_noisy, pose_mask, traj_mask)],
            "noise": kw["preset_noise"], "pose": out[0].numpy(), "traj": out[1].numpy()})
        return out

    argv = [
        f"--config={CONFIG}", "--synthetic_data=True", f"--dataset_root={tmp / 'amass'}",
        f"--clip_len={CLIP_LEN}", "--batch_size=4", "--max_batches=1",
        f"--diffusion_steps_trajnet={STEPS_TRAJ}", f"--diffusion_steps_posenet={STEPS_POSE}",
        "--mid_dim=64", "--latent_dim=32", "--load_noise=False", "--infill_traj=True",
        "--cond_fn_with_grad=False",
        "--traj_mask_ratio=0.1", f"--sample_iter={ITERS}", "--seed=0", "--device=cpu",
        f"--model_path_trajnet={paths['trajnet']}", f"--model_path_trajnet_control={paths['trajcontrol']}",
        f"--model_path_posenet={paths['posenet']}", f"--save_root={tmp / 'res'}",
    ]
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        mp.setattr(RohmPipeline, "run_batch", recording)
        pkl = tcli.main(argv)
    assert len(calls) == 1
    return calls[0], params, pkl


def test_cli_hands_infill_to_the_pipeline(infill):
    """The pipeline the CLI built has the flag, the trajectory mask holds a
    window of zeros, and the pickle's name says infill."""
    call, _, pkl = infill
    assert call["pipeline"].infill_traj is True
    traj_mask = call["inputs"][4]
    assert traj_mask.shape == (4, CLIP_LEN - 1)
    assert (traj_mask[:, 65:79] == 0).all() and (traj_mask[:, :65] == 1).all() and (traj_mask[:, 79:] == 1).all()
    assert "_infill_traj_0.1_" in os.path.basename(pkl)


def test_cli_matches_jax_pipeline_with_infill(infill):
    """The CLI's batch against the JAX RohmPipeline(infill_traj=True) on the
    same inputs, params, stats and noise: 2 iterations of 3 TrajNet and 4
    PoseNet steps, f32 on both sides, random weights (values up to |125|):
    measured 6.2e-6 of the largest |value| on the pose and 1.4e-5 absolute on
    the trajectory, held at 2e-5 of it and 1e-4. The same batch through the
    port's pipeline without the flag (what the JAX CLI runs) is off by over
    a hundred times that."""
    import jax
    import jax.numpy as jnp

    from rohm_tpu.body import synthetic_model as jax_synthetic_model
    from rohm_tpu.cli import common as jcommon
    from rohm_tpu.diffusion import make_schedule as jax_make_schedule
    from rohm_tpu.pipeline import RohmPipeline as JaxPipeline

    call, params, _ = infill
    pipe = call["pipeline"]
    args = SimpleNamespace(mid_dim=64, latent_dim=32)
    jpipe = JaxPipeline(
        trajnet=jcommon.build_trajnet(args, 13, False), trajnet_params=params["trajnet"],
        trajcontrol=jcommon.build_trajnet(args, 13, True), trajcontrol_params=params["trajcontrol"],
        posenet=jcommon.build_posenet(args), posenet_params=params["posenet"],
        sched_traj=jax_make_schedule("cosine", STEPS_TRAJ, ""), sched_pose=jax_make_schedule("cosine", STEPS_POSE, ""),
        body_model=jax_synthetic_model(), mean=jnp.asarray(pipe.mean.numpy()), std=jnp.asarray(pipe.std.numpy()),
        repr_abs_only=pipe.repr_abs_only, traj_feat_dim=pipe.traj_feat_dim, sample_iter=ITERS,
        early_stop=pipe.early_stop, grad_type=pipe.grad_type, mask_scheme=pipe.mask_scheme,
        input_noise=pipe.input_noise, iter2_cond_noisy_pose=pipe.iter2_cond_noisy_pose,
        iter2_cond_noisy_traj=pipe.iter2_cond_noisy_traj, infill_traj=True,
    )
    assert pipe.iter2_cond_noisy_traj  # the branch that infill changes
    inputs = [jnp.asarray(a) for a in call["inputs"]]
    jpose, jtraj = jpipe.run_batch(*inputs, jax.random.PRNGKey(0), preset_noise=call["noise"])
    jpose, jtraj = np.asarray(jpose), np.asarray(jtraj)
    err = np.abs(call["pose"] - jpose).max()
    assert err <= 2e-5 * np.abs(jpose).max() and np.abs(call["traj"] - jtraj).max() <= 1e-4, err

    pipe.infill_traj = False
    try:
        off_pose, _ = pipe.run_batch(*call["inputs"], torch.Generator().manual_seed(0), preset_noise=call["noise"])
    finally:
        pipe.infill_traj = True
    assert np.abs(off_pose.numpy() - jpose).max() > 100 * err
