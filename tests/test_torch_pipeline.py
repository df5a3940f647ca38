"""The port's sampler and the whole inference slice against the JAX package,
on the CPU: the same weights, the same inputs and the same replayed noise
(`preset_noise`) go through rohm_tpu.pipeline.RohmPipeline.run_batch (Pallas
kernels in interpret mode) and rohm_tpu_torch.pipeline.RohmPipeline.run_batch
(the kernels' plain versions). Small widths: TrajNet mid_dim=64, PoseNet
32d x 2 layers x 2 heads; cosine schedules of 5 and 8 steps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rohm_tpu.body import synthetic_model as jax_synthetic_model
from rohm_tpu.data.synthetic import _synthetic_params
from rohm_tpu.diffusion import make_schedule as jax_make_schedule
from rohm_tpu.diffusion.sampler import GuidanceSpec as JaxGuidanceSpec
from rohm_tpu.diffusion.sampler import p_sample_loop as jax_p_sample_loop
from rohm_tpu.models import PoseNet as FlaxPoseNet
from rohm_tpu.models import TrajNet as FlaxTrajNet
from rohm_tpu.pipeline import RohmPipeline as JaxPipeline
from rohm_tpu.pipeline import traj_to_pose_bridge as jax_bridge
from rohm_tpu.reprs.stats import compute_stats
from rohm_tpu.utils.convert_torch_ckpt import convert_posenet, convert_trajnet
from rohm_tpu_torch.body import forward_joints, synthetic_model
from rohm_tpu_torch.diffusion import GuidanceSpec, make_schedule, p_sample_loop
from rohm_tpu_torch.models import PoseNet, TrajNet
from rohm_tpu_torch.pipeline import RohmPipeline, amass_eval_pose_mask, traj_to_pose_bridge
from rohm_tpu_torch.reprs import get_repr
from rohm_tpu_torch.reprs.schema import TRAJ_ABS_INDEX

torch.set_num_threads(1)

B, CLIP_LEN = 2, 17
T_TRAJ, T_POSE = CLIP_LEN - 1, CLIP_LEN - 2  # 16 (divisible by 16), 15
STEPS_TRAJ, STEPS_POSE, ITERS = 5, 8, 2


def _unflatten(flat: dict) -> dict:
    tree = {}
    for key, v in flat.items():
        node = tree
        *scopes, leaf = key.split("/")
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = v
    return tree


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("guided, early", [(False, 0), (True, 0), (True, 2)])
def test_p_sample_loop_replay_matches_jax(guided, early):
    """Toy model 0.5*x with replayed noise: the chain (split at the guidance
    threshold, early stop returning the last pred_x0) matches the JAX scan."""
    rng = np.random.default_rng(0)
    shape = (2, 4, 3)
    noise = rng.standard_normal(shape).astype(np.float32)
    step_noise = rng.standard_normal((10,) + shape).astype(np.float32)
    target = rng.standard_normal(shape).astype(np.float32)
    mask = np.ones(shape[-1], np.float32)
    mask[0] = 0.0
    jsched, tsched = jax_make_schedule("cosine", 10), make_schedule("cosine", 10)
    jg = (JaxGuidanceSpec(lambda x: jnp.sum((x - target) ** 2), 0.3, 4, jnp.asarray(mask)),) if guided else ()
    tg = (GuidanceSpec(lambda x: ((x - torch.from_numpy(target)) ** 2).sum(), 0.3, 4,
                       torch.from_numpy(mask)),) if guided else ()
    seen = []

    def model_fn(x, t):
        seen.append(t)
        return 0.5 * x

    ref = jax_p_sample_loop(lambda x, t: 0.5 * x, jsched, shape, jax.random.PRNGKey(0),
                            noise=jnp.asarray(noise), guidance=jg, early_stop_steps=early,
                            step_noise=jnp.asarray(step_noise))
    out = p_sample_loop(model_fn, tsched, shape, torch.Generator().manual_seed(0),
                        noise=torch.from_numpy(noise), guidance=tg, early_stop_steps=early,
                        step_noise=torch.from_numpy(step_noise))
    # f32 posterior math in the same order; XLA may fuse multiply-adds
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    assert seen == list(range(9, early - 1, -1))


def test_p_sample_loop_timestep_map_and_generator():
    """The model sees timestep_map[t]; without replayed noise the chain draws
    from the generator, reproducibly."""
    sched = make_schedule("cosine", 20, timestep_respacing="ddim5")
    seen = []

    def model_fn(x, t):
        seen.append(t)
        return 0.5 * x

    a = p_sample_loop(model_fn, sched, (2, 3), torch.Generator().manual_seed(1))
    b = p_sample_loop(lambda x, t: 0.5 * x, sched, (2, 3), torch.Generator().manual_seed(1))
    assert seen == [16, 12, 8, 4, 0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------


@functools.cache
def _slice_setup():
    """Weights (torch init, moved to flax through the JAX package's own
    converter), inputs built from smooth synthetic clips, stats, noise."""
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    trajnet = TrajNet(traj_feat_dim=13, cond_dim=13, mid_dim=64)
    trajcontrol = TrajNet(traj_feat_dim=13, cond_dim=13, mid_dim=64, trajcontrol=True)
    posenet = PoseNet(latent_dim=32, ff_size=64, num_layers=2, num_heads=2)
    with torch.no_grad():  # wake the zero convs so the ControlNet branch counts
        for p in trajcontrol.controlnet.parameters():
            if not p.any():
                p.copy_(torch.from_numpy(0.05 * rng.standard_normal(p.shape)).float())

    def sd(m):
        return {k: v.numpy() for k, v in m.state_dict().items()}

    flax = {
        "trajnet": _unflatten(convert_trajnet(sd(trajnet))),
        "trajcontrol": _unflatten(convert_trajnet(sd(trajcontrol), trajcontrol=True)),
        "posenet": _unflatten(convert_posenet(sd(posenet), num_layers=2, num_heads=2, latent_dim=32)),
    }

    tbody = synthetic_model(num_verts=64, seed=0)
    plist = [_synthetic_params(CLIP_LEN, seed=s, grounded=True) for s in range(B)]
    clean = {k: np.stack([p[k] for p in plist]).astype(np.float32) for k in plist[0]}
    noisy = dict(clean)
    noisy["body_pose"] = clean["body_pose"] + rng.normal(scale=0.05, size=clean["body_pose"].shape).astype(np.float32)
    noisy["transl"] = clean["transl"] + rng.normal(scale=0.03, size=clean["transl"].shape).astype(np.float32)

    def encode(p):
        p = {k: torch.from_numpy(v) for k, v in p.items()}
        j = forward_joints(tbody, p["betas"], p["global_orient"], p["body_pose"], p["transl"])
        return get_repr(j, global_orient=p["global_orient"], transl=p["transl"],
                        body_pose=p["body_pose"], betas=p["betas"]).numpy()

    rep_clean, rep_noisy = encode(clean), encode(noisy)
    mean, std = compute_stats(rep_clean)
    clean_n, noisy_n = (rep_clean - mean) / std, (rep_noisy - mean) / std
    inputs = (
        noisy_n[..., TRAJ_ABS_INDEX],  # traj_cond [B, 16, 13]
        clean_n,  # traj_clean [B, 16, 294]
        noisy_n,  # pose_noisy [B, 16, 294]
        amass_eval_pose_mask("lower", B, T_POSE),
        np.ones((B, T_TRAJ), np.float32),
    )
    noise = {
        "traj_init": rng.standard_normal((ITERS, B, T_TRAJ, 13)),
        "traj_step": rng.standard_normal((ITERS, STEPS_TRAJ, B, T_TRAJ, 13)),
        "pose_init": rng.standard_normal((ITERS, B, T_POSE, 294)),
        "pose_step": rng.standard_normal((ITERS, STEPS_POSE, B, T_POSE, 294)),
    }
    noise = {k: v.astype(np.float32) for k, v in noise.items()}
    models = {"trajnet": trajnet, "trajcontrol": trajcontrol, "posenet": posenet}
    return models, flax, tbody, mean, std, inputs, noise


def _pipelines(fused, sample_iter=ITERS):
    models, flax, tbody, mean, std, *_ = _slice_setup()
    kw = dict(repr_abs_only=True, traj_feat_dim=13, sample_iter=sample_iter, grad_type="amass",
              mask_scheme="lower", input_noise=True, iter2_cond_noisy_pose=True,
              iter2_cond_noisy_traj=True, fused_posenet=fused)
    jp = JaxPipeline(
        trajnet=FlaxTrajNet(traj_feat_dim=13, cond_dim=13, mid_dim=64), trajnet_params=flax["trajnet"],
        trajcontrol=FlaxTrajNet(traj_feat_dim=13, cond_dim=13, mid_dim=64, trajcontrol=True),
        trajcontrol_params=flax["trajcontrol"],
        posenet=FlaxPoseNet(latent_dim=32, ff_size=64, num_layers=2, num_heads=2),
        posenet_params=flax["posenet"],
        sched_traj=jax_make_schedule("cosine", STEPS_TRAJ), sched_pose=jax_make_schedule("cosine", STEPS_POSE),
        body_model=jax_synthetic_model(num_verts=64, seed=0),
        mean=jnp.asarray(mean), std=jnp.asarray(std), **kw,
    )
    tp = RohmPipeline(
        trajnet=models["trajnet"], trajcontrol=models["trajcontrol"], posenet=models["posenet"],
        sched_traj=make_schedule("cosine", STEPS_TRAJ), sched_pose=make_schedule("cosine", STEPS_POSE),
        body_model=tbody, mean=torch.from_numpy(mean), std=torch.from_numpy(std), **kw,
    )
    return jp, tp


def test_iteration0_traj_and_bridge_tight():
    """Iteration 0's TrajNet chain and the bridge, before any guidance or
    PoseNet: f32 on both sides, so the gates are tight."""
    _, flax, tbody, mean, std, inputs, noise = _slice_setup()
    _, tp = _pipelines(False, sample_iter=1)
    pn = {k: noise[k][:1] for k in ("traj_init", "traj_step")}
    _, traj = tp.run_batch(*inputs, torch.Generator().manual_seed(0), preset_noise=pn)
    # the JAX pipeline's iteration 0 (rohm_tpu/pipeline.py:271-278), without
    # compiling the rest of its program
    jtraj, cond = FlaxTrajNet(traj_feat_dim=13, cond_dim=13, mid_dim=64), jnp.asarray(inputs[0])
    traj_ref = jax.jit(lambda n, sn: jax_p_sample_loop(
        lambda x, t: jtraj.apply(flax["trajnet"], x, cond, t), jax_make_schedule("cosine", STEPS_TRAJ),
        (B, T_TRAJ, 13), jax.random.PRNGKey(0), noise=n, step_noise=sn,
    ))(pn["traj_init"][0], pn["traj_step"][0])
    # 5 steps of an f32 U-Net on both sides (conv summation order, flax's
    # one-pass GroupNorm variance): ~1e-6 relative per layer
    np.testing.assert_allclose(traj.numpy(), np.asarray(traj_ref), atol=2e-4, rtol=1e-4)

    ref = jax_bridge(jnp.asarray(traj_ref), jnp.asarray(inputs[1]), jnp.asarray(mean),
                     jnp.asarray(std), jax_synthetic_model(num_verts=64, seed=0))
    out = traj_to_pose_bridge(torch.from_numpy(np.asarray(traj_ref)), torch.from_numpy(inputs[1]),
                              torch.from_numpy(mean), torch.from_numpy(std), tbody)
    assert out.shape == (B, T_POSE, 22)
    # decode -> FK -> encode in f32, divided by the std: ~1e-5
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5, rtol=1e-4)


def check_run_batch_matches_jax(fused, guided: bool, pose_max: float, pose_mean: float):
    """The whole slice, 2 iterations, all four preset_noise keys replayed,
    with (`guided`) or without the shipped skating guidance. Used here for
    the f32 path and by test_torch_pipeline_{bf16,int8}.py."""
    *_, inputs, noise = _slice_setup()
    jp, tp = _pipelines(fused)
    if not guided:
        jp.grad_type = tp.grad_type = None
    pose_ref, traj_ref = jp.run_batch(*inputs, jax.random.PRNGKey(0), preset_noise=noise)
    pose, traj = tp.run_batch(*inputs, torch.Generator().manual_seed(0), preset_noise=noise)
    assert pose.shape == (B, T_POSE, 294) and traj.shape == (B, T_TRAJ, 13)
    assert torch.isfinite(pose).all() and torch.isfinite(traj).all()
    dev = np.abs(pose.numpy() - np.asarray(pose_ref))
    assert dev.max() < pose_max and dev.mean() < pose_mean, (dev.max(), dev.mean())
    # iteration 2's TrajControl sees iteration 1's pose through control_cond
    tdev = np.abs(traj.numpy() - np.asarray(traj_ref))
    assert tdev.max() < pose_max and tdev.mean() < pose_mean, (tdev.max(), tdev.mean())


def test_run_batch_matches_jax_f32_guided():
    """f32 PoseNet with the shipped guidance (weight 3e6 on all 8 steps):
    only summation order differs, and no contact or velocity threshold of
    the skating loss flips at that size of difference (measured max 2.4e-4,
    mean 1e-6 on the pose)."""
    check_run_batch_matches_jax(False, guided=True, pose_max=1e-2, pose_mean=1e-3)


def test_run_batch_argument_checks():
    *_, inputs, noise = _slice_setup()
    _, tp = _pipelines(False)
    with pytest.raises(ValueError, match="unknown preset_noise key"):
        tp.run_batch(*inputs, torch.Generator(), preset_noise={"pose_noise": noise["pose_init"]})
    models, _, tbody, mean, std, *_ = _slice_setup()

    def make(mode):
        return RohmPipeline(trajnet=models["trajnet"], trajcontrol=None, posenet=models["posenet"],
                            sched_traj=make_schedule("cosine", 5), sched_pose=make_schedule("cosine", 8),
                            body_model=tbody, mean=torch.from_numpy(mean), std=torch.from_numpy(std),
                            fused_posenet=mode)

    # every mode of the JAX package is accepted; an unknown one is refused
    # rather than silently running the plain module
    for mode in (False, True, "bf16", "int8", "int8qa", "f32"):
        make(mode)
    with pytest.raises(ValueError, match="expected False, True"):
        make("fp8")
