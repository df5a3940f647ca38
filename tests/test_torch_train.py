"""The port's training pieces against the JAX package, on the CPU, from
seeded numpy inputs: q_sample with per-sample timesteps, the
joint_rel_traj decoder, posenet_losses term by term, the masking curricula
(the same numpy generator must give the same masks) and the timestep
samplers. The grads function and AdamW are in test_torch_train_grads.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rohm_tpu.body import synthetic_model as jax_synthetic_model
from rohm_tpu.diffusion import make_schedule as jax_make_schedule
from rohm_tpu.diffusion import q_sample as jax_q_sample
from rohm_tpu.models.losses import posenet_losses as jax_posenet_losses
from rohm_tpu.reprs import recover_from_repr as jax_recover
from rohm_tpu.train import masking as jm
from rohm_tpu.train import resample as jr
from rohm_tpu_torch.diffusion import make_schedule, q_sample
from rohm_tpu_torch.models.losses import posenet_losses
from rohm_tpu_torch.reprs import recover_from_repr
from rohm_tpu_torch.train import masking as tm
from rohm_tpu_torch.train import resample as tr
from rohm_tpu_torch.utils.convert_flax import body_model_from_jax

torch.set_num_threads(1)

B, T = 3, 12
WEIGHTS = {  # the shipped stage-1 weights, joint_smooth woken so every term counts
    "weight_loss_rec_repr_full_body": 1.0,
    "weight_loss_repr_foot_contact_mse": 1.0,
    "weight_loss_joint_pos_global": 100.0,
    "weight_loss_joint_vel_global": 1000.0,
    "weight_loss_joint_smooth": 10.0,
    "weight_loss_foot_skating": 0.1,
}


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def repr_batch(seed: int, b: int = B, t: int = T):
    """A normalized clean repr, a model output near it, and stats [294]:
    slow sinusoids so velocities are small and the skating mask varies."""
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0, 2 * np.pi, (b, 1, 294))
    freq = rng.uniform(0.05, 0.3, (b, 1, 294))
    clean = np.sin(freq * np.arange(t)[None, :, None] + phase).astype(np.float32)
    out = (clean + 0.2 * rng.standard_normal(clean.shape)).astype(np.float32)
    mean = (0.1 * rng.standard_normal(294)).astype(np.float32)
    std = (0.2 + 0.3 * rng.random(294)).astype(np.float32)
    return clean, out, mean, std


@pytest.fixture(scope="module")
def bodies():
    jbody = jax_synthetic_model(num_verts=64, seed=3)
    return jbody, body_model_from_jax(jbody, "cpu")


def test_q_sample_per_sample_t():
    rng = np.random.default_rng(0)
    x0, noise = (rng.standard_normal((4, 5, 7)).astype(np.float32) for _ in range(2))
    t = np.array([0, 17, 500, 999])
    ref = jax_q_sample(jax_make_schedule("cosine", 1000), jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    got = q_sample(make_schedule("cosine", 1000), _t(x0), torch.from_numpy(t), _t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("mode", ["joint_abs_traj", "joint_rel_traj"])
def test_recover_joint_modes(mode):
    """Root integration from the velocity dims (cumsum of heading and of
    rotated planar velocities) over 12 frames: f32 sums, ~1e-6."""
    clean, _, mean, std = repr_batch(1)
    dn = clean * std + mean
    ref = np.asarray(jax_recover(jnp.asarray(dn), mode=mode))
    got = recover_from_repr(_t(dn), mode=mode).numpy()
    assert got.shape == (B, T, 22, 3)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("skating", [True, False])
def test_posenet_losses_per_term(bodies, skating):
    """Every term and the weighted total, with the skating gate on and off.
    The global-joint terms go through SMPL-X FK in f32 on both sides:
    relative 2e-5."""
    jbody, tbody = bodies
    clean, out, mean, std = repr_batch(2)
    ref = jax_posenet_losses(jnp.asarray(out), jnp.asarray(clean), jnp.asarray(mean), jnp.asarray(std),
                             jbody, WEIGHTS, skating_active=jnp.asarray(float(skating)))
    got = posenet_losses(_t(out), _t(clean), _t(mean), _t(std), tbody, WEIGHTS,
                         skating_active=torch.tensor(float(skating)))
    assert list(got) == list(ref)
    assert float(ref["loss_foot_skating_from_abs_traj"]) > 0  # the skating mask is not empty
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=2e-5, atol=1e-7, err_msg=k)


def test_posenet_losses_gradient_flows(bodies):
    """The loss is differentiable in the model output through all three
    decoders: the abs and rel traj dims (0:7), the SMPL-X orientation and
    translation (7:13, 16:19); the rotation and translation velocities
    (13:16, 19:22) feed no PoseNet term."""
    _, tbody = bodies
    clean, out, mean, std = repr_batch(3)
    o = _t(out).requires_grad_()
    posenet_losses(o, _t(clean), _t(mean), _t(std), tbody, WEIGHTS)["loss"].backward()
    assert torch.isfinite(o.grad).all()
    moved = o.grad[..., :22].abs().sum(dim=(0, 1)) > 0
    assert moved[:13].all() and moved[16:19].all()
    assert not moved[13:16].any() and not moved[19:22].any()


# ---------------------------------------------------------------------------
# masking curricula: the same generator, the same masks, the same draws left
# ---------------------------------------------------------------------------


def _same_draws(rng_j, rng_t):
    assert rng_j.bit_generator.state == rng_t.bit_generator.state


@pytest.fixture(scope="module")
def prox_bank_root(tmp_path_factory):
    """A PROX mask_joint tree: two recordings of per-frame 0/1 joint
    visibility (25 columns, as the reference's mask_joint.npy)."""
    root = tmp_path_factory.mktemp("prox") / "mask_joint"
    rng = np.random.default_rng(5)
    for name, n in (("rec_a", 40), ("rec_b", 29)):
        (root / name).mkdir(parents=True)
        mask = (rng.random((n, 25)) > 0.3).astype(np.float32)
        mask[: n // 3] = 1.0  # a clip with no occlusion is dropped from the bank
        np.save(root / name / "mask_joint.npy", mask)
    return str(root)


def test_prox_bank_and_joint_visibility(prox_bank_root):
    ref = jm.build_prox_mask_bank(prox_bank_root, 9)
    got = tm.build_prox_mask_bank(prox_bank_root, 9)
    assert got.shape == ref.shape and 0 < len(ref) < 7
    np.testing.assert_array_equal(got, ref)
    clip = (np.random.default_rng(1).random((9, 22)) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(tm.expand_joint_visibility(clip), jm.expand_joint_visibility(clip))


@pytest.mark.parametrize("scheme", ["lower", "lower+upper", "lower+full", "lower+upper+full"])
@pytest.mark.parametrize("epoch", [0, 6])
@pytest.mark.parametrize("input_noise", [True, False])
def test_train_cond_mask_curriculum(scheme, epoch, input_noise, prox_bank_root):
    """Twenty batches per case, so every branch of the scheme is drawn
    (epoch 6 is past start_prox_mask_epoch=5)."""
    bank = jm.build_prox_mask_bank(prox_bank_root, 9)
    rng_j, rng_t = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(20):
        ref = jm.posenet_train_cond_mask(rng_j, 4, 9, epoch, 5, scheme, bank, input_noise)
        got = tm.posenet_train_cond_mask(rng_t, 4, 9, epoch, 5, scheme, bank.copy(), input_noise)
        np.testing.assert_array_equal(got, ref)
    _same_draws(rng_j, rng_t)


def test_mask_pieces_and_eval_mask():
    rng_j, rng_t = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(5):
        np.testing.assert_array_equal(tm.random_joint_mask(rng_t, 6), jm.random_joint_mask(rng_j, 6))
        np.testing.assert_array_equal(tm.upper_body_mask(rng_t, 6), jm.upper_body_mask(rng_j, 6))
        np.testing.assert_array_equal(tm.full_window_mask(rng_t, 6, 40), jm.full_window_mask(rng_j, 6, 40))
        np.testing.assert_array_equal(tm.posenet_eval_cond_mask(rng_t, 6, 9, True),
                                      jm.posenet_eval_cond_mask(rng_j, 6, 9, True))
    _same_draws(rng_j, rng_t)
    assert tm._SCHEME_PROBS == jm._SCHEME_PROBS


@pytest.mark.parametrize("name", ["uniform", "loss-second-moment"])
def test_schedule_samplers(name):
    sj, st = jr.create_named_schedule_sampler(name, 20), tr.create_named_schedule_sampler(name, 20)
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    for i in range(30):
        tj, wj = sj.sample(8, rng_j)
        tt, wt = st.sample(8, rng_t)
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_array_equal(wt, wj)
        losses = np.linspace(0.1, 2.0, 8) * (i + 1)
        sj.update_with_losses(tj, losses)
        st.update_with_losses(tt, losses)
    _same_draws(rng_j, rng_t)
