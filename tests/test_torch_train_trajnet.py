"""TrajNet and TrajControl training of the port against the JAX package, on
the CPU: `traj_infill_mask` and the loop's draw order, `trajnet_losses` term
by term, `make_trajnet_grads_fn` (q_sample on the first traj dims ->
forward -> losses through SMPL-X -> gradients), three AdamW steps with and
without the TrajControl freeze, `bootstrap_trajcontrol` and the eval
sampler with replayed noise.

Both packages get the same flax params (converted for the port with
`trajnet_state_dict`), the same batch, timesteps and q_sample noise from
numpy. Small widths: TrajNet mid_dim=64, T=16, B=2, a 64-vertex synthetic
body; a cosine schedule of 100 steps (5 for the sampler). The flax trees
come from a port init through the JAX package's own converter (a flax init
would cost an XLA compile per layout), checked against the flax model's
init shapes."""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import repr_batch

from rohm_tpu.body import synthetic_model as jax_synthetic_model
from rohm_tpu.cli.common import bootstrap_trajcontrol as jax_bootstrap
from rohm_tpu.diffusion import make_schedule as jax_make_schedule
from rohm_tpu.diffusion.sampler import p_sample_loop as jax_p_sample_loop
from rohm_tpu.models import TrajNet as FlaxTrajNet
from rohm_tpu.models.losses import trajnet_losses as jax_trajnet_losses
from rohm_tpu.train import create_train_state as jax_create_train_state
from rohm_tpu.train import make_trajnet_grads_fn as jax_make_grads_fn
from rohm_tpu.train import masking as jm
from rohm_tpu.train.state import trajcontrol_frozen_mask as jax_frozen_mask
from rohm_tpu.utils.convert_torch_ckpt import convert_trajnet
from rohm_tpu_torch.cli.common import bootstrap_trajcontrol
from rohm_tpu_torch.diffusion import make_schedule
from rohm_tpu_torch.models import TrajNet
from rohm_tpu_torch.models.losses import trajnet_losses
from rohm_tpu_torch.reprs.schema import TRAJ_ABS_INDEX
from rohm_tpu_torch.train import masking as tm
from rohm_tpu_torch.train.loop import TrainLoopTrajNet
from rohm_tpu_torch.train.state import create_train_state, trajcontrol_frozen_mask
from rohm_tpu_torch.train.steps import make_trajnet_grads_fn, make_trajnet_sampler
from rohm_tpu_torch.utils.convert_flax import body_model_from_jax, trajnet_state_dict

torch.set_num_threads(1)

B, T, MID, STEPS = 2, 16, 64, 100
WEIGHTS = {  # the shipped stage-1 weights (trajnet_train_vanilla_stage1.yaml): every term counts
    "weight_loss_root_rec_repr": 1.0,
    "weight_loss_root_pos_global": 100.0,
    "weight_loss_root_vel_global": 1000.0,
    "weight_loss_root_rot_vel_from_abs_traj": 1.0,
    "weight_loss_root_smplx_transl_vel": 1000.0,
    "weight_loss_root_smplx_rot_vel": 1.0,
    "weight_loss_root_smooth": 1.0,
    "weight_loss_root_rot_cos_smooth_from_abs_traj": 1.0,
}
# (trajcontrol, repr_abs_only): the vanilla net in both repr modes, TrajControl abs-only as shipped
LAYOUTS = [(False, True), (False, False), (True, True)]
LAYOUT_IDS = ["abs_only", "full_traj", "trajcontrol"]


def is_gauge(name: str, tensor) -> bool:
    """A conv bias right ahead of a GroupNorm of one channel per group (the
    8-channel blocks at mid_dim 64: 8 channels, 8 groups): the norm removes
    any shift of that channel, so its gradient is exactly 0 and each
    package computes rounding noise."""
    return name.endswith("block.0.bias") and tensor.shape[0] == 8


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _unflatten(flat: dict) -> dict:
    tree = {}
    for key, v in flat.items():
        node = tree
        *scopes, leaf = key.split("/")
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = v
    return tree


@functools.cache
def bodies():
    jbody = jax_synthetic_model(num_verts=64, seed=3)
    return jbody, body_model_from_jax(jbody, "cpu")


@functools.cache
def flax_params(trajcontrol: bool, abs_only: bool, wake: bool = True, seed: int = 1) -> dict:
    """Flax TrajNet params (numpy). wake: every all-zero tensor (the zero
    convs, the zero-initialised biases) gets small random values, so no
    gradient is a zero compared against a zero."""
    d = 13 if abs_only else 22
    torch.manual_seed(seed)
    port = TrajNet(traj_feat_dim=d, cond_dim=d, mid_dim=MID, trajcontrol=trajcontrol)
    rng = np.random.default_rng(seed)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    if wake:
        sd = {k: (0.05 * rng.standard_normal(v.shape)).astype(np.float32) if not v.any() else v
              for k, v in sd.items()}
    params = _unflatten(convert_trajnet(sd, trajcontrol=trajcontrol))
    z = np.zeros((1, T, d), np.float32)
    kw = {"control_cond": np.zeros((1, T, 272), np.float32)} if trajcontrol else {}
    flax = FlaxTrajNet(traj_feat_dim=d, cond_dim=d, mid_dim=MID, trajcontrol=trajcontrol)
    expected = jax.eval_shape(flax.init, jax.random.PRNGKey(0), z, z, np.zeros(1, np.int32), **kw)
    assert jax.tree.map(np.shape, expected) == jax.tree.map(np.shape, params)
    return params


def port_model(params: dict, trajcontrol: bool, abs_only: bool) -> TrajNet:
    d = 13 if abs_only else 22
    port = TrajNet(traj_feat_dim=d, cond_dim=d, mid_dim=MID, trajcontrol=trajcontrol)
    port.load_state_dict(trajnet_state_dict(params, trajcontrol=trajcontrol))
    return port


def traj_of(full: np.ndarray, abs_only: bool) -> np.ndarray:
    return full[..., TRAJ_ABS_INDEX] if abs_only else full[..., :22]


def draws(step: int, trajcontrol: bool, abs_only: bool):
    """A batch (clean repr, noisy traj cond, control_cond for TrajControl),
    timesteps and q_sample noise for one step."""
    clean, noisy, _, _ = repr_batch(20 + step, B, T)
    batch = {"motion_repr_clean": clean, "cond": traj_of(noisy, abs_only)}
    if trajcontrol:
        batch["control_cond"] = clean[..., 22:]
    rng = np.random.default_rng(step)
    t = rng.integers(0, STEPS, B)
    noise = rng.standard_normal((B, T, 13 if abs_only else 22)).astype(np.float32)
    return batch, t, noise


def stats():
    _, _, mean, std = repr_batch(0, B, T)
    return mean, std


@functools.cache
def jax_grads_fn(trajcontrol: bool, abs_only: bool):
    mean, std = stats()
    d = 13 if abs_only else 22
    model = FlaxTrajNet(traj_feat_dim=d, cond_dim=d, mid_dim=MID, trajcontrol=trajcontrol)
    fn = jax_make_grads_fn(model, jax_make_schedule("cosine", STEPS), jnp.asarray(mean), jnp.asarray(std),
                           bodies()[0], WEIGHTS, abs_only, d)
    return jax.jit(fn)


def port_grads_fn(port: TrajNet, abs_only: bool):
    mean, std = stats()
    return make_trajnet_grads_fn(port, make_schedule("cosine", STEPS), _t(mean), _t(std), bodies()[1], WEIGHTS,
                                 abs_only, 13 if abs_only else 22)


def run_both(trajcontrol, abs_only, params, port, fn, step: int = 0):
    batch, t, noise = draws(step, trajcontrol, abs_only)
    g_j, l_j = jax_grads_fn(trajcontrol, abs_only)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch), jnp.asarray(t), jnp.asarray(noise))
    g_t, l_t = fn(port, {k: _t(v) for k, v in batch.items()}, torch.from_numpy(t).long(), _t(noise))
    return (g_j, l_j), (g_t, l_t)


# ---------------------------------------------------------------------------
# the infill curriculum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bs, clip_len, ratio", [(4, 144, 0.1), (64, 144, 0.1), (3, 16, 0.5)])
def test_traj_infill_mask_same_draws(bs, clip_len, ratio):
    """The same numpy seed gives the same [bs, T] mask, and leaves the
    generator at the same place (starts, then lengths)."""
    ra, rb = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        np.testing.assert_array_equal(tm.traj_infill_mask(ra, bs, clip_len, ratio),
                                      jm.traj_infill_mask(rb, bs, clip_len, ratio))
    assert ra.uniform() == rb.uniform()


@pytest.mark.parametrize("epoch, start", [(0, 10**20), (0, 0), (3, 2), (1, 2)])
def test_loop_infill_draw_order(epoch, start):
    """TrainLoopTrajNet.step_batch draws as the JAX loop's epoch body does
    (rohm_tpu/train/loop.py:172-176): no numpy draw before
    start_infill_epoch, then a uniform and, past 1 - mask_prob, the mask,
    which multiplies the condition; control_cond only for TrajControl."""
    clean, noisy, _, _ = repr_batch(5, 64, 144)
    batch = {"motion_repr_clean": clean, "cond": traj_of(noisy, True), "control_cond": clean[..., 22:]}
    for trajcontrol in (False, True):
        stub = SimpleNamespace(rng=np.random.default_rng(11), start_infill_epoch=start, mask_prob=0.4,
                               max_infill_ratio=0.1, trajcontrol=trajcontrol,
                               _to_device=lambda a: torch.as_tensor(np.asarray(a, np.float32)))
        ref_rng, ref_cond = np.random.default_rng(11), batch["cond"]
        for _ in range(6):
            got = TrainLoopTrajNet.step_batch(stub, dict(batch), epoch)
            want = ref_cond
            if epoch >= start and ref_rng.uniform() > 1 - 0.4:
                want = ref_cond * jm.traj_infill_mask(ref_rng, 64, 144, 0.1)[..., None]
            np.testing.assert_array_equal(got["cond"].numpy(), want)
            assert sorted(got) == sorted(["motion_repr_clean", "cond"] + (["control_cond"] if trajcontrol else []))
        assert stub.rng.uniform() == ref_rng.uniform()


# ---------------------------------------------------------------------------
# losses, gradients, AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("abs_only", [True, False], ids=["abs_only", "full_traj"])
def test_trajnet_losses_match_jax(abs_only):
    """Every key, relative 1e-5 (f32 both sides through the same decoders
    and SMPL-X FK; measured <= 4.9e-7), and the three rel-traj terms 0 in
    abs-only mode."""
    clean, noisy, mean, std = repr_batch(3, B, T)
    out = traj_of(noisy, abs_only)
    jbody, tbody = bodies()
    ref = jax_trajnet_losses(jnp.asarray(out), jnp.asarray(clean), jnp.asarray(mean), jnp.asarray(std), jbody,
                             WEIGHTS, abs_only)
    got = trajnet_losses(_t(out), _t(clean), _t(mean), _t(std), tbody, WEIGHTS, abs_only)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, atol=1e-8, err_msg=k)
    rel = ("loss_root_pos_global_from_rel_traj", "loss_root_vel_global_from_rel_traj",
           "loss_root_smooth_from_rel_traj")
    assert all((float(got[k]) == 0.0) == abs_only for k in rel)


@pytest.mark.parametrize("trajcontrol, abs_only", LAYOUTS, ids=LAYOUT_IDS)
def test_grads_fn_matches_jax(trajcontrol, abs_only):
    """Every per-term loss (relative 1e-5; measured <= 1.2e-6) and every
    parameter gradient within 1e-4 of the largest entry of its tensor
    (f32 convolutions, GroupNorm and Mish backward in another summation
    order; measured <= 1e-5), with the zero-initialised parameters woken
    so the branch's gradients are not zeros against zeros. The gauge
    biases (is_gauge) are noise on both sides, each held below 1e-5 of its
    conv weight's largest gradient entry (measured <= 7e-7)."""
    params = flax_params(trajcontrol, abs_only)
    port = port_model(params, trajcontrol, abs_only)
    (g_j, l_j), (g_t, l_t) = run_both(trajcontrol, abs_only, params, port, port_grads_fn(port, abs_only))
    assert sorted(l_t) == sorted(l_j)
    for k in l_j:
        np.testing.assert_allclose(float(l_t[k]), float(l_j[k]), rtol=1e-5, atol=1e-8, err_msg=k)
    ref = trajnet_state_dict(jax.tree.map(np.asarray, g_j), trajcontrol=trajcontrol)
    assert sorted(ref) == sorted(g_t)
    for name, got in g_t.items():
        r = ref[name].numpy()
        if is_gauge(name, r):
            scale = np.abs(ref[name.replace(".bias", ".weight")].numpy()).max()
            assert max(np.abs(r).max(), got.abs().max().item()) <= 1e-5 * scale, name
            continue
        err = np.abs(got.numpy() - r).max()
        assert np.abs(r).max() > 0, name
        assert err <= 1e-4 * np.abs(r).max(), f"{name}: {err} vs max {np.abs(r).max()}"


@pytest.mark.parametrize("trajcontrol", [False, True], ids=["plain", "trajcontrol"])
def test_three_adamw_steps_match_jax(trajcontrol):
    """optax.adamw(lr, weight_decay=0.01) against torch.optim.AdamW, three
    steps from the same draws; with TrajControl, create_train_state(
    frozen_mask=trajcontrol_frozen_mask(...)) against the port's freeze.
    Adam's update is ~lr per step whatever the gradient's size, so the
    trainable parameters agree to a small fraction of 3 lr = 3e-4 (gate
    3e-6 absolute; measured <= 5.1e-7) and each moved; the frozen ones are
    bit for bit their start, on both sides. Adam's first step is +-lr for
    any gradient that is not exactly 0, so an element whose first gradient
    is rounding noise (nonzero, at most 1e-6 of its tensor's largest entry
    on either side: the gauge biases of is_gauge, and 3-4 weights whose
    terms nearly cancel; one of them, in controlnet.control_downsample4,
    ends 1.4e-4 from the JAX value)
    steps in a direction the noise picks: those elements are held to
    2 x 3 lr, as tests/test_torch_train_grads.py holds the key bias."""
    lr, wd = 1e-4, 0.01
    params = flax_params(trajcontrol, True)
    mask = jax_frozen_mask(params) if trajcontrol else None
    state_j = jax_create_train_state(jax.tree.map(jnp.asarray, params), lr, wd, frozen_mask=mask)
    port = port_model(params, trajcontrol, True)
    trainable = trajcontrol_frozen_mask(port) if trajcontrol else None
    state_t = create_train_state(port, lr, wd, trainable=trainable)
    fn = port_grads_fn(port, True)
    for step in range(3):
        (g_j, _), (g_t, _) = run_both(trajcontrol, True, state_j.params, port, fn, step=step)
        if step == 0:  # the elements whose first gradient is noise
            g0 = trajnet_state_dict(jax.tree.map(np.asarray, g_j), trajcontrol=trajcontrol)
            noise = {}
            for name, g in g_t.items():
                mag = np.maximum(np.abs(g0[name].numpy()), np.abs(g.numpy()))
                noise[name] = (mag > 0) & (mag <= 1e-6 * np.abs(g0[name].numpy()).max())
                if is_gauge(name, g):
                    noise[name][:] = True
        state_j = state_j.apply_gradients(g_j)
        state_t.apply_gradients()
        assert all(trainable is None or trainable[n] for n in g_t)  # no gradient for a frozen tensor
    assert state_t.step == 3 and int(state_j.step) == 3
    ref = trajnet_state_dict(jax.tree.map(np.asarray, state_j.params), trajcontrol=trajcontrol)
    start = trajnet_state_dict(params, trajcontrol=trajcontrol)
    frozen = 0
    for name, prm in port.named_parameters():
        got, want = prm.detach().numpy(), ref[name].numpy()
        if trainable is not None and not trainable[name]:
            frozen += 1
            np.testing.assert_array_equal(got, start[name].numpy(), err_msg=name)
            np.testing.assert_array_equal(want, start[name].numpy(), err_msg=name)
            assert not prm.requires_grad
            continue
        assert np.abs(got - start[name].numpy()).max() > 1e-4, name  # moved
        assert is_gauge(name, got) or noise[name].mean() < 1e-3, name
        err = np.abs(got - want)
        assert err[~noise[name]].max(initial=0) <= 3e-6, f"{name}: {err[~noise[name]].max()}"
        assert err.max() <= 6 * lr, f"{name}: {err.max()}"
    assert frozen == (184 if trajcontrol else 0)
    assert len(state_t.optimizer.state) == (84 if trajcontrol else 184)  # moments for the trainable only


def test_frozen_mask_matches_jax():
    """The port's mask marks the same tensors as the JAX package's."""
    params = flax_params(True, True)
    jmask = trajnet_state_dict(jax.tree.map(lambda m, p: np.full(np.shape(p), m, np.float32),
                                            jax_frozen_mask(params), params), trajcontrol=True)
    tmask = trajcontrol_frozen_mask(port_model(params, True, True))
    assert sorted(jmask) == sorted(tmask)
    for name, m in tmask.items():
        assert bool(jmask[name].reshape(-1)[0]) == m, name


# ---------------------------------------------------------------------------
# the graft and the sampler
# ---------------------------------------------------------------------------


def test_bootstrap_trajcontrol_matches_jax():
    """The port's graft of a converted backbone equals the JAX graft,
    converted, exactly; the zero convs stay zero."""
    backbone = flax_params(False, True, wake=False, seed=4)
    control = flax_params(True, True, wake=False, seed=5)
    ref = trajnet_state_dict(jax.tree.map(np.asarray, jax_bootstrap(control, backbone)), trajcontrol=True)
    got = bootstrap_trajcontrol(trajnet_state_dict(control, trajcontrol=True),
                                trajnet_state_dict(backbone, trajcontrol=False))
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert torch.equal(got[name], ref[name]), name
    b = trajnet_state_dict(backbone)
    assert torch.equal(got["controlnet.control_mid_block2.blocks.1.block.2.weight"],
                       b["diff_mid_block2.blocks.1.block.2.weight"])
    assert all(not v.any() for k, v in got.items() if "zero_conv" in k)
    assert not torch.equal(got["controlnet.control_enc1.blocks.0.block.0.weight"],
                           trajnet_state_dict(control, trajcontrol=True)["controlnet.control_enc1.blocks.0.block.0.weight"])


@pytest.mark.parametrize("trajcontrol", [False, True], ids=["plain", "trajcontrol"])
def test_sampler_replay_matches_jax(trajcontrol):
    """make_trajnet_sampler with replayed x_T and per-step noise against
    the JAX reverse chain over the same flax model (what its
    make_trajnet_sampler scans): 5 cosine steps of an f32 U-Net on both
    sides, the gate of tests/test_torch_pipeline.py's TrajNet chain."""
    params = flax_params(trajcontrol, True)
    port = port_model(params, trajcontrol, True)
    rng = np.random.default_rng(9)
    clean, noisy, _, _ = repr_batch(6, B, T)
    cond = traj_of(noisy, True)
    cc = clean[..., 22:] if trajcontrol else None
    noise = rng.standard_normal((B, T, 13)).astype(np.float32)
    step_noise = rng.standard_normal((5, B, T, 13)).astype(np.float32)
    flax = FlaxTrajNet(traj_feat_dim=13, cond_dim=13, mid_dim=MID, trajcontrol=trajcontrol)
    jcc = None if cc is None else jnp.asarray(cc)
    ref = jax.jit(lambda n, sn: jax_p_sample_loop(
        lambda x, t: flax.apply(params, x, jnp.asarray(cond), t, control_cond=jcc),
        jax_make_schedule("cosine", 5), (B, T, 13), jax.random.PRNGKey(0), noise=n, step_noise=sn,
    ))(noise, step_noise)
    sample = make_trajnet_sampler(port, make_schedule("cosine", 5), 13)
    out = sample(_t(cond), torch.Generator().manual_seed(0), None if cc is None else _t(cc),
                 noise=_t(noise), step_noise=_t(step_noise))
    assert out.shape == (B, T, 13)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-4)
