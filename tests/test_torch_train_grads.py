"""One PoseNet training step of the port against the JAX package, on the
CPU: `make_posenet_grads_fn` (q_sample -> train-mode forward -> losses
through SMPL-X -> gradients) for fused_train "", "float32" and "bfloat16",
with the skating gate on and off, and three AdamW steps.

Both packages get the same flax params (converted for the port), the same
batch, timesteps and q_sample noise from numpy, at dropout 0 (torch cannot
draw the JAX package's dropout masks; the layer tests hand masks across).
The JAX fused paths run their Pallas kernels in interpret mode; each JAX
grads function is jitted once per mode and shared by the tests."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import WEIGHTS, repr_batch

from rohm_tpu.body import synthetic_model as jax_synthetic_model
from rohm_tpu.diffusion import make_schedule as jax_make_schedule
from rohm_tpu.models.posenet import PoseNet as FlaxPoseNet
from rohm_tpu.train import create_train_state as jax_create_train_state
from rohm_tpu.train import make_posenet_grads_fn as jax_make_grads_fn
from rohm_tpu_torch.diffusion import make_schedule
from rohm_tpu_torch.models import PoseNet
from rohm_tpu_torch.train.state import create_train_state
from rohm_tpu_torch.train.steps import make_posenet_grads_fn
from rohm_tpu_torch.utils.convert_flax import body_model_from_jax, posenet_state_dict

torch.set_num_threads(1)

B, T, D, F, H, LAYERS = 2, 12, 32, 64, 4, 2
MODES = ["", "float32", "bfloat16"]


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@functools.cache
def setup():
    model = FlaxPoseNet(latent_dim=D, ff_size=F, num_layers=LAYERS, num_heads=H, dropout=0.0)
    rng = np.random.default_rng(0)
    z = np.zeros((1, T, 294), np.float32)
    params = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), z, z, np.zeros(1, np.int32)))
    params = jax.tree.map(  # wake the zero-initialised biases
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32) if not a.any() else a, params)
    jbody = jax_synthetic_model(num_verts=64, seed=3)
    return model, params, jbody, body_model_from_jax(jbody, "cpu")


@functools.cache
def jax_grads_fn(mode: str):
    model, _, jbody, _ = setup()
    clean, _, mean, std = repr_batch(0, B, T)
    fn = jax_make_grads_fn(model, jax_make_schedule("cosine", 1000), jnp.asarray(mean), jnp.asarray(std),
                           jbody, WEIGHTS, fused_train=mode or None)
    return jax.jit(fn)


def _draws(step: int):
    """A batch (clean, masked noisy cond), timesteps and noise for one step."""
    clean, out, _, _ = repr_batch(10 + step, B, T)
    rng = np.random.default_rng(step)
    cond = out * (rng.random((B, T, 294)) > 0.2)
    t = rng.integers(0, 1000, B)
    noise = rng.standard_normal((B, T, 294)).astype(np.float32)
    return {"motion_repr_clean": clean, "cond": cond.astype(np.float32)}, t, noise


def _port(mode: str):
    model, params, _, tbody = setup()
    port = PoseNet(latent_dim=D, ff_size=F, num_layers=LAYERS, num_heads=H, dropout=0.0)
    port.load_state_dict(posenet_state_dict(params, num_layers=LAYERS))
    _, _, mean, std = repr_batch(0, B, T)
    fn = make_posenet_grads_fn(port, make_schedule("cosine", 1000), _t(mean), _t(std), tbody, WEIGHTS, mode)
    return port, fn


def _run_both(mode: str, skating: bool, params=None, port=None, fn=None, step: int = 0):
    batch, t, noise = _draws(step)
    _, p0, _, _ = setup()
    g_j, l_j = jax_grads_fn(mode)(
        jax.tree.map(jnp.asarray, p0 if params is None else params),
        jax.tree.map(jnp.asarray, batch), jnp.asarray(t), jnp.asarray(noise),
        jax.random.key(1, impl="rbg"), jnp.asarray(float(skating)))
    if port is None:
        port, fn = _port(mode)
    masks = (None, [(torch.ones(B, H, T + 1, T + 1, dtype=torch.int8), torch.ones(B, T + 1, D, dtype=torch.int8),
                     torch.ones(B, T + 1, F, dtype=torch.int8), torch.ones(B, T + 1, D, dtype=torch.int8))] * LAYERS)
    g_t, l_t = fn(port, {k: _t(v) for k, v in batch.items()}, torch.from_numpy(t).long(), _t(noise), masks,
                  torch.tensor(float(skating)))
    return (g_j, l_j), (g_t, l_t), port


# gradient gates, as a fraction of each gradient tensor's largest entry:
# the f32 paths sum in another order (measured <= 9.3e-6); the bf16 path
# flips an occasional bf16 rounding of an f32 operand that differs in its
# last bits (measured <= 3.5e-3), below the bf16-vs-f32 gap of the JAX
# package (>= 2.8e-2 on every encoder tensor)
GRAD_GATE = {"": 1e-4, "float32": 1e-4, "bfloat16": 1e-2}


@pytest.mark.parametrize("skating", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_grads_fn_matches_jax(mode, skating):
    """Every per-term loss (relative 1e-5 in f32, 1e-3 in bf16; measured
    <= 7e-6 in all three modes) and every parameter gradient, converted to
    the port's layout."""
    (g_j, l_j), (g_t, l_t), _ = _run_both(mode, skating)
    assert sorted(l_t) == sorted(l_j)
    rtol = 1e-3 if mode == "bfloat16" else 1e-5
    for k in l_j:
        np.testing.assert_allclose(float(l_t[k]), float(l_j[k]), rtol=rtol, atol=1e-7, err_msg=k)
    ref = posenet_state_dict(jax.tree.map(np.asarray, g_j), num_layers=LAYERS)
    assert sorted(ref) == sorted(g_t)
    for name, got in g_t.items():
        r = ref[name].numpy()
        err = np.abs(got.numpy() - r).max()
        assert err <= GRAD_GATE[mode] * np.abs(r).max() + 1e-7, f"{name}: {err} vs max {np.abs(r).max()}"


@pytest.mark.parametrize("mode", ["", "float32"])
def test_three_adamw_steps_match_jax(mode):
    """optax.adamw(lr, weight_decay) against torch.optim.AdamW with b1, b2,
    eps and the decay passed explicitly: three steps from the same draws,
    weight decay 0.01 so the decoupled decay counts. Adam's update is
    ~lr per step whatever the gradient's size, so the parameters agree to
    a small fraction of 3 lr = 3e-4 (gate 3e-6 absolute). One slice is
    the exception: the key bias has an exactly zero gradient (a row of
    scores shifts by q.b_k, which the softmax ignores), so each package
    sees only rounding noise, which Adam scales to +-lr per step in either
    direction; it is held to 2 x 3 lr."""
    lr, wd = 1e-4, 0.01
    _, params, _, _ = setup()
    state_j = jax_create_train_state(jax.tree.map(jnp.asarray, params), lr, wd)
    port, fn = _port(mode)
    state_t = create_train_state(port, lr, wd)
    for step in range(3):
        (g_j, _), _, _ = _run_both(mode, True, params=state_j.params, port=port, fn=fn, step=step)
        state_j = state_j.apply_gradients(g_j)
        state_t.apply_gradients()
    assert state_t.step == 3 and int(state_j.step) == 3
    ref = posenet_state_dict(jax.tree.map(np.asarray, state_j.params), num_layers=LAYERS)
    start = posenet_state_dict(params, num_layers=LAYERS)
    for name, prm in port.named_parameters():
        got, want = prm.detach().numpy(), ref[name].numpy()
        assert np.abs(got - start[name].numpy()).max() > 1e-4  # every tensor moved
        if name.endswith("in_proj_bias"):
            key = slice(D, 2 * D)
            np.testing.assert_allclose(got[key], want[key], atol=6 * lr, rtol=0, err_msg=name)
            got, want = np.delete(got, np.r_[key]), np.delete(want, np.r_[key])
        np.testing.assert_allclose(got, want, atol=3e-6, rtol=0, err_msg=name)
