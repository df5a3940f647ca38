"""The port's models against the JAX package's flax models, on the CPU.

Every test starts from one flax init, moves it into the port through
rohm_tpu_torch.utils.convert_flax, and feeds both sides the same seeded
numpy inputs. Small widths: PoseNet 32d x 2 layers x 2 heads, TrajNet
mid_dim=64 (tests/test_pipeline.py's sizes).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rohm_tpu.models import PoseNet as FlaxPoseNet
from rohm_tpu.models import TrajNet as FlaxTrajNet
from rohm_tpu.ops import posenet_apply_prepared as jax_apply_prepared
from rohm_tpu.ops import prepare_posenet_fused as jax_prepare_bf16
from rohm_tpu.ops import prepare_posenet_int8 as jax_prepare_int8
from rohm_tpu.utils.convert_torch_ckpt import convert_posenet, convert_trajnet
from rohm_tpu_torch.models import PoseNet, TrajNet
from rohm_tpu_torch.ops import posenet_apply_prepared, prepare_posenet_fused, prepare_posenet_int8
from rohm_tpu_torch.utils.convert_flax import _flatten, posenet_state_dict, trajnet_state_dict

torch.set_num_threads(1)

D, FF, LAYERS, HEADS = 32, 64, 2, 2
B, T = 2, 15


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def posenet_setup():
    rng = np.random.default_rng(0)
    model = FlaxPoseNet(latent_dim=D, ff_size=FF, num_layers=LAYERS, num_heads=HEADS)
    x = rng.standard_normal((B, T, 294)).astype(np.float32)
    cond = rng.standard_normal((B, T, 294)).astype(np.float32)
    t = np.array([5, 900], np.int32)
    params = _np_tree(jax.jit(model.init)(jax.random.PRNGKey(0), x, cond, t))
    port = PoseNet(latent_dim=D, ff_size=FF, num_layers=LAYERS, num_heads=HEADS)
    port.load_state_dict(posenet_state_dict(params))
    return model, params, port, x, cond, t


def test_posenet_f32_matches_flax(posenet_setup):
    model, params, port, x, cond, t = posenet_setup
    ref = np.asarray(model.apply(params, x, cond, t))
    out = port(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(t)).numpy()
    # both f32 on the CPU: only summation order differs (XLA vs oneDNN GEMMs)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-5)
    np.testing.assert_array_equal(out[..., :22], cond[..., :22])


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_prepared_weights_bit_exact(posenet_setup, mode):
    """The one-time cast/fuse/quantize gives the JAX package's arrays bit for
    bit (int8 codes and column scales included)."""
    _, params, port, *_ = posenet_setup
    if mode == "bf16":
        jp, tp = jax_prepare_bf16(params, num_layers=LAYERS), prepare_posenet_fused(port)
    else:
        jp, tp = jax_prepare_int8(params, num_layers=LAYERS), prepare_posenet_int8(port)
    for jl, tl in zip(jp["layers"], tp["layers"]):
        assert len(jl) == len(tl)
        for ja, ta in zip(jl, tl):
            np.testing.assert_array_equal(np.asarray(ja.astype(jnp.float32)), ta.float().numpy())
    for k in ("t_w0", "t_b0", "t_w1", "t_b1", "in_w", "in_b", "inc_w", "inc_b", "out_w", "out_b", "pe"):
        np.testing.assert_array_equal(np.asarray(jp[k]), tp[k].numpy())


@pytest.mark.parametrize(
    "mode, atol, mean_tol",
    # The port's plain versions run the JAX kernels' arithmetic, but the f32
    # GEMM sums are taken in another order (oneDNN vs XLA), which flips a few
    # bf16 roundings of activations (bf16 ulp 2^-8 relative) and, in int8
    # mode, a few int8 codes (one step = amax/127 of the row). Both are far
    # inside the kernels' own envelope vs flax (tests/test_ops.py: bf16
    # 6e-2 / 1e-2, int8 0.3 / 5e-2).
    [("bf16", 2e-2, 2e-3), ("int8", 6e-2, 1e-2)],
)
def test_posenet_apply_prepared_matches_jax_interpret(posenet_setup, mode, atol, mean_tol):
    _, params, port, x, cond, t = posenet_setup
    if mode == "bf16":
        jp, tp = jax_prepare_bf16(params, num_layers=LAYERS), prepare_posenet_fused(port)
    else:
        jp, tp = jax_prepare_int8(params, num_layers=LAYERS), prepare_posenet_int8(port)
    ref = np.asarray(jax_apply_prepared(jp, x, cond, jnp.asarray(t), num_heads=HEADS, interpret=True))
    out = posenet_apply_prepared(
        tp, torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(t), num_heads=HEADS
    ).numpy()
    dev = np.abs(out - ref)
    assert dev.max() < atol and dev.mean() < mean_tol, (dev.max(), dev.mean())
    np.testing.assert_array_equal(out[..., :22], cond[..., :22])


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
def _trajnet_setup(trajcontrol: bool):
    """A randomly initialized port TrajNet and the same weights as a flax tree
    through the JAX package's own converter (a flax init would cost a
    ~12 s XLA compile). The tree's structure and shapes are checked against
    the flax model's init (traced, not compiled)."""
    rng = np.random.default_rng(1)
    t_len = 16
    model = FlaxTrajNet(traj_feat_dim=13, cond_dim=13, mid_dim=64, trajcontrol=trajcontrol)
    x = rng.standard_normal((B, t_len, 13)).astype(np.float32)
    cond = rng.standard_normal((B, t_len, 13)).astype(np.float32)
    cc = rng.standard_normal((B, t_len, 272)).astype(np.float32) if trajcontrol else None
    t = np.array([3, 77], np.int32)
    kw = {"control_cond": cc} if trajcontrol else {}

    torch.manual_seed(1)
    port = TrajNet(traj_feat_dim=13, cond_dim=13, mid_dim=64, trajcontrol=trajcontrol)
    with torch.no_grad():
        # the ControlNet's zero convs init to 0, which would hide the branch:
        # give every all-zero tensor small random values
        for p in port.parameters():
            if not p.any():
                p.copy_(torch.from_numpy(0.05 * rng.standard_normal(p.shape)).float())
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params = _unflatten(convert_trajnet(sd, trajcontrol=trajcontrol))
    expected = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, cond, t, **kw)
    assert jax.tree.map(np.shape, expected) == jax.tree.map(np.shape, params)
    return model, params, port, x, cond, cc, t


@pytest.mark.parametrize("trajcontrol", [False, True])
def test_trajnet_matches_flax(trajcontrol):
    model, params, port, x, cond, cc, t = _trajnet_setup(trajcontrol)
    kw = {"control_cond": cc} if trajcontrol else {}
    ref = np.asarray(jax.jit(model.apply)(params, x, cond, t, **kw))
    tkw = {"control_cond": torch.from_numpy(cc)} if trajcontrol else {}
    out = port(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(t), **tkw).numpy()
    # f32 convolutions on both sides; differences are summation order and
    # flax GroupNorm's one-pass variance vs torch's two-pass (~1e-6 relative
    # per layer over ~30 conv layers)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_trajnet_rejects_bad_length():
    port = TrajNet(traj_feat_dim=13, cond_dim=13, mid_dim=64)
    with pytest.raises(ValueError, match="divisible by 16"):
        port(torch.zeros(1, 15, 13), torch.zeros(1, 15, 13), 3)


def _assert_tree_equal(flat_ref: dict, flat_back: dict):
    assert set(flat_ref) == set(flat_back)
    for k, v in flat_ref.items():
        np.testing.assert_array_equal(flat_back[k], v, err_msg=k)


@pytest.mark.parametrize("model_name", ["posenet", "trajnet", "trajcontrol"])
def test_flax_torch_flax_roundtrip_bit_exact(posenet_setup, model_name):
    """flax -> port state_dict -> rohm_tpu.utils.convert_torch_ckpt -> flax is
    the identity: the port's names are the reference checkpoint's names."""
    if model_name == "posenet":
        params = posenet_setup[1]
        sd = {k: v.numpy() for k, v in posenet_state_dict(params).items()}
        back = convert_posenet(sd, num_layers=LAYERS, num_heads=HEADS, latent_dim=D)
    else:
        trajcontrol = model_name == "trajcontrol"
        params = _trajnet_setup(trajcontrol)[1]
        sd = {k: v.numpy() for k, v in trajnet_state_dict(params, trajcontrol=trajcontrol).items()}
        back = convert_trajnet(sd, trajcontrol=trajcontrol)
    _assert_tree_equal(_flatten(params), back)
