"""The port's attention at sequence lengths past the limits its CUDA kernels
once had (every key of a sequence in shared memory: S <= 160 for the
training kernels, 166 for the f32 attention, 176 for the bf16 and int8
attention), against the JAX package on the CPU, where the port's wrappers
take their plain versions.

The same numpy inputs from a seed go through both packages at S = 161, 209
and 300 with small widths (2 sequences, 2 heads, dh = 32): K1's f32 layer
against its Pallas kernel in interpret mode, `attention_bf16` (K2/K3),
K4's `attention_int8` (codes bit-exact), and the training layer's forward
and backward (K6/K7, Pallas in interpret mode) in both modes. The kernels'
key tiles run on the card: tests/test_torch_cuda.py and `python3
chip_smoke.py` hold them against these plain versions at the same lengths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ops_int8qa import _jax_codes

from rohm_tpu.models.blocks import TransformerEncoderLayer as FlaxLayer
from rohm_tpu.ops import kernel_common as jkc
from rohm_tpu.ops import transformer_layer as j32
from rohm_tpu.ops import transformer_layer_int8 as ji8
from rohm_tpu.ops import transformer_layer_train as jt
from rohm_tpu_torch.models.blocks import TransformerEncoderLayer
from rohm_tpu_torch.ops import kernel_common as kc
from rohm_tpu_torch.ops import transformer_layer as l32
from rohm_tpu_torch.ops import transformer_layer_int8 as l8
from rohm_tpu_torch.ops import transformer_layer_train as lt

torch.set_num_threads(1)

B, D, H, FF = 2, 64, 2, 128  # dh = 32
LONG_S = [161, 209, 300]
BF16_ULP = 2.0 ** -7


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _layers(seed: int):
    """A flax encoder layer (random nonzero biases) and its port twin."""
    rng = np.random.default_rng(seed)
    x0 = np.zeros((1, 4, D), np.float32)
    params = jax.tree.map(np.asarray, jax.jit(FlaxLayer(D, H, FF, dropout=0.0).init)(
        jax.random.PRNGKey(seed), x0))["params"]
    params = jax.tree.map(
        lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32) if not a.any() else a, params)
    attn = params["MultiHeadDotProductAttention_0"]
    sd = {
        "self_attn.in_proj_weight": torch.cat([_t(attn[n]["kernel"].reshape(D, D).T) for n in ("query", "key", "value")]),
        "self_attn.in_proj_bias": torch.cat([_t(attn[n]["bias"].reshape(D)) for n in ("query", "key", "value")]),
        "self_attn.out_proj.weight": _t(attn["out"]["kernel"].reshape(D, D).T),
        "self_attn.out_proj.bias": _t(attn["out"]["bias"]),
        "norm1.weight": _t(params["LayerNorm_0"]["scale"]), "norm1.bias": _t(params["LayerNorm_0"]["bias"]),
        "linear1.weight": _t(params["Dense_0"]["kernel"].T), "linear1.bias": _t(params["Dense_0"]["bias"]),
        "linear2.weight": _t(params["Dense_1"]["kernel"].T), "linear2.bias": _t(params["Dense_1"]["bias"]),
        "norm2.weight": _t(params["LayerNorm_1"]["scale"]), "norm2.bias": _t(params["LayerNorm_1"]["bias"]),
    }
    layer = TransformerEncoderLayer(D, H, FF)
    layer.load_state_dict(sd)
    return params, layer


@pytest.mark.parametrize("s", LONG_S)
def test_f32_layer_long_s(s):
    """K1: the f32 layer (its attention included) against the Pallas kernel
    in interpret mode. f32 both sides, the same two-pass LayerNorm and erf
    polynomial; only summation order differs: the f32 layer test's gate
    (tests/test_torch_ops_f32.py), 2e-5 absolute and 1e-5 relative."""
    params, layer = _layers(1)
    x = np.random.default_rng(s).standard_normal((B, s, D)).astype(np.float32)
    ref = j32.fused_encoder_layer(jnp.asarray(x), params, num_heads=H, interpret=True)
    out = l32.fused_encoder_layer(_t(x), layer, H)
    assert out.shape == (B, s, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("s", LONG_S)
def test_attention_bf16_long_s(s):
    """K2/K3's attention: f32 scores and softmax summed in another order
    may flip one bf16 rounding of a prob (<= 2^-8 p), moving the output by
    <= 2^-8 max|v| (sum p = 1), plus the output's own bf16 rounding: 2^-6
    max|v| bounds both (tests/test_torch_ops.py)."""
    rng = np.random.default_rng(s + 1)
    qkv = jnp.asarray(rng.standard_normal((B * s, 3 * D)), jnp.bfloat16)
    ref = jkc.attention_bf16(qkv[:, :D], qkv[:, D: 2 * D], qkv[:, 2 * D:], B, s, H)
    out = kc.attention_bf16_plain(torch.from_numpy(_np(qkv)).to(torch.bfloat16), s, H)
    assert out.dtype == torch.bfloat16 and out.shape == (B * s, D)
    vmax = np.abs(_np(qkv[:, 2 * D:])).max()
    np.testing.assert_allclose(out.float().numpy(), _np(ref), atol=2.0 ** -6 * vmax, rtol=0)


def _attention_int8_against_jax(s: int, d: int, seed: int) -> None:
    """K4's plain version against the JAX attention_int8 on B sequences of
    s rows, width d, H heads: Q, K and V codes bit for bit (the same rounded
    division, product and rint; V's column amax over the whole sequence);
    prob codes within one step, nearly all equal (the f32 softmax sums in
    another order); the output within two prob codes of its column (2
    vmax/127) plus one bf16 ulp (tests/test_torch_ops_int8qa.py)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B * s, 3 * d)) * rng.uniform(0.1, 10, (B * s, 1))
    qkv = jnp.asarray(x, jnp.bfloat16)
    tq = torch.from_numpy(_np(qkv)).to(torch.bfloat16)
    qq, _, kk, _, pi, vv, vmax = l8.attention_int8_codes(tq, s, H)
    ref = _jax_codes(qkv, B, s, H)
    np.testing.assert_array_equal(qq.numpy(), ref["qq"])
    np.testing.assert_array_equal(kk.numpy(), ref["kk"])
    np.testing.assert_array_equal(vv.numpy(), ref["vv"])
    dp = np.abs(pi.numpy() - ref["pi"])
    assert dp.max() <= 1 and (dp == 0).mean() > 0.99, (dp.max(), (dp == 0).mean())
    out = l8.attention_int8_plain(tq, s, H)
    jout = ji8.attention_int8(qkv[:, :d], qkv[:, d: 2 * d], qkv[:, 2 * d:], B, s, H)
    col_vmax = vmax.expand(B, H, s, d // H).transpose(1, 2).reshape(B * s, d).numpy()
    tol = 2 * col_vmax / 127.0 + BF16_ULP * np.abs(_np(jout))
    assert (np.abs(out.float().numpy() - _np(jout)) <= tol).all()


@pytest.mark.parametrize("s", LONG_S)
def test_attention_int8_long_s(s):
    """K4 past its old key tile, at dh = 32 (_attention_int8_against_jax)."""
    _attention_int8_against_jax(s, D, s + 2)


@pytest.mark.parametrize("s", [144, l8.ATTENTION_INT8_HEAD_KEYS, l8.ATTENTION_INT8_HEAD_KEYS + 1])
def test_attention_int8_at_the_one_block_limit(s):
    """K4 at dh = 128, the kernel's head width, at the shipped S = 144, at
    the longest S its one-block-per-(sequence, head) path takes
    (ATTENTION_INT8_HEAD_KEYS) and one past it, where the key-tiled path
    takes over: the plain version the card holds both paths to
    (tests/test_torch_cuda.py, chip_smoke.py) against the JAX package
    (_attention_int8_against_jax)."""
    _attention_int8_against_jax(s, 128 * H, s + 3)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", LONG_S)
def test_training_layer_long_s(s, dtype):
    """K6/K7: the training layer's output and the gradients of sum(y * w)
    in x and in the in-projection (the attention backward's dq, dk, dv
    reach both), dropout 0.25 with the JAX package's masks, against its
    custom-VJP Pallas layer in interpret mode. f32: summation order only,
    2e-5 of each tensor's max; bf16: a bf16 rounding of f32 values that
    differ in their last bits may flip by one ulp, 2e-3 of each tensor's
    max (tests/test_torch_ops_train.py)."""
    p = 0.25
    tree, layer = _layers(2)
    rng = np.random.default_rng(s + 3)
    x = rng.standard_normal((B, s, D)).astype(np.float32)
    w = rng.standard_normal((B, s, D)).astype(np.float32)
    key = jax.random.key_data(jax.random.key(s, impl="rbg"))
    masks = tuple(torch.from_numpy(np.array(m)) for m in jt.gen_dropout_masks(key, B, s, D, FF, H, p))
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def loss(tr, xx):
        y = jt.fused_train_layer(tr, xx, key, num_heads=H, dropout_p=p, dtype=jdtype)
        return jnp.sum(y * w), y

    (_, y_j), (g_tree, gx_j) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    g_j = _leaves(g_tree)
    xt = _t(x).requires_grad_()
    y_t = lt.fused_train_layer(layer, xt, masks, H, p, dtype)
    (y_t * _t(w)).sum().backward()
    dq_t, dk_t, dv_t = (t.reshape(D, H, D // H).numpy() for t in layer.self_attn.in_proj_weight.grad.T.split(D, 1))
    gate = 2e-3 if dtype == "bfloat16" else 2e-5
    pairs = [("y", y_t.detach().numpy(), np.asarray(y_j)), ("dx", xt.grad.numpy(), np.asarray(gx_j))]
    pairs += [(n, got, g_j[f"MultiHeadDotProductAttention_0/{n}/kernel"])
              for n, got in (("query", dq_t), ("key", dk_t), ("value", dv_t))]
    for name, got, ref in pairs:
        err, scale = np.abs(got - ref).max(), np.abs(ref).max()
        assert err <= gate * scale, f"{name}: max err {err} vs max {scale}"
