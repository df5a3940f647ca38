"""The plain versions of the port's CUDA kernels against the JAX code they
replace, on the CPU (the JAX Pallas layers run in interpret mode).

The CUDA kernels themselves run only on the card; `python3 chip_smoke.py`
holds each against these plain versions there. The last test here does the
same at a small size and skips without a CUDA device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rohm_tpu.models.blocks import TransformerEncoderLayer as FlaxLayer
from rohm_tpu.ops import kernel_common as jkc
from rohm_tpu.ops import transformer_layer_int8 as ji8
from rohm_tpu.ops.transformer_layer_bf16 import fused_encoder_layer_bf16 as jax_layer_bf16
from rohm_tpu.ops.transformer_layer_bf16 import prepare_layer_bf16 as jax_prepare_bf16
from rohm_tpu.ops.transformer_layer_int8 import fused_encoder_layer_int8 as jax_layer_int8
from rohm_tpu.ops.transformer_layer_int8 import prepare_layer_int8 as jax_prepare_int8
from rohm_tpu_torch.models.blocks import TransformerEncoderLayer
from rohm_tpu_torch.ops import kernel_common as kc
from rohm_tpu_torch.ops import transformer_layer_bf16 as l16
from rohm_tpu_torch.ops import transformer_layer_int8 as l8

torch.set_num_threads(1)

D, H, FF = 32, 2, 64
B, S = 2, 16


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


@pytest.fixture(scope="module")
def layer_setup():
    """One flax encoder layer and its port twin with the same weights."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    params = jax.tree.map(
        np.asarray, jax.jit(FlaxLayer(D, H, FF, dropout=0.0).init)(jax.random.PRNGKey(0), x)
    )["params"]
    # small random biases: flax inits them to zero, which would hide bias bugs
    params = jax.tree.map(
        lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32) if not a.any() else a,
        params,
    )
    layer = TransformerEncoderLayer(D, H, FF)
    attn = params["MultiHeadDotProductAttention_0"]
    sd = {
        "self_attn.in_proj_weight": torch.cat(
            [_t(attn[n]["kernel"].reshape(D, D).T) for n in ("query", "key", "value")]),
        "self_attn.in_proj_bias": torch.cat(
            [_t(attn[n]["bias"].reshape(D)) for n in ("query", "key", "value")]),
        "self_attn.out_proj.weight": _t(attn["out"]["kernel"].reshape(D, D).T),
        "self_attn.out_proj.bias": _t(attn["out"]["bias"]),
        "norm1.weight": _t(params["LayerNorm_0"]["scale"]), "norm1.bias": _t(params["LayerNorm_0"]["bias"]),
        "linear1.weight": _t(params["Dense_0"]["kernel"].T), "linear1.bias": _t(params["Dense_0"]["bias"]),
        "linear2.weight": _t(params["Dense_1"]["kernel"].T), "linear2.bias": _t(params["Dense_1"]["bias"]),
        "norm2.weight": _t(params["LayerNorm_1"]["scale"]), "norm2.bias": _t(params["LayerNorm_1"]["bias"]),
    }
    layer.load_state_dict(sd)
    return params, layer, x


# ---------------------------------------------------------------------------
# int8 quantization: bit-exact
# ---------------------------------------------------------------------------


def _quant_inputs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 96)).astype(np.float32) * rng.uniform(0.01, 30, (64, 1)).astype(np.float32)
    # rows whose scaled values land exactly on .5: amax 127 -> scale 1, so
    # k + 0.5 must round half to even (roundf would round away from zero)
    x[0] = np.arange(96) - 47.5
    x[0, 0] = 127.0
    x[1] = 0.0  # all-zero row: amax clamps to 1e-12
    return x


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quant_rows_bit_exact(dtype):
    x = _quant_inputs()
    jx = jnp.asarray(x) if dtype == "f32" else jnp.asarray(x).astype(jnp.bfloat16)
    q_ref, s_ref = ji8._quant_rows(jx)
    tx = _t(x) if dtype == "f32" else _t(x, torch.bfloat16)
    q, s = l8.quant_rows_int8_plain(tx)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref)[:, 0])
    np.testing.assert_array_equal(q[0, 1:5].numpy(), [-46, -46, -44, -44])  # half to even


def test_quant_cols_bit_exact():
    w = _quant_inputs().T.copy()
    q_ref, s_ref = ji8._quant_cols(jnp.asarray(w))
    q, s = l8._quant_cols(_t(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


@pytest.mark.parametrize("mode", ["bf16", "f32", "gelu"])
def test_dot_i8_epilogues(mode):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((40, 64)).astype(np.float32)
    w = rng.standard_normal((64, 96)).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32)
    qx, rs = ji8._quant_rows(jnp.asarray(x))
    wq, cs = ji8._quant_cols(jnp.asarray(w))
    ref = ji8._dot_i8(qx, rs, wq, cs) + bias
    if mode == "bf16":
        ref = ref.astype(jnp.bfloat16)
    elif mode == "gelu":
        ref = jkc.gelu_tanh(ref)
    out = l8.gemm_int8_plain(
        torch.tensor(np.asarray(qx)), _t(rs[:, 0]), torch.tensor(np.asarray(wq)), _t(cs),
        _t(bias), mode,
    )
    if mode == "gelu":
        # tanh differs between XLA's and torch's CPU implementations by ulps
        np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-6, atol=1e-6)
    else:
        # exact int32 sums, then the same rounded steps in the same order
        np.testing.assert_array_equal(out.float().numpy(), _np(ref))


# ---------------------------------------------------------------------------
# bf16 pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["qkv", "f32", "gelu"])
def test_gemm_bf16_epilogues(mode):
    rng = np.random.default_rng(3)
    a = jnp.asarray(rng.standard_normal((40, 64)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((64, 96)), jnp.bfloat16)
    bias = jnp.asarray(rng.standard_normal(96), jnp.bfloat16 if mode == "qkv" else jnp.float32)
    acc = jnp.dot(a, w, preferred_element_type=jnp.float32)
    ref = {
        "qkv": lambda: acc.astype(jnp.bfloat16) + bias,
        "f32": lambda: acc + bias,
        "gelu": lambda: jkc.gelu_tanh(acc + bias).astype(jnp.bfloat16),
    }[mode]()
    out = l16.gemm_bf16_plain(
        _t(_np(a), torch.bfloat16), _t(_np(w), torch.bfloat16),
        _t(_np(bias), torch.bfloat16 if mode == "qkv" else torch.float32), mode,
    )
    assert out.dtype == (torch.float32 if mode == "f32" else torch.bfloat16)
    # bf16 x bf16 products are exact in f32; only the f32 summation order
    # differs, which can flip one bf16 rounding of the output
    tol = 2.0 ** -7 * (np.abs(_np(ref)) + np.abs(_np(bias))) + 1e-5
    assert (np.abs(out.float().numpy() - _np(ref)) <= tol).all()


def test_attention_bf16_matches_jax():
    rng = np.random.default_rng(4)
    qkv = jnp.asarray(rng.standard_normal((B * S, 3 * D)), jnp.bfloat16)
    ref = jkc.attention_bf16(qkv[:, :D], qkv[:, D : 2 * D], qkv[:, 2 * D :], B, S, H)
    out = kc.attention_bf16_plain(_t(_np(qkv), torch.bfloat16), S, H)
    assert out.dtype == torch.bfloat16
    # f32 scores and softmax summed in another order may flip one bf16
    # rounding of a prob (<= 2^-8 p), moving the output by <= 2^-8 max|v|,
    # plus the output's own bf16 rounding: 2^-6 max|v| bounds both
    vmax = np.abs(_np(qkv[:, 2 * D :])).max()
    np.testing.assert_allclose(out.float().numpy(), _np(ref), atol=2.0 ** -6 * vmax, rtol=0)


def test_post_ln_and_residual_layernorm_match_jax():
    rng = np.random.default_rng(5)
    a = jnp.asarray(rng.standard_normal((B * S, D)), jnp.bfloat16)
    b = rng.standard_normal((B * S, D)).astype(np.float32)
    scale = rng.standard_normal(D).astype(np.float32)
    bias = rng.standard_normal(D).astype(np.float32)
    ref = jkc.post_ln(a.astype(jnp.float32) + b, scale, bias)
    np.testing.assert_allclose(
        kc.post_ln(_t(_np(a)) + _t(b), _t(scale), _t(bias)).numpy(), _np(ref), atol=1e-5, rtol=1e-5
    )
    f32, bf = kc.residual_layernorm_plain(_t(_np(a), torch.bfloat16), _t(b), _t(scale), _t(bias), True, True)
    # f32 mean/var in another summation order: ~1e-7 relative, scaled by 1/std
    np.testing.assert_allclose(f32.numpy(), _np(ref), atol=1e-5, rtol=1e-5)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(bf.float().numpy(), _np(ref), atol=1e-5, rtol=2.0 ** -7)


def test_gelu_tanh_matches_jax():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    # tanh differs by ulps between XLA's and torch's CPU code; near
    # saturation 1 + tanh cancels, so the gate there is absolute (~8 ulps of 1)
    np.testing.assert_allclose(kc.gelu_tanh(_t(x)).numpy(), _np(jkc.gelu_tanh(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# whole layers vs the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "mode, atol, mean_tol",
    # Same arithmetic on both sides; the f32 GEMM sums run in another order,
    # which can flip a bf16 rounding of an activation (2^-8 relative) or, in
    # int8 mode, an int8 code (one step is amax/127 of its row). Both gates
    # are well inside the kernels' envelope vs flax in tests/test_ops.py
    # (bf16 6e-2 / 1e-2, int8 0.3 / 5e-2).
    [("bf16", 3e-2, 2e-3), ("int8", 6e-2, 5e-3)],
)
def test_layer_matches_pallas_interpret(layer_setup, mode, atol, mean_tol):
    params, layer, x = layer_setup
    xb = jnp.asarray(x, jnp.bfloat16)
    if mode == "bf16":
        ref = jax_layer_bf16(xb, jax_prepare_bf16(params), num_heads=H, interpret=True)
        out = l16.fused_encoder_layer_bf16(_t(x, torch.bfloat16), l16.prepare_layer_bf16(layer), H)
    else:
        ref = jax_layer_int8(xb, jax_prepare_int8(params), num_heads=H, interpret=True)
        out = l8.fused_encoder_layer_int8(_t(x, torch.bfloat16), l8.prepare_layer_int8(layer), H)
    assert out.dtype == torch.bfloat16 and out.shape == (B, S, D)
    dev = np.abs(out.float().numpy() - _np(ref))
    assert dev.max() < atol and dev.mean() < mean_tol, (dev.max(), dev.mean())


def test_f32_layer_matches_flax(layer_setup):
    params, layer, x = layer_setup
    ref = FlaxLayer(D, H, FF, dropout=0.0).apply({"params": params}, x)
    with torch.no_grad():
        out = layer(_t(x)).numpy()
    # f32 both sides; summation order only
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# wrapper dispatch
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_and_count_no_launch(layer_setup):
    _, layer, x = layer_setup
    counters = (l16.gemm_bf16, kc.attention_bf16, kc.residual_layernorm, l8.quant_rows_int8, l8.gemm_int8)
    before = [fn.launches for fn in counters]
    xb = _t(x, torch.bfloat16)
    for fn, plain, prep in (
        (l16.fused_encoder_layer_bf16, l16.fused_encoder_layer_bf16_plain, l16.prepare_layer_bf16(layer)),
        (l8.fused_encoder_layer_int8, l8.fused_encoder_layer_int8_plain, l8.prepare_layer_int8(layer)),
    ):
        torch.testing.assert_close(fn(xb, prep, H), plain(xb, prep, H), rtol=0, atol=0)
    assert [fn.launches for fn in counters] == before


def test_non_cpu_tensors_never_fall_back():
    """A tensor that is not on the CPU goes to the kernel or raises: here a
    meta tensor is refused by the operand check, before any build."""
    a = torch.empty(64, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        l16.gemm_bf16(a, a, torch.empty(64, dtype=torch.bfloat16, device="meta"), "qkv")
    with pytest.raises(ValueError, match="CUDA"):
        l8.quant_rows_int8(a)
    with pytest.raises(ValueError, match="CUDA"):
        kc.attention_bf16(torch.empty(32, 96, dtype=torch.bfloat16, device="meta"), 16, 2)


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda(layer_setup):
    """Needs a CUDA device (skips without one): each layer's kernel chain
    against its plain chain on the card, at D=64 (the kernels' tile widths)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card (see chip_smoke.py)")
    torch.manual_seed(0)
    layer = TransformerEncoderLayer(64, 4, 128).cuda()
    x = torch.randn(2, 144, 64, device="cuda").to(torch.bfloat16)
    for fn, plain, prep, atol in (
        (l16.fused_encoder_layer_bf16, l16.fused_encoder_layer_bf16_plain, l16.prepare_layer_bf16(layer), 6e-2),
        (l8.fused_encoder_layer_int8, l8.fused_encoder_layer_int8_plain, l8.prepare_layer_int8(layer), 0.3),
    ):
        err = (fn(x, prep, 4).float() - plain(x, prep, 4).float()).abs()
        assert err.max().item() < atol
