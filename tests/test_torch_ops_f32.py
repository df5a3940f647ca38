"""The f32 PoseNet layer (`fused_posenet="f32"`) of the port against the JAX
package's f32 Pallas kernel (rohm_tpu/ops/transformer_layer.py) in interpret
mode, on the CPU, where the port's wrappers take their plain versions.

The CUDA kernels (gemm_f32, attention_f32, the two-pass residual_layernorm)
run only on the card; `python3 chip_smoke.py` holds each against these plain
versions there, and the `cuda`-marked test here does so at a small size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ops import layer_setup  # noqa: F401  (fixture: flax layer + port twin)
from test_torch_pipeline import _unflatten

from rohm_tpu.ops import transformer_layer as j32
from rohm_tpu.utils.convert_torch_ckpt import convert_posenet
from rohm_tpu_torch.models import PoseNet
from rohm_tpu_torch.models.blocks import TransformerEncoderLayer
from rohm_tpu_torch.ops import kernel_common as kc
from rohm_tpu_torch.ops import transformer_layer as l32

torch.set_num_threads(1)

D, H, FF = 32, 2, 64
B, S = 2, 16


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


# ---------------------------------------------------------------------------
# pieces against K1's own formulas
# ---------------------------------------------------------------------------


def test_erf_and_gelu_match_the_kernels_polynomial():
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    # the same A-S 7.1.26 polynomial in the same f32 operation order; exp
    # differs by ulps between XLA's and torch's CPU code
    np.testing.assert_allclose(l32.erf_as(_t(x)).numpy(), np.asarray(j32._erf(jnp.asarray(x))),
                               rtol=0, atol=2e-7)
    ref = 0.5 * jnp.asarray(x) * (1.0 + j32._erf(jnp.asarray(x) * 0.7071067811865476))
    np.testing.assert_allclose(l32.gelu_erf(_t(x)).numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    # and the polynomial stays within its stated 1.5e-7 of the exact erf,
    # plus the f32 rounding of its ten steps (the kernel uses erff)
    np.testing.assert_allclose(l32.erf_as(_t(x)).numpy(), torch.erf(_t(x)).numpy(), rtol=0, atol=5e-7)


def test_two_pass_layernorm_is_k1s_and_not_the_one_pass():
    """K1 computes var = mean((y - mu)^2) (transformer_layer.py:71-73); the
    bf16/int8 layers' post_ln the one-pass E[y^2] - mu^2. Rows with a large
    mean and a small spread tell the two apart."""
    rng = np.random.default_rng(0)
    y = (1e3 + rng.standard_normal((8, D))).astype(np.float32)
    scale = rng.standard_normal(D).astype(np.float32)
    bias = rng.standard_normal(D).astype(np.float32)
    jy = jnp.asarray(y)
    mu = jnp.mean(jy, axis=-1, keepdims=True)
    var = jnp.mean((jy - mu) ** 2, axis=-1, keepdims=True)
    ref = (jy - mu) * jax.lax.rsqrt(var + j32.LN_EPS) * scale + bias
    two, _ = kc.residual_layernorm_plain(_t(y), torch.zeros(8, D), _t(scale), _t(bias), True, False, True)
    one, _ = kc.residual_layernorm_plain(_t(y), torch.zeros(8, D), _t(scale), _t(bias), True, False, False)
    # f32 means in another summation order: ~sqrt(D) ulps of 1e3 (6e-5),
    # over a std of ~1, times |scale| (up to 2.5 here)
    np.testing.assert_allclose(two.numpy(), np.asarray(ref), atol=5e-4, rtol=0)
    # the one-pass variance loses it to cancellation in E[y^2] - mu^2
    # (0.31 on these inputs)
    assert np.abs(one.numpy() - np.asarray(ref)).max() > 0.1


@pytest.mark.parametrize("mode", ["bias", "qkv", "gelu"])
def test_gemm_f32_epilogues(mode):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((40, 64)).astype(np.float32)
    w = rng.standard_normal((96, 64)).astype(np.float32)  # [out, in], a Linear weight
    bias = rng.standard_normal(96).astype(np.float32)
    scale = 1.0 / (16 ** 0.5)
    v = jnp.dot(jnp.asarray(a), jnp.asarray(w).T, preferred_element_type=jnp.float32) + bias
    ref = {
        "bias": lambda: v,
        # K1 multiplies q by the scale AFTER its bias (transformer_layer.py:55,62)
        "qkv": lambda: jnp.concatenate([v[:, :32] * scale, v[:, 32:]], axis=-1),
        "gelu": lambda: 0.5 * v * (1.0 + j32._erf(v * 0.7071067811865476)),
    }[mode]()
    out = l32.gemm_f32_plain(_t(a), _t(w), _t(bias), mode, scale, 32)
    # f32 sums of 64 terms in another order: ~1e-6 relative
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the layer and PoseNet against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------


def test_f32_layer_matches_pallas_interpret(layer_setup):  # noqa: F811
    params, layer, x = layer_setup
    ref = j32.fused_encoder_layer(jnp.asarray(x), params, num_heads=H, interpret=True)
    out = l32.fused_encoder_layer(_t(x), layer, H)
    assert out.dtype == torch.float32 and out.shape == (B, S, D)
    # f32 both sides, the same two-pass LayerNorm and erf polynomial: only
    # summation order differs (the JAX kernel's own gate vs flax,
    # tests/test_ops.py:34)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def test_posenet_apply_fused_matches_jax():
    torch.manual_seed(0)
    rng = np.random.default_rng(2)
    posenet = PoseNet(latent_dim=D, ff_size=FF, num_layers=2, num_heads=H)
    with torch.no_grad():  # wake the zero-init biases so bias bugs show
        for p in posenet.parameters():
            if not p.any():
                p.copy_(_t(0.1 * rng.standard_normal(p.shape)))
    sd = {k: v.numpy() for k, v in posenet.state_dict().items()}
    flax = _unflatten(convert_posenet(sd, num_layers=2, num_heads=H, latent_dim=D))
    x_t = rng.standard_normal((B, 15, 294)).astype(np.float32)
    cond = rng.standard_normal((B, 15, 294)).astype(np.float32)
    t = np.array([3, 7])
    ref = j32.posenet_apply_fused(flax, jnp.asarray(x_t), jnp.asarray(cond), jnp.asarray(t),
                                  num_layers=2, num_heads=H, interpret=True)
    out = l32.posenet_apply_fused(posenet, _t(x_t), _t(cond), torch.from_numpy(t))
    # the gate of tests/test_ops.py:43 (two layers plus the embeddings and
    # head in f32; the hoisted cond projection adds its bias in another order)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5, rtol=1e-5)
    # the hoisted condition embedding computes the same thing
    hoisted = l32.posenet_apply_fused(posenet, _t(x_t), _t(cond), torch.from_numpy(t),
                                      cond_emb=l32.embed_cond_f32(posenet, _t(cond)))
    np.testing.assert_allclose(hoisted.numpy(), out.numpy(), atol=1e-6, rtol=0)
    # and the plain module (torch's own attention and erf) agrees
    np.testing.assert_allclose(posenet(_t(x_t), _t(cond), torch.from_numpy(t)).numpy(), out.numpy(),
                               atol=5e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_f32_cpu_tensors_take_the_plain_version(layer_setup):  # noqa: F811
    _, layer, x = layer_setup
    counters = ((l32.gemm_f32, "launches"), (l32.attention_f32, "launches"),
                (kc.residual_layernorm, "launches"), (kc.residual_layernorm, "two_pass_launches"))
    before = [getattr(fn, attr) for fn, attr in counters]
    torch.testing.assert_close(l32.fused_encoder_layer(_t(x), layer, H),
                               l32.fused_encoder_layer_plain(_t(x), layer, H), rtol=0, atol=0)
    assert [getattr(fn, attr) for fn, attr in counters] == before


def test_f32_non_cpu_tensors_never_fall_back():
    a = torch.empty(64, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        l32.gemm_f32(a, a, torch.empty(64, device="meta"), "bias")
    with pytest.raises(ValueError, match="CUDA"):
        l32.attention_f32(torch.empty(32, 96, device="meta"), 16, 2)
    with pytest.raises(ValueError, match="CUDA"):
        kc.residual_layernorm(a, a, torch.empty(64, device="meta"), torch.empty(64, device="meta"),
                              True, False, True)


@pytest.mark.cuda
def test_f32_and_int8qa_kernels_match_plain_on_cuda():
    """Needs a CUDA device (skips without one): the f32 and the int8qa layer
    chains against their plain chains on the card, at D=64."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card (see chip_smoke.py)")
    from rohm_tpu_torch.ops import transformer_layer_int8 as l8

    torch.manual_seed(0)
    layer = TransformerEncoderLayer(64, 4, 128).cuda()
    x = torch.randn(2, 144, 64, device="cuda")
    err = (l32.fused_encoder_layer(x, layer, 4) - l32.fused_encoder_layer_plain(x, layer, 4)).abs()
    assert err.max().item() < 2e-4
    prep = l8.prepare_layer_int8(layer)
    xb = x.to(torch.bfloat16)
    got = l8.fused_encoder_layer_int8(xb, prep, 4, qattn=True).float()
    assert (got - l8.fused_encoder_layer_int8_plain(xb, prep, 4, qattn=True).float()).abs().max().item() < 0.3
