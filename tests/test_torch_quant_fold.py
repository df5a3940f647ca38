"""The LayerNorms' int8 codes folded into residual_layernorm, on the CPU.

The int8 chain (`fused_encoder_layers_int8`, "layers" and "layers_qattn"
preps) quantizes the stack's input, the attention output and h1 with
quant_rows_int8, and takes y's codes and the next layer's input codes from
the LayerNorm that writes them (residual_layernorm's `quant`). Here the
plain versions: the codes against the JAX package's `_quant_rows`, the
folded chain bit for bit against the chain that quantizes all four GEMM
inputs itself, the stack against the JAX int8 layers in interpret mode,
and chip_smoke.py's launch accounting against the calls the chain makes.
The CUDA kernels run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pipeline import _unflatten

import chip_smoke
from rohm_tpu.ops import kernel_common as jkc
from rohm_tpu.ops import transformer_layer_int8 as ji8
from rohm_tpu.utils.convert_torch_ckpt import convert_posenet
from rohm_tpu_torch.models import PoseNet
from rohm_tpu_torch.ops import kernel_common as kc
from rohm_tpu_torch.ops import transformer_layer_bf16 as l16
from rohm_tpu_torch.ops import transformer_layer_int8 as l8

torch.set_num_threads(1)

D, H, FF = 32, 2, 64
B, T = 2, 15  # T frames -> T + 1 tokens


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _posenet(num_layers: int, seed: int) -> PoseNet:
    """A small PoseNet with biases moved off zero (flax inits them to zero,
    which would hide bias bugs)."""
    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    posenet = PoseNet(latent_dim=D, ff_size=FF, num_layers=num_layers, num_heads=H)
    with torch.no_grad():
        for p in posenet.parameters():
            if not p.any():
                p.copy_(torch.from_numpy(0.1 * rng.standard_normal(p.shape)).float())
    return posenet


@pytest.fixture(scope="module")
def pair():
    """A 2-layer port PoseNet, its flax params, and a step's inputs."""
    posenet = _posenet(2, 0)
    sd = {k: v.numpy() for k, v in posenet.state_dict().items()}
    flax = _unflatten(convert_posenet(sd, num_layers=2, num_heads=H, latent_dim=D))
    rng = np.random.default_rng(1)
    x_t, cond = (torch.from_numpy(rng.standard_normal((B, T, 294)).astype(np.float32)) for _ in range(2))
    return posenet, flax, x_t, cond


def _unfused_layers(x, layers, num_heads, qattn=False):
    """The int8 chain before the fold, in plain PyTorch: each layer
    quantizes its four GEMM inputs itself (rohm_tpu/ops/
    transformer_layer_int8.py::_layer_kernel_int8's four `_quant_rows`)."""
    attention = l8.attention_int8_plain if qattn else kc.attention_bf16_plain
    quant, gemm = l8.quant_rows_int8_plain, l8.gemm_int8_plain
    b, s, d = x.shape
    x2 = x.to(torch.bfloat16).reshape(b * s, d)
    for wqkv, sqkv, bqkv, wo, so, bo, g1, be1, w1, s1, b1, w2, s2, b2, g2, be2 in layers:
        qkv = gemm(*quant(x2), wqkv, sqkv, bqkv, "bf16")
        attn = gemm(*quant(attention(qkv, s, num_heads)), wo, so, bo, "f32")
        y, _ = kc.residual_layernorm_plain(x2, attn, g1, be1, True, False)
        h1 = gemm(*quant(y), w1, s1, b1, "gelu")
        h2 = gemm(*quant(h1), w2, s2, b2, "f32")
        _, x2 = kc.residual_layernorm_plain(y, h2, g2, be2, False, True)
    return x2.reshape(b, s, d)


@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_layernorm_codes_match_jax_quant_rows(out):
    """residual_layernorm_plain's codes and scales are the JAX `_quant_rows`
    of the output it writes (f32 where it writes one, else bf16), bit for
    bit. Against `_quant_rows` of JAX's own post_ln output (whose mean and
    variance are summed in another order, a few ulps away) a code may move
    by one step and a scale by a few ulps."""
    rng = np.random.default_rng(5)
    rows = 4 * 16
    # per-row magnitudes 100x apart, as activations have
    a = jnp.asarray(rng.standard_normal((rows, D)) * rng.uniform(0.1, 10, (rows, 1)), jnp.bfloat16)
    b = rng.standard_normal((rows, D)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(D)).astype(np.float32)
    ta = torch.from_numpy(_np(a)).to(torch.bfloat16)
    args = (ta, torch.from_numpy(b), torch.from_numpy(scale), torch.from_numpy(bias))
    f32, bf16, (q, s) = kc.residual_layernorm_plain(*args, out == "f32", out == "bf16", quant=True)
    written = f32 if out == "f32" else bf16
    assert (f32 is None) == (out == "bf16") and (bf16 is None) == (out == "f32")
    assert q.dtype == torch.int8 and q.shape == (rows, D) and s.dtype == torch.float32 and s.shape == (rows,)
    q_ref, s_ref = ji8._quant_rows(jnp.asarray(written.float().numpy()).astype(
        jnp.float32 if out == "f32" else jnp.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref)[:, 0])
    # and quant_rows_int8_plain of the same output
    q_own, s_own = l8.quant_rows_int8_plain(written)
    assert torch.equal(q, q_own) and torch.equal(s, s_own)

    y = jkc.post_ln(a.astype(jnp.float32) + b, scale, bias)
    qj, sj = ji8._quant_rows(y if out == "f32" else y.astype(jnp.bfloat16))
    assert np.abs(q.numpy().astype(np.int32) - np.asarray(qj, np.int32)).max() <= 1
    np.testing.assert_allclose(s.numpy(), np.asarray(sj)[:, 0], rtol=2.0 ** -20, atol=0)


@pytest.mark.parametrize("qattn", [False, True], ids=["int8", "int8qa"])
def test_fold_is_bit_identical_to_the_unfused_chain(pair, monkeypatch, qattn):
    """The PoseNet forward through posenet_apply_prepared with the
    LayerNorms' codes equals, bit for bit, the same forward with the chain
    that runs four standalone quantizations a layer."""
    posenet, _, x_t, cond = pair
    prep = l8.prepare_posenet_int8(posenet, qattn=qattn)
    folded = l16.posenet_apply_prepared(prep, x_t, cond, 5, num_heads=H)
    monkeypatch.setattr(l8, "fused_encoder_layers_int8", _unfused_layers)
    unfused = l16.posenet_apply_prepared(prep, x_t, cond, 5, num_heads=H)
    assert torch.isfinite(folded).all() and folded.shape == (B, T, 294)
    assert torch.equal(folded, unfused)


@pytest.mark.parametrize("qattn", [False, True], ids=["int8", "int8qa"])
def test_layer_stack_matches_pallas_interpret(pair, qattn):
    """fused_encoder_layers_int8 (plain versions here) against the JAX
    package's int8 layers chained in interpret mode, within the gates of
    tests/test_torch_ops.py::test_layer_matches_pallas_interpret (an int8
    code or a bf16 rounding flipped by another summation order)."""
    posenet, flax, *_ = pair
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((B, T + 1, D)), jnp.bfloat16)
    jprep = ji8.prepare_posenet_int8(flax, num_layers=2, qattn=qattn)
    ref = x
    for layer in jprep["layers_qattn" if qattn else "layers"]:
        ref = ji8.fused_encoder_layer_int8(ref, layer, num_heads=H, interpret=True, qattn=qattn)
    layers = l8.prepare_posenet_int8(posenet, qattn=qattn)["layers_qattn" if qattn else "layers"]
    out = l8.fused_encoder_layers_int8(torch.from_numpy(_np(x)).to(torch.bfloat16), layers, H, qattn=qattn)
    assert out.dtype == torch.bfloat16 and out.shape == (B, T + 1, D)
    dev = np.abs(out.float().numpy() - _np(ref))
    assert dev.max() < 6e-2 and dev.mean() < 5e-3, (dev.max(), dev.mean())


@pytest.mark.parametrize("mode", ["int8", "int8qa"])
def test_launch_accounting_matches_the_chain(monkeypatch, mode):
    """chip_smoke.py's expected launches per 8-layer forward (1 + 2 L
    quant_rows_int8, 2 L residual_layernorm, 4 L gemm_int8, L attention)
    are the wrapper calls the chain makes in one PoseNet forward."""
    calls = dict.fromkeys(("quant_rows_int8", "gemm_int8", "attention_bf16", "attention_int8",
                           "residual_layernorm"), 0)

    def counted(name):
        fn = getattr(l8, name)

        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)

        return call

    for name in calls:
        monkeypatch.setattr(l8, name, counted(name))
    posenet = _posenet(chip_smoke.LAYERS, 3)
    x_t = torch.from_numpy(np.random.default_rng(4).standard_normal((B, T, 294)).astype(np.float32))
    l16.posenet_apply_prepared(l8.prepare_posenet_int8(posenet, qattn=mode == "int8qa"), x_t, x_t, 7,
                               num_heads=H)
    expected = {name: n for name, n in chip_smoke.forward_launches(mode).items() if n}
    assert expected["quant_rows_int8"] == 1 + 2 * chip_smoke.LAYERS == 17
    assert expected["residual_layernorm"] == 2 * chip_smoke.LAYERS == 16
    assert {name: n for name, n in calls.items() if n} == expected


def test_residual_layernorm_codes_take_the_plain_version_on_cpu():
    """On CPU tensors the wrapper with `quant` is its plain version and
    counts no launch."""
    g = torch.Generator().manual_seed(6)
    a, b = torch.randn(8, D, generator=g), torch.randn(8, D, generator=g)
    scale, bias = torch.ones(D), torch.zeros(D)
    before = (kc.residual_layernorm.launches, l8.quant_rows_int8.launches)
    got = kc.residual_layernorm(a, b, scale, bias, False, True, quant=True)
    ref = kc.residual_layernorm_plain(a, b, scale, bias, False, True, quant=True)
    assert got[0] is None and torch.equal(got[1], ref[1])
    assert all(torch.equal(x, y) for x, y in zip(got[2], ref[2]))
    assert (kc.residual_layernorm.launches, l8.quant_rows_int8.launches) == before
