"""The int8 layer with quantized attention (`fused_posenet="int8qa"`, the
qattn=True variant of rohm_tpu/ops/transformer_layer_int8.py) against the
JAX package, on the CPU: `attention_int8_plain` against the JAX
`attention_int8` (a plain jnp function), the whole layer against the
Pallas kernel in interpret mode, and the "layers_qattn" prep and dispatch.
The CUDA kernel csrc/attention_int8.cu runs only on the card, where
`python3 chip_smoke.py` holds it against the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ops import layer_setup  # noqa: F401  (fixture: flax layer + port twin)
from test_torch_pipeline import _unflatten

from rohm_tpu.ops import transformer_layer_int8 as ji8
from rohm_tpu.ops.transformer_layer_bf16 import posenet_apply_prepared as jax_apply_prepared
from rohm_tpu.utils.convert_torch_ckpt import convert_posenet
from rohm_tpu_torch.models import PoseNet
from rohm_tpu_torch.ops import kernel_common as kc
from rohm_tpu_torch.ops import transformer_layer_bf16 as l16
from rohm_tpu_torch.ops import transformer_layer_int8 as l8

torch.set_num_threads(1)

D, H, FF = 32, 2, 64
B, S = 2, 16
BF16_ULP = 2.0 ** -7


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jax_codes(qkv, g, s, num_heads):
    """The quantized operands inside the JAX attention_int8, per (sequence,
    head), stacked [g, H, ...] (the body of ji8.attention_int8)."""
    d = qkv.shape[-1] // 3
    dh = d // num_heads
    q, k, v = qkv[:, :d], qkv[:, d : 2 * d], qkv[:, 2 * d :]
    out = {"qq": [], "kk": [], "pi": [], "vv": []}
    for gi in range(g):
        r = slice(gi * s, (gi + 1) * s)
        for h in range(num_heads):
            col = slice(h * dh, (h + 1) * dh)
            qq, rq = ji8._quant_rows(q[r, col])
            kk, rk = ji8._quant_rows(k[r, col])
            acc = jax.lax.dot_general(qq, kk, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32)
            pi = ji8._quant_probs(jax.nn.softmax(acc.astype(jnp.float32) * rq * rk.reshape(1, -1), axis=-1))
            vf = v[r, col].astype(jnp.float32)
            vmax = jnp.maximum(jnp.max(jnp.abs(vf), axis=0, keepdims=True), 1e-12)
            vv = jnp.clip(jnp.round(vf * (127.0 / vmax)), -127.0, 127.0).astype(jnp.int8)
            for name, val in (("qq", qq), ("kk", kk), ("pi", pi), ("vv", vv)):
                out[name].append(np.asarray(val, np.float32))
    return {k: np.stack(v).reshape((g, num_heads) + v[0].shape) for k, v in out.items()}


def test_attention_int8_plain_matches_jax():
    rng = np.random.default_rng(0)
    # per-row magnitudes that differ by 100x, as activations do
    x = rng.standard_normal((B * S, 3 * D)) * rng.uniform(0.1, 10, (B * S, 1))
    qkv = jnp.asarray(x, jnp.bfloat16)
    tq = torch.from_numpy(_np(qkv)).to(torch.bfloat16)
    qq, _, kk, _, pi, vv, vmax = l8.attention_int8_codes(tq, S, H)
    ref = _jax_codes(qkv, B, S, H)
    # Q, K and V codes: the same rounded division, product and rint
    np.testing.assert_array_equal(qq.numpy(), ref["qq"])
    np.testing.assert_array_equal(kk.numpy(), ref["kk"])
    np.testing.assert_array_equal(vv.numpy(), ref["vv"])
    # prob codes: exact int32 scores, then an f32 softmax whose sum runs in
    # another order; a ulp of difference can move p * 127 across a .5 and
    # flip a code by one. Most codes agree
    dp = np.abs(pi.numpy() - ref["pi"])
    assert dp.max() <= 1 and (dp == 0).mean() > 0.99, (dp.max(), (dp == 0).mean())

    out = l8.attention_int8_plain(tq, S, H)
    jout = ji8.attention_int8(qkv[:, :D], qkv[:, D : 2 * D], qkv[:, 2 * D :], B, S, H)
    assert out.dtype == torch.bfloat16 and out.shape == (B * S, D)
    # one flipped prob code moves an output by vmax/127 of its column; two
    # flips in one row at most, plus one bf16 ulp of the output rounding
    col_vmax = vmax.expand(B, H, S, D // H).transpose(1, 2).reshape(B * S, D).numpy()
    tol = 2 * col_vmax / 127.0 + BF16_ULP * np.abs(_np(jout))
    assert (np.abs(out.float().numpy() - _np(jout)) <= tol).all()


def test_qattn_layer_matches_pallas_interpret(layer_setup):  # noqa: F811
    params, layer, x = layer_setup
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = ji8.fused_encoder_layer_int8(xb, ji8.prepare_layer_int8(params), num_heads=H,
                                       interpret=True, qattn=True)
    out = l8.fused_encoder_layer_int8(torch.from_numpy(_np(xb)).to(torch.bfloat16),
                                      l8.prepare_layer_int8(layer), H, qattn=True)
    assert out.dtype == torch.bfloat16 and out.shape == (B, S, D)
    # the int8 layer's gate (tests/test_torch_ops.py): an int8 code or a
    # bf16 rounding flipped by another summation order, now also in the
    # attention's prob codes (one step is 1/127 of a prob)
    dev = np.abs(out.float().numpy() - _np(ref))
    assert dev.max() < 6e-2 and dev.mean() < 5e-3, (dev.max(), dev.mean())


@pytest.fixture(scope="module")
def posenet_pair():
    torch.manual_seed(0)
    rng = np.random.default_rng(3)
    posenet = PoseNet(latent_dim=D, ff_size=FF, num_layers=2, num_heads=H)
    with torch.no_grad():
        for p in posenet.parameters():
            if not p.any():
                p.copy_(torch.from_numpy(0.1 * rng.standard_normal(p.shape)).float())
    sd = {k: v.numpy() for k, v in posenet.state_dict().items()}
    flax = _unflatten(convert_posenet(sd, num_layers=2, num_heads=H, latent_dim=D))
    x_t = rng.standard_normal((B, 15, 294)).astype(np.float32)
    cond = rng.standard_normal((B, 15, 294)).astype(np.float32)
    return posenet, flax, x_t, cond


def test_layers_qattn_prep_and_dispatch(posenet_pair, monkeypatch):
    """prepare_posenet_int8(qattn=True) files the layers under
    "layers_qattn", and posenet_apply_prepared dispatches on that key (an
    int8 layer tuple has 16 entries with or without qattn, so the tuple
    length cannot tell them apart)."""
    posenet, flax, x_t, cond = posenet_pair
    prep = l8.prepare_posenet_int8(posenet, qattn=True)
    plain = l8.prepare_posenet_int8(posenet)
    assert "layers_qattn" in prep and "layers" not in prep and "layers_qattn" not in plain
    assert len(prep["layers_qattn"][0]) == len(plain["layers"][0]) == 16
    tx, tc = torch.from_numpy(x_t), torch.from_numpy(cond)
    out = l16.posenet_apply_prepared(prep, tx, tc, 5, num_heads=H)

    calls = []
    orig = l8.fused_encoder_layers_int8

    def spy(x, layers, num_heads, qattn=False):  # one entry per layer of the chain
        calls.extend([qattn] * len(layers))
        return orig(x, layers, num_heads, qattn=qattn)

    monkeypatch.setattr(l8, "fused_encoder_layers_int8", spy)
    l16.posenet_apply_prepared(prep, tx, tc, 5, num_heads=H)
    l16.posenet_apply_prepared(plain, tx, tc, 5, num_heads=H)
    monkeypatch.undo()
    assert calls == [True, True, False, False]

    jprep = ji8.prepare_posenet_int8(flax, num_layers=2, qattn=True)
    ref = jax_apply_prepared(jprep, jnp.asarray(x_t), jnp.asarray(cond), jnp.asarray(5),
                             num_heads=H, interpret=True)
    # two int8qa layers plus the f32 head: the layer gate above, carried
    # through the head's 32-term sums
    dev = np.abs(out.numpy() - np.asarray(ref))
    assert dev.max() < 0.2 and dev.mean() < 1e-2, (dev.max(), dev.mean())


def test_int8qa_cpu_tensors_take_the_plain_version(layer_setup):  # noqa: F811
    _, layer, x = layer_setup
    counters = (l8.attention_int8, l8.gemm_int8, l8.quant_rows_int8, kc.residual_layernorm,
                kc.attention_bf16)
    before = [fn.launches for fn in counters]
    xb = torch.from_numpy(x).to(torch.bfloat16)
    prep = l8.prepare_layer_int8(layer)
    torch.testing.assert_close(l8.fused_encoder_layer_int8(xb, prep, H, qattn=True),
                               l8.fused_encoder_layer_int8_plain(xb, prep, H, qattn=True), rtol=0, atol=0)
    assert [fn.launches for fn in counters] == before


def test_int8qa_non_cpu_tensors_never_fall_back():
    with pytest.raises(ValueError, match="CUDA"):
        l8.attention_int8(torch.empty(32, 96, dtype=torch.bfloat16, device="meta"), 16, 2)
