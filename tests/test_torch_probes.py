"""The int8 probes' kernels against the JAX scripts' Pallas kernels, on the
CPU: K8, the GEMM skeleton (rohm_tpu_torch.scripts.bench_int8_gemm_rows
against scripts/bench_int8_gemm_rows.py::gemm_kernel), and K9, the layer's
seven ablations (rohm_tpu_torch.scripts.bench_int8_layer against the kernel
of scripts/bench_int8_layer.py::make_kernel), with the two kernel modes
that K9 adds (fixed-scale quantization, no-softmax attention) and the row
stride of the q passthrough.

scripts/bench_int8_layer.py runs its benchmark at import and
scripts/bench_int8_gemm_rows.py sets a global JAX cache at import, so
neither is imported: `gemm_kernel` and `make_kernel` are taken from their
source with `ast` into a namespace that supplies what they use, and run
through `pl.pallas_call(..., interpret=True)`.
"""

import ast
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rohm_tpu.ops import kernel_common as jkc
from rohm_tpu.ops import transformer_layer_int8 as ji8
from rohm_tpu_torch.ops import kernel_common as kc
from rohm_tpu_torch.ops import transformer_layer_int8 as l8
from rohm_tpu_torch.scripts import bench_int8_gemm_rows as k8
from rohm_tpu_torch.scripts import bench_int8_layer as k9

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
D, F, S, G, H = 64, 128, 16, 2, 2


def _script_functions(script: str, names: tuple) -> dict:
    """The named top-level functions of a script, executed alone."""
    path = ROOT / "scripts" / script
    tree = ast.parse(path.read_text(), filename=str(path))
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(n.name for n in body) == sorted(names)
    ns = {"jax": jax, "jnp": jnp, "_quant_rows": ji8._quant_rows, "_dot_i8": ji8._dot_i8, "LN_EPS": jkc.LN_EPS}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), ns)
    return ns


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a):
    """A JAX array as a torch tensor of the same dtype (int8, f32 or bf16)."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(_np(a)).to(torch.bfloat16)
    return torch.from_numpy(np.asarray(a))


def _qcols(rng, *shape, scale=1.0):
    return ji8._quant_cols(jnp.asarray(rng.normal(size=shape) * scale, jnp.float32))


def test_gemm_skeleton_matches_the_script_kernel():
    rng = np.random.default_rng(0)
    weights = (*_qcols(rng, D, 3 * D), *_qcols(rng, D, D), *_qcols(rng, D, F), *_qcols(rng, F, D))
    x = jnp.asarray(rng.normal(size=(G, S, D)), jnp.bfloat16)
    kernel = _script_functions("bench_int8_gemm_rows.py", ("gemm_kernel",))["gemm_kernel"]
    ref = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((G, S, D), jnp.bfloat16), interpret=True)(
        x, *weights)
    before = k8.gemm_skeleton.launches
    out = k8.gemm_skeleton(_t(x), tuple(_t(w) for w in weights))
    assert k8.gemm_skeleton.launches == before  # a CPU tensor takes the plain version
    assert out.dtype == torch.bfloat16 and out.shape == (G, S, D)
    # int8 codes and int32 sums are exact and every rescale step is the
    # same rounded product: bit-identical (the port's bias of 0.0 can only
    # turn a -0.0 into +0.0, which compares equal)
    np.testing.assert_array_equal(out.float().numpy(), _np(ref))


def _k9_layer(rng):
    """The probe's layer at the test's size: N(0, 0.02^2) weights quantized
    per column, zero biases, unit LayerNorms (scripts/bench_int8_layer.py)."""
    zeros, ones = (lambda n: jnp.zeros(n, jnp.float32)), (lambda n: jnp.ones(n, jnp.float32))
    wqkv, sqkv = _qcols(rng, D, 3 * D, scale=0.02)
    wo, so = _qcols(rng, D, D, scale=0.02)
    w1, s1 = _qcols(rng, D, F, scale=0.02)
    w2, s2 = _qcols(rng, F, D, scale=0.02)
    return (wqkv, sqkv, zeros(3 * D), wo, so, zeros(D), ones(D), zeros(D),
            w1, s1, zeros(F), w2, s2, zeros(D), ones(D), zeros(D))


@pytest.mark.parametrize("name, kw", k9.VARIANTS, ids=[name for name, _ in k9.VARIANTS])
def test_int8_layer_variant_matches_the_script_kernel(name, kw):
    rng = np.random.default_rng(1)
    prepared = _k9_layer(rng)
    x = jnp.asarray(rng.normal(size=(G, S, D)) * 0.5, jnp.bfloat16)
    make_kernel = _script_functions("bench_int8_layer.py", ("make_kernel",))["make_kernel"]
    ref = pl.pallas_call(partial(make_kernel(**kw), num_heads=H),
                         out_shape=jax.ShapeDtypeStruct((G, S, D), jnp.bfloat16), interpret=True)(x, *prepared)
    before = k9.int8_layer_variant.launches
    out = k9.int8_layer_variant(_t(x), tuple(_t(a) for a in prepared), num_heads=H, **kw)
    assert k9.int8_layer_variant.launches == before
    assert out.dtype == torch.bfloat16 and out.shape == (G, S, D)
    # the per-layer int8 gates of tests/test_torch_ops.py: the same
    # arithmetic, with f32 sums (attention, LayerNorm) in another order that
    # can flip a bf16 rounding or an int8 code
    dev = np.abs(out.float().numpy() - _np(ref))
    assert dev.max() < 6e-2 and dev.mean() < 5e-3, (name, dev.max(), dev.mean())


def test_full_variant_is_the_k3_layer():
    rng = np.random.default_rng(2)
    prepared = tuple(_t(a) for a in _k9_layer(rng))
    x = torch.from_numpy(rng.normal(size=(G, S, D)).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(k9.int8_layer_variant(x, prepared, num_heads=H),
                       l8.fused_encoder_layer_int8(x, prepared, H))


def test_fixed_scale_and_strided_quant_bit_exact():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 3 * D)) * rng.uniform(0.1, 30, (40, 1))
    x[0, :8] = np.arange(8) / 8 + 1 / 16  # x * 8 on a .5: half to even
    for jx in (jnp.asarray(x, jnp.float32), jnp.asarray(x, jnp.bfloat16)):
        tx = _t(jx)
        # the fixed_quant ablation: clip(round(x * 8)), scale 1/8
        q, s = l8.quant_rows_int8_plain(tx, k9.FIXED_SCALE)
        q_ref = jnp.clip(jnp.round(jx.astype(jnp.float32) * 8.0), -127.0, 127.0).astype(jnp.int8)
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
        assert s.dtype == torch.float32 and (s == 0.125).all() and s.shape == (40,)
        # the q passthrough: a column slice of a wider buffer, quantized in place
        q, s = l8.quant_rows_int8_plain(tx[:, :D])
        q_ref, s_ref = ji8._quant_rows(jx[:, :D])
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
        np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref)[:, 0])


def test_no_softmax_attention_plain_matches_jax():
    rng = np.random.default_rng(4)
    qkv = jnp.asarray(rng.standard_normal((G * S, 3 * D)), jnp.bfloat16)
    dh = D // H
    outs = []
    for gi in range(G):  # the attention of make_kernel's no_softmax branch
        r = slice(gi * S, (gi + 1) * S)
        heads = []
        for h in range(H):
            c = slice(h * dh, (h + 1) * dh)
            scores = jax.lax.dot_general(qkv[r, c], qkv[r, D + h * dh: D + (h + 1) * dh],
                                         (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32)
            probs = (scores * 0.01).astype(jnp.bfloat16)
            heads.append(jnp.dot(probs, qkv[r, 2 * D + h * dh: 2 * D + (h + 1) * dh],
                                 preferred_element_type=jnp.float32).astype(jnp.bfloat16))
        outs.append(jnp.concatenate(heads, axis=-1))
    ref = _np(jnp.concatenate(outs, axis=0))
    before = kc.attention_bf16.no_softmax_launches
    out = kc.attention_bf16(_t(qkv), S, H, no_softmax=True)
    assert kc.attention_bf16.no_softmax_launches == before
    # f32 scores summed in another order may flip a prob's bf16 rounding
    # (2^-8 of |p|), which moves the output by 2^-8 sum|p||v|, plus the
    # output's own bf16 rounding: 2^-6 of the largest output bounds both
    # at this size
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2.0 ** -6 * np.abs(ref).max(), rtol=0)


def test_new_modes_never_fall_back_off_the_cpu():
    meta = torch.empty(32, 3 * D, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        l8.quant_rows_int8(meta, k9.FIXED_SCALE)
    with pytest.raises(ValueError, match="CUDA"):
        l8.quant_rows_int8(meta[:, :D])
    with pytest.raises(ValueError, match="CUDA"):
        kc.attention_bf16(meta, 16, H, no_softmax=True)


def test_probes_refuse_a_device_other_than_the_card():
    for probe in (k8, k9):
        with pytest.raises(SystemExit, match="CUDA"):
            probe.main(["--device", "cpu"])
