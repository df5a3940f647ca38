"""Microbench: where does the int8 layer's time go?

The port of scripts/bench_int8_layer.py. It times a 1000-layer chain (each
layer's output is the next one's input) of the int8 encoder layer at
[8, 144, 512], 4 heads, FF 1024, zero biases and unit LayerNorms, and of
its ablations, each variant a switch of `int8_layer_variant`:
  no_attn      attention replaced by a passthrough of q (quantized in place
               from the QKV buffer through its row stride)
  no_softmax   probs = bf16(scores * 0.01) instead of the softmax
  fixed_quant  every quantization at the fixed scale 1/8 (codes
               clip(rint(x * 8))) instead of the per-row amax
  no_gelu      FF1 without its gelu
"full" is the K3 layer (`fused_encoder_layer_int8`, bit for bit) with its
four GEMM inputs quantized by quant_rows_int8 (the K3 chain takes the
LayerNorms' codes from residual_layernorm instead). The LayerNorms
are one-pass, var = E[y^2] - mu^2, as in the JAX script. Weights come from
np.random.default_rng(0) (the JAX script draws them with jax.random: the
same distributions, other values). Times: CUDA events over the chain run
from Python, and over a CUDA graph of 10 chained layers replayed 100 times
(the card alone).

    python -m rohm_tpu_torch.scripts.bench_int8_layer [--device cuda:0] [--iters 1000]
"""

from __future__ import annotations

import numpy as np
import torch

from rohm_tpu_torch.ops.kernel_common import (
    attention_bf16,
    attention_bf16_plain,
    residual_layernorm,
    residual_layernorm_plain,
)
from rohm_tpu_torch.ops.transformer_layer_int8 import (
    _quant_cols,
    gemm_int8,
    gemm_int8_plain,
    quant_rows_int8,
    quant_rows_int8_plain,
)
from rohm_tpu_torch.scripts.bench_int8_gemm_rows import cuda_device, time_calls

G, S, D, H, F = 8, 144, 512, 4, 1024
ITERS = 1000
FIXED_SCALE = 1.0 / 8.0
VARIANTS = (
    ("full", {}),
    ("no_attention", {"no_attn": True}),
    ("no_softmax", {"no_softmax": True}),
    ("fixed_quant", {"fixed_quant": True}),
    ("no_gelu", {"no_gelu": True}),
    ("no_attn+fixed_quant", {"no_attn": True, "fixed_quant": True}),
    ("bare_gemms", {"no_attn": True, "fixed_quant": True, "no_gelu": True}),
)


def _variant(x, prepared, no_attn, no_softmax, fixed_quant, no_gelu, num_heads, quant, gemm, attention,
             res_ln):
    (wqkv, sqkv, bqkv, wo, so, bo, ln1_s, ln1_b,
     w1, s1, b1, w2, s2, b2, ln2_s, ln2_b) = prepared
    fixed = FIXED_SCALE if fixed_quant else None
    g, s, d = x.shape
    x2 = x.reshape(g * s, d)
    qkv = gemm(*quant(x2, fixed), wqkv, sqkv, bqkv, "bf16")
    attn_in = qkv[:, :d] if no_attn else attention(qkv, s, num_heads, no_softmax)
    attn = gemm(*quant(attn_in, fixed), wo, so, bo, "f32")
    y, _ = res_ln(x2, attn, ln1_s, ln1_b, True, False)
    h1 = gemm(*quant(y, fixed), w1, s1, b1, "f32" if no_gelu else "gelu")
    h2 = gemm(*quant(h1, fixed), w2, s2, b2, "f32")
    _, out = res_ln(y, h2, ln2_s, ln2_b, False, True)
    return out.reshape(g, s, d)


def int8_layer_variant_plain(x: torch.Tensor, prepared: tuple, no_attn: bool = False,
                             no_softmax: bool = False, fixed_quant: bool = False, no_gelu: bool = False,
                             num_heads: int = H) -> torch.Tensor:
    """The variant through the plain PyTorch versions, on any device."""
    return _variant(x.to(torch.bfloat16), prepared, no_attn, no_softmax, fixed_quant, no_gelu, num_heads,
                    quant_rows_int8_plain, gemm_int8_plain, attention_bf16_plain, residual_layernorm_plain)


def int8_layer_variant(x: torch.Tensor, prepared: tuple, no_attn: bool = False, no_softmax: bool = False,
                       fixed_quant: bool = False, no_gelu: bool = False, num_heads: int = H) -> torch.Tensor:
    """One int8 layer with the given ablations. x [G, S, D] bf16 -> [G, S, D]
    bf16; `prepared` is prepare_layer_int8's 16-tuple.

    Replaces the kernel of scripts/bench_int8_layer.py::make_kernel. CUDA:
    the K3 chain's kernels (csrc/quant_rows_int8.cu in its row-stride and
    fixed-scale modes, csrc/gemm_int8.cu, csrc/attention_bf16.cu in its
    no-softmax mode, csrc/residual_layernorm.cu); `launches` counts calls
    on the card."""
    if x.device.type == "cpu":
        return int8_layer_variant_plain(x, prepared, no_attn, no_softmax, fixed_quant, no_gelu, num_heads)
    out = _variant(x.to(torch.bfloat16).contiguous(), prepared, no_attn, no_softmax, fixed_quant, no_gelu,
                   num_heads, quant_rows_int8, gemm_int8, attention_bf16, residual_layernorm)
    int8_layer_variant.launches += 1
    return out


int8_layer_variant.launches = 0


def build(device) -> tuple[tuple, torch.Tensor]:
    """The probe's layer (weights N(0, 0.02^2) quantized per column, zero
    biases, unit LayerNorms) and its [G, S, D] bf16 input (N(0, 0.5^2))."""
    rng = np.random.default_rng(0)

    def qcols(*shape):
        q, s = _quant_cols(torch.from_numpy((rng.normal(size=shape) * 0.02).astype(np.float32)))
        return q.to(device), s.to(device)  # K-major, as gemm_int8 takes it

    def const(n, v):
        return torch.full((n,), v, dtype=torch.float32, device=device)

    wqkv_q, sqkv = qcols(D, 3 * D)
    wo_q, so = qcols(D, D)
    w1_q, s1 = qcols(D, F)
    w2_q, s2 = qcols(F, D)
    prepared = (
        wqkv_q, sqkv, const(3 * D, 0.0),
        wo_q, so, const(D, 0.0),
        const(D, 1.0), const(D, 0.0),
        w1_q, s1, const(F, 0.0),
        w2_q, s2, const(D, 0.0),
        const(D, 1.0), const(D, 0.0),
    )
    x = np.random.default_rng(1).normal(size=(G, S, D)) * 0.5
    return prepared, torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).to(device)


def probe(device, iters: int = ITERS) -> dict:
    """Time a chain of each variant, from Python (`iters` layers) and on the
    card alone (`time_calls`); print and return us/layer both ways."""
    prepared, x = build(device)
    results = {}
    for name, kw in VARIANTS:
        host, card = time_calls(lambda c, kw=kw: int8_layer_variant(c, prepared, **kw), x, iters)
        results[name] = {"host_us": host * 1e6, "us": card * 1e6}
        print(f"{name:28s} {host * 1e6:8.1f} us/layer from Python, {card * 1e6:8.1f} on the card", flush=True)
    return results


def main(argv=None) -> dict:
    return probe(*cuda_device("bench_int8_layer", argv))


if __name__ == "__main__":
    main()
