"""Shared pieces of the PoseNet encoder layers.

The port of rohm_tpu/ops/kernel_common.py. Two of the layer's CUDA kernels
live here because several layers call them: `attention_bf16`
(csrc/attention_bf16.cu; the bf16 and int8 layers) and `residual_layernorm`
(csrc/residual_layernorm.cu; every layer, the f32 one with its two-pass
variance).
Each wrapper has its plain PyTorch version beside it (`*_plain`), which it
takes only for a CPU tensor; on a CUDA tensor it launches the kernel, and
counts the launch in its `launches` attribute (`residual_layernorm` counts
its two-pass launches apart, in `two_pass_launches`, and `attention_bf16`
its no-softmax launches, in `no_softmax_launches`).
"""

from __future__ import annotations

import torch

from rohm_tpu_torch.ops._build import check_cuda, launch, ptr, stream

LN_EPS = 1e-5  # torch layer_norm_eps default, matches the models


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approx gelu (its deviation from exact-erf gelu, <= 1e-3, is below
    the bf16 activation rounding these layers accept)."""
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x * x * x)))


def post_ln(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            two_pass: bool = False) -> torch.Tensor:
    """Post-LN in f32 with the one-pass var = E[y^2] - mu^2 of the bf16 and
    int8 layers, or (two_pass) the var = E[(y - mu)^2] of the f32 layer
    (rohm_tpu/ops/transformer_layer.py:71-73)."""
    mu = y.mean(-1, keepdim=True)
    if two_pass:
        var = ((y - mu) ** 2).mean(-1, keepdim=True)
    else:
        var = (y * y).mean(-1, keepdim=True) - mu * mu
    return (y - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attention_bf16_plain(qkv: torch.Tensor, seq_len: int, num_heads: int,
                         no_softmax: bool = False) -> torch.Tensor:
    """qkv [B*S, 3D] bf16 -> [B*S, D] bf16: per (sequence, head), f32 scores
    of bf16 operands, f32 softmax, bf16 probs, f32 P.V rounded to bf16. The
    1/sqrt(dh) scale is already folded into Q. With `no_softmax` the probs
    are bf16(scores * 0.01) (the ablation of scripts/bench_int8_layer.py)."""
    rows, d3 = qkv.shape
    d = d3 // 3
    dh = d // num_heads
    q, k, v = (
        t.reshape(rows // seq_len, seq_len, num_heads, dh).transpose(1, 2).float()
        for t in qkv.split(d, dim=-1)
    )
    scores = q @ k.transpose(-1, -2)
    if no_softmax:
        probs = (scores * 0.01).to(torch.bfloat16)  # f32 product, as the kernel's
    else:
        probs = torch.softmax(scores, dim=-1).to(torch.bfloat16)
    out = (probs.float() @ v).to(torch.bfloat16)  # [B, H, S, dh]
    return out.transpose(1, 2).reshape(rows, d)


def attention_bf16(qkv: torch.Tensor, seq_len: int, num_heads: int,
                   no_softmax: bool = False) -> torch.Tensor:
    """Self-attention of every (sequence, head) read in place from the fused
    QKV buffer [B*S, 3D] bf16 -> [B*S, D] bf16; `no_softmax` takes
    bf16(scores * 0.01) for the probs (counted in `no_softmax_launches`).

    Replaces kernel_common.attention_bf16 inside the TPU kernels
    _layer_kernel_bf16 and _layer_kernel_int8 (and the attention of
    scripts/bench_int8_layer.py::make_kernel). CUDA: csrc/attention_bf16.cu;
    up to S = 144 one block per share of at least 64 query rows of a
    (sequence, head), K and V staged in shared memory once, scores, probs
    and output in registers on mma.sync; longer sequences stream K and V
    through shared memory in tiles of 144 keys. Bound by its bytes."""
    if qkv.device.type == "cpu":
        return attention_bf16_plain(qkv, seq_len, num_heads, no_softmax)
    check_cuda(qkv, torch.bfloat16, 2, "qkv")
    rows, d3 = qkv.shape
    d = d3 // 3
    if rows % seq_len or d % num_heads or (d // num_heads) % 16:
        raise ValueError(f"attention_bf16: bad shape {tuple(qkv.shape)} for S={seq_len}, H={num_heads}")
    out = torch.empty(rows, d, dtype=torch.bfloat16, device=qkv.device)
    launch("rt_attention_bf16", ptr(qkv), ptr(out), rows // seq_len, seq_len, num_heads,
           d // num_heads, int(no_softmax), stream())
    if no_softmax:
        attention_bf16.no_softmax_launches += 1
    else:
        attention_bf16.launches += 1
    return out


attention_bf16.launches = 0  # softmax launches
attention_bf16.no_softmax_launches = 0


# ---------------------------------------------------------------------------
# residual + LayerNorm
# ---------------------------------------------------------------------------


def residual_layernorm_plain(a, b, scale, bias, out_f32=True, out_bf16=False, two_pass=False):
    """LN(a.float() + b) -> (f32 or None, bf16 or None)."""
    o = post_ln(a.float() + b, scale, bias, two_pass)
    return (o if out_f32 else None), (o.to(torch.bfloat16) if out_bf16 else None)


def residual_layernorm(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, out_f32: bool = True, out_bf16: bool = False,
                       two_pass: bool = False):
    """Post-LN residual block: LN(a + b) over rows of width D, with a bf16 or
    f32 and b f32. Returns (f32 or None, bf16 or None). The variance is the
    one-pass E[y^2] - mu^2, or with `two_pass` E[(y - mu)^2].

    Replaces the residual adds + post_ln of the TPU kernels
    _layer_kernel_bf16 and _layer_kernel_int8, and (two_pass) the residual
    LayerNorms of _layer_kernel. CUDA: csrc/residual_layernorm.cu, one block
    per row; memory-bound."""
    if a.device.type == "cpu":
        return residual_layernorm_plain(a, b, scale, bias, out_f32, out_bf16, two_pass)
    if a.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"residual_layernorm: a must be bf16 or f32, got {a.dtype}")
    check_cuda(a, a.dtype, 2, "a")
    check_cuda(b, torch.float32, 2, "b")
    check_cuda(scale, torch.float32, 1, "scale")
    check_cuda(bias, torch.float32, 1, "bias")
    rows, d = a.shape
    if b.shape != a.shape or scale.shape[0] != d or bias.shape[0] != d:
        raise ValueError("residual_layernorm: shape mismatch")
    if not (out_f32 or out_bf16):
        raise ValueError("residual_layernorm: ask for at least one output")
    of = torch.empty(rows, d, dtype=torch.float32, device=a.device) if out_f32 else None
    ob = torch.empty(rows, d, dtype=torch.bfloat16, device=a.device) if out_bf16 else None
    launch("rt_residual_layernorm", ptr(a), int(a.dtype == torch.bfloat16), ptr(b), ptr(scale),
           ptr(bias), ptr(of), ptr(ob), rows, d, LN_EPS, int(two_pass), stream())
    if two_pass:
        residual_layernorm.two_pass_launches += 1
    else:
        residual_layernorm.launches += 1
    return of, ob


residual_layernorm.launches = 0  # one-pass launches
residual_layernorm.two_pass_launches = 0


# ---------------------------------------------------------------------------
# one-time parameter preparation
# ---------------------------------------------------------------------------


def fuse_qkv(attn) -> tuple[torch.Tensor, torch.Tensor]:
    """Fuse a SelfAttention's q/k/v projections into one [D, 3D] weight and
    [3D] bias (f32, [in, out] layout), with 1/sqrt(dh) folded into W_q/b_q."""
    w, b = attn.in_proj_weight.detach().float(), attn.in_proj_bias.detach().float()
    d = w.shape[1]
    scale = 1.0 / ((d // attn.num_heads) ** 0.5)  # the JAX package's expression
    wq, wk, wv = (w[i * d : (i + 1) * d].t() for i in range(3))
    bq, bk, bv = b[:d], b[d : 2 * d], b[2 * d :]
    return torch.cat([wq * scale, wk, wv], dim=-1), torch.cat([bq * scale, bk, bv])


def posenet_prep_tail(posenet) -> dict:
    """Embedding/head/timestep params shared by every fused-PoseNet prepare
    (tiny GEMMs; f32, [in, out] layout)."""
    te = posenet.embed_timestep.time_embed

    def dense(lin):
        return lin.weight.detach().t().contiguous(), lin.bias.detach().clone()

    t_w0, t_b0 = dense(te[0])
    t_w1, t_b1 = dense(te[2])
    in_w, in_b = dense(posenet.input_process.poseEmbedding)
    inc_w, inc_b = dense(posenet.input_process_cond.poseEmbedding)
    out_w, out_b = dense(posenet.output_process.poseFinal)
    return {
        "pe": posenet.pe,
        "t_w0": t_w0, "t_b0": t_b0, "t_w1": t_w1, "t_b1": t_b1,
        "in_w": in_w, "in_b": in_b, "inc_w": inc_w, "inc_b": inc_b,
        "out_w": out_w, "out_b": out_b,
    }
