"""bf16 PoseNet encoder layer: the accuracy mode (`fused_posenet="bf16"`).

Replaces rohm_tpu/ops/transformer_layer_bf16.py::_layer_kernel_bf16. The TPU
kernel keeps a whole layer for 8 sequences in 100 MiB of VMEM; an H100 SM
has 227 KB of shared memory, so the layer becomes a chain of seven launches
of four hand-written CUDA kernels:

  qkv  = gemm_bf16(x, Wqkv, bqkv, "qkv")       f32 acc -> bf16, + bf16 bias
  attn = attention_bf16(qkv)                   per (sequence, head)
  a    = gemm_bf16(attn, Wo, bo, "f32")        + f32 bias
  y    = residual_layernorm(x, a)              f32 kept for residual 2, bf16 for FF1
  h1   = gemm_bf16(y_bf16, W1, b1, "gelu")     + f32 bias, tanh-gelu, bf16
  h2   = gemm_bf16(h1, W2, b2, "f32")
  out  = residual_layernorm(y, h2) -> bf16

`gemm_bf16` (csrc/gemm_bf16.cu) lives here; attention and the residual
LayerNorm are shared with the int8 layer (ops/kernel_common.py).
"""

from __future__ import annotations

import torch

from rohm_tpu_torch.ops._build import check_cuda, launch, ptr, stream
from rohm_tpu_torch.ops.kernel_common import (
    attention_bf16,
    attention_bf16_plain,
    fuse_qkv,
    gelu_tanh,
    posenet_prep_tail,
    residual_layernorm,
    residual_layernorm_plain,
)

GEMM_BF16_MODES = {"qkv": 0, "f32": 1, "gelu": 2}


def gemm_bf16_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, mode: str) -> torch.Tensor:
    """a [M, K] bf16 @ w [K, N] bf16 in f32, then the mode's epilogue."""
    acc = a.float() @ w.float()
    if mode == "qkv":
        return acc.to(torch.bfloat16) + bias
    if mode == "f32":
        return acc + bias
    if mode == "gelu":
        return gelu_tanh(acc + bias).to(torch.bfloat16)
    raise ValueError(f"gemm_bf16: unknown mode {mode!r}")


def gemm_bf16(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, mode: str) -> torch.Tensor:
    """a [M, K] bf16 @ w [K, N] bf16 with f32 accumulation and a fused epilogue:
    "qkv": round to bf16, + bf16 bias -> bf16; "f32": + f32 bias -> f32;
    "gelu": + f32 bias, tanh-gelu -> bf16.

    Replaces the dense products of _layer_kernel_bf16. CUDA: csrc/gemm_bf16.cu,
    the Hopper main loop it shares with gemm_train (TMA ring, wgmma) on 128 x
    128 or 128 x 64 tiles, w as stored; any M, N and K multiples of 8. Bound
    by its bytes at the production shapes."""
    if a.device.type == "cpu":
        return gemm_bf16_plain(a, w, bias, mode)
    if mode not in GEMM_BF16_MODES:
        raise ValueError(f"gemm_bf16: unknown mode {mode!r}")
    check_cuda(a, torch.bfloat16, 2, "a")
    check_cuda(w, torch.bfloat16, 2, "w")
    check_cuda(bias, torch.bfloat16 if mode == "qkv" else torch.float32, 1, "bias")
    m, k = a.shape
    n = w.shape[1]
    if w.shape[0] != k or bias.shape[0] != n or n % 8 or k % 8:
        raise ValueError(f"gemm_bf16: shapes {tuple(a.shape)} @ {tuple(w.shape)} unsupported")
    out_dtype = torch.float32 if mode == "f32" else torch.bfloat16
    out = torch.empty(m, n, dtype=out_dtype, device=a.device)
    launch("rt_gemm_bf16", ptr(a), ptr(w), ptr(bias), ptr(out), m, n, k,
           GEMM_BF16_MODES[mode], stream())
    gemm_bf16.launches += 1
    return out


gemm_bf16.launches = 0


def _layer(x, prepared, num_heads, gemm, attention, res_ln):
    """One bf16 layer through the given kernel functions (wrappers or plain)."""
    (wqkv, bqkv, wo, bo, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b) = prepared
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    qkv = gemm(x2, wqkv, bqkv, "qkv")
    attn = gemm(attention(qkv, s, num_heads), wo, bo, "f32")
    y, yb = res_ln(x2, attn, ln1_s, ln1_b, True, True)
    h2 = gemm(gemm(yb, w1, b1, "gelu"), w2, b2, "f32")
    _, out = res_ln(y, h2, ln2_s, ln2_b, False, True)
    return out.reshape(b, s, d)


def fused_encoder_layer_bf16(x: torch.Tensor, prepared: tuple, num_heads: int = 4) -> torch.Tensor:
    """One bf16 encoder layer. x [B, S, D] bf16 -> [B, S, D] bf16."""
    return _layer(x.to(torch.bfloat16).contiguous(), prepared, num_heads,
                  gemm_bf16, attention_bf16, residual_layernorm)


def fused_encoder_layer_bf16_plain(x: torch.Tensor, prepared: tuple, num_heads: int = 4) -> torch.Tensor:
    """The same layer through the plain PyTorch versions, on any device."""
    return _layer(x.to(torch.bfloat16), prepared, num_heads,
                  gemm_bf16_plain, attention_bf16_plain, residual_layernorm_plain)


def prepare_layer_bf16(layer) -> tuple:
    """Cast/fuse one TransformerEncoderLayer for the bf16 path. Call ONCE,
    outside the sampling loop."""
    wqkv, bqkv = fuse_qkv(layer.self_attn)

    def f32(t):
        return t.detach().float().contiguous()

    def bf16(t):
        return t.detach().to(torch.bfloat16).contiguous()

    return (
        bf16(wqkv), bf16(bqkv),
        bf16(layer.self_attn.out_proj.weight.t()), f32(layer.self_attn.out_proj.bias),
        f32(layer.norm1.weight), f32(layer.norm1.bias),
        bf16(layer.linear1.weight.t()), f32(layer.linear1.bias),
        bf16(layer.linear2.weight.t()), f32(layer.linear2.bias),
        f32(layer.norm2.weight), f32(layer.norm2.bias),
    )


def prepare_posenet_fused(posenet) -> dict:
    """One-time preparation of a PoseNet for the bf16 path: per-layer
    fused/cast weights + f32 embedding/head params + PE table."""
    return {
        "layers": tuple(prepare_layer_bf16(layer) for layer in posenet.seqTransEncoder.layers),
        **posenet_prep_tail(posenet),
    }


def embed_cond(prep: dict, cond: torch.Tensor) -> torch.Tensor:
    """Project the step-invariant condition once, outside the sampling loop."""
    return cond @ prep["inc_w"] + prep["inc_b"]


@torch.no_grad()
def posenet_apply_prepared(
    prep: dict, x_t: torch.Tensor, cond: torch.Tensor, t, num_heads: int = 4,
    traj_feat_dim: int = 22, cond_emb: torch.Tensor | None = None,
) -> torch.Tensor:
    """PoseNet forward on a prepared dict: the stacked int8 layers under
    "layers_stacked" (the whole-stack kernel, one launch), int8 layers with
    quantized attention under "layers_qattn", bf16 or int8 layers under
    "layers" (by the tuple's length, 12 or 16), looked up in that order
    (rohm_tpu/ops/transformer_layer_bf16.py dispatches the same way).

    x_t/cond [B, T, 294] -> [B, T, 294] with the cond's traj dims passed
    through. Pass `cond_emb=embed_cond(prep, cond)` inside a sampling loop.
    """
    from rohm_tpu_torch.ops import transformer_layer_int8 as l8

    bsz, seq_len, _ = x_t.shape
    t = torch.as_tensor(t, device=x_t.device).expand(bsz)
    pe = prep["pe"]
    emb = torch.nn.functional.silu(pe[t] @ prep["t_w0"] + prep["t_b0"])
    emb = emb @ prep["t_w1"] + prep["t_b1"]
    if cond_emb is None:
        cond_emb = embed_cond(prep, cond)
    h = x_t @ prep["in_w"] + prep["in_b"] + cond_emb
    seq = torch.cat([emb[:, None, :], h], dim=1)
    seq = (seq + pe[None, : seq_len + 1, :]).to(torch.bfloat16)

    if "layers_stacked" in prep:
        seq = l8.fused_encoder_stack_int8(seq, prep["layers_stacked"], num_heads)
    elif "layers_qattn" in prep:
        for layer in prep["layers_qattn"]:
            seq = l8.fused_encoder_layer_int8(seq, layer, num_heads, qattn=True)
    else:
        layers = prep["layers"]
        layer_fn = l8.fused_encoder_layer_int8 if len(layers[0]) == 16 else fused_encoder_layer_bf16
        for layer in layers:
            seq = layer_fn(seq, layer, num_heads)

    out = seq[:, 1:].float() @ prep["out_w"] + prep["out_b"]
    return torch.cat([cond[..., :traj_feat_dim], out], dim=-1)
