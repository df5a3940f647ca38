"""f32 PoseNet encoder layer: `fused_posenet="f32"`.

Replaces rohm_tpu/ops/transformer_layer.py::_layer_kernel, the f32 TPU
kernel that runs one sequence's whole post-LN layer in VMEM. On the H100 the
layer is a chain of six launches of three hand-written CUDA kernels, on the
module's raw weights (torch Linear layout [out, in], no preparation):

  qkv  = gemm_f32(x, W_in, b_in, "qkv")       + bias, then q * 1/sqrt(dh)
  attn = attention_f32(qkv)                   per (sequence, head), f32 softmax
  a    = gemm_f32(attn, W_o, b_o, "bias")
  y    = residual_layernorm(x, a, two_pass)   var = E[(y - mu)^2]
  h1   = gemm_f32(y, W_1, b_1, "gelu")        exact-erf gelu
  h2   = gemm_f32(h1, W_2, b_2, "bias")
  out  = residual_layernorm(y, h2, two_pass)

Everything stays f32: the TPU kernel's gate against flax is 2e-5 absolute.
`gemm_f32` (csrc/gemm_f32.cu) and `attention_f32` (csrc/attention_f32.cu)
live here; the residual LayerNorm is shared (ops/kernel_common.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rohm_tpu_torch.ops._build import check_cuda, launch, ptr, stream
from rohm_tpu_torch.ops.kernel_common import residual_layernorm, residual_layernorm_plain

GEMM_F32_MODES = {"bias": 0, "qkv": 1, "gelu": 2}


def erf_as(x: torch.Tensor) -> torch.Tensor:
    """erf by Abramowitz-Stegun 7.1.26 (max abs err 1.5e-7), the TPU
    kernel's `_erf` (rohm_tpu/ops/transformer_layer.py:26)."""
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
           + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact gelu 0.5*x*(1 + erf(x/sqrt(2))) with the TPU kernel's erf."""
    return 0.5 * x * (1.0 + erf_as(x * 0.7071067811865476))


# ---------------------------------------------------------------------------
# gemm_f32
# ---------------------------------------------------------------------------


def gemm_f32_plain(a, w, bias, mode: str, scale: float = 1.0, scale_cols: int = 0) -> torch.Tensor:
    """a [M, K] @ w[N, K]^T + bias in f32, then the mode's epilogue."""
    v = a @ w.t() + bias
    if mode == "bias":
        return v
    if mode == "qkv":
        return torch.cat([v[:, :scale_cols] * scale, v[:, scale_cols:]], dim=-1)
    if mode == "gelu":
        return gelu_erf(v)
    raise ValueError(f"gemm_f32: unknown mode {mode!r}")


def gemm_f32(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, mode: str,
             scale: float = 1.0, scale_cols: int = 0) -> torch.Tensor:
    """a [M, K] f32 @ w [N, K] f32 (a Linear weight) ^T with f32-accurate
    sums and a fused epilogue: "bias": + bias; "qkv": + bias, then
    columns < scale_cols times `scale`; "gelu": + bias, exact-erf gelu.

    Replaces the dense products of _layer_kernel. CUDA: csrc/gemm_f32.cu on
    the f32 main loop of csrc/f32_gemm.cuh: 3xTF32 on the tensor cores
    (each operand split into two TF32 values, three mma.sync products, the
    small terms first), fed by a cp.async ring. Error budget: the dropped
    terms are <= ~3 2^-21 |a||b| per product, and each 32-deep k-step's
    partial sum is added to the running one rounded to nearest, within
    chip_smoke.py's gate of 1e-5 max|ref| + 1e-6 against torch's f32
    product (tests/test_torch_gemm_f32_numerics.py emulates it). Bound by
    its operations: three TF32 passes, 165 TFLOP/s on an H100. N and K
    multiples of 4."""
    if a.device.type == "cpu":
        return gemm_f32_plain(a, w, bias, mode, scale, scale_cols)
    if mode not in GEMM_F32_MODES:
        raise ValueError(f"gemm_f32: unknown mode {mode!r}")
    check_cuda(a, torch.float32, 2, "a")
    check_cuda(w, torch.float32, 2, "w")
    check_cuda(bias, torch.float32, 1, "bias")
    m, k = a.shape
    n = w.shape[0]
    if w.shape[1] != k or bias.shape[0] != n or n % 4 or k % 4:
        raise ValueError(f"gemm_f32: shapes {tuple(a.shape)} @ {tuple(w.shape)}^T unsupported")
    out = torch.empty(m, n, dtype=torch.float32, device=a.device)
    launch("rt_gemm_f32", ptr(a), ptr(w), ptr(bias), ptr(out), m, n, k, GEMM_F32_MODES[mode],
           scale, scale_cols, stream())
    gemm_f32.launches += 1
    return out


gemm_f32.launches = 0


# ---------------------------------------------------------------------------
# attention_f32
# ---------------------------------------------------------------------------


def attention_f32_plain(qkv: torch.Tensor, seq_len: int, num_heads: int) -> torch.Tensor:
    """qkv [B*S, 3D] f32 (Q pre-scaled) -> [B*S, D] f32: per (sequence,
    head) f32 scores, softmax and P.V."""
    rows, d3 = qkv.shape
    d = d3 // 3
    dh = d // num_heads
    q, k, v = (
        t.reshape(rows // seq_len, seq_len, num_heads, dh).transpose(1, 2)
        for t in qkv.split(d, dim=-1)
    )
    out = torch.softmax(q @ k.transpose(-1, -2), dim=-1) @ v  # [B, H, S, dh]
    return out.transpose(1, 2).reshape(rows, d)


def attention_f32(qkv: torch.Tensor, seq_len: int, num_heads: int) -> torch.Tensor:
    """Self-attention of every (sequence, head) read in place from the QKV
    buffer [B*S, 3D] f32 -> [B*S, D] f32.

    Replaces the per-head loop of _layer_kernel. CUDA: csrc/attention_f32.cu
    on csrc/attention_tf32.cuh: both products on the tensor cores as 3xTF32
    (f32 accuracy), warps of 16 query rows each holding a 16 x 160 score
    tile in registers; up to 160 keys one block per (sequence, head) stages
    K and V once, a longer sequence streams them in 160-key tiles (any S;
    dh a multiple of 4 up to 128)."""
    if qkv.device.type == "cpu":
        return attention_f32_plain(qkv, seq_len, num_heads)
    check_cuda(qkv, torch.float32, 2, "qkv")
    rows, d3 = qkv.shape
    d = d3 // 3
    if rows % seq_len or d3 % 3 or d % num_heads or (d // num_heads) % 4 or d // num_heads > 128:
        raise ValueError(f"attention_f32: bad shape {tuple(qkv.shape)} for S={seq_len}, H={num_heads}")
    out = torch.empty(rows, d, dtype=torch.float32, device=qkv.device)
    launch("rt_attention_f32", ptr(qkv), ptr(out), rows // seq_len, seq_len, num_heads,
           d // num_heads, stream())
    attention_f32.launches += 1
    return out


attention_f32.launches = 0


# ---------------------------------------------------------------------------
# the layer and the PoseNet forward
# ---------------------------------------------------------------------------


def _layer(x, layer, num_heads, gemm, attention, res_ln):
    """One f32 layer through the given kernel functions (wrappers or plain),
    on the module's own parameters."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    sa = layer.self_attn
    qkv = gemm(x2, sa.in_proj_weight, sa.in_proj_bias, "qkv", 1.0 / ((d // num_heads) ** 0.5), d)
    attn = gemm(attention(qkv, s, num_heads), sa.out_proj.weight, sa.out_proj.bias, "bias")
    y, _ = res_ln(x2, attn, layer.norm1.weight, layer.norm1.bias, True, False, True)
    h1 = gemm(y, layer.linear1.weight, layer.linear1.bias, "gelu")
    h2 = gemm(h1, layer.linear2.weight, layer.linear2.bias, "bias")
    out, _ = res_ln(y, h2, layer.norm2.weight, layer.norm2.bias, True, False, True)
    return out.reshape(b, s, d)


@torch.no_grad()
def fused_encoder_layer(x: torch.Tensor, layer, num_heads: int = 4) -> torch.Tensor:
    """One f32 encoder layer (a TransformerEncoderLayer module, eval mode).
    x [B, S, D] -> [B, S, D] f32."""
    return _layer(x.float().contiguous(), layer, num_heads,
                  gemm_f32, attention_f32, residual_layernorm)


@torch.no_grad()
def fused_encoder_layer_plain(x: torch.Tensor, layer, num_heads: int = 4) -> torch.Tensor:
    """The same layer through the plain PyTorch versions, on any device."""
    return _layer(x.float(), layer, num_heads,
                  gemm_f32_plain, attention_f32_plain, residual_layernorm_plain)


def embed_cond_f32(posenet, cond: torch.Tensor) -> torch.Tensor:
    """Project the step-invariant condition once, outside the sampling loop."""
    lin = posenet.input_process_cond.poseEmbedding
    return F.linear(cond, lin.weight, lin.bias)


@torch.no_grad()
def posenet_apply_fused(posenet, x_t: torch.Tensor, cond: torch.Tensor, t,
                        cond_emb: torch.Tensor | None = None) -> torch.Tensor:
    """PoseNet forward with the f32 kernel layers, on the module's raw
    weights (rohm_tpu/ops/transformer_layer.py::posenet_apply_fused).

    x_t/cond [B, T, 294] -> [B, T, 294] with the cond's traj dims passed
    through. Pass `cond_emb=embed_cond_f32(posenet, cond)` inside a sampling
    loop. The embeddings and the head stay plain products, as in the JAX
    package."""
    bsz, seq_len, _ = x_t.shape
    t = torch.as_tensor(t, device=x_t.device).expand(bsz)
    te = posenet.embed_timestep.time_embed
    emb = F.linear(F.silu(F.linear(posenet.pe[t], te[0].weight, te[0].bias)), te[2].weight, te[2].bias)
    if cond_emb is None:
        cond_emb = embed_cond_f32(posenet, cond)
    lin = posenet.input_process.poseEmbedding
    h = F.linear(x_t, lin.weight, lin.bias) + cond_emb
    seq = torch.cat([emb[:, None, :], h], dim=1) + posenet.pe[None, : seq_len + 1, :]
    for layer in posenet.seqTransEncoder.layers:
        seq = fused_encoder_layer(seq, layer, posenet.num_heads)
    head = posenet.output_process.poseFinal
    out = F.linear(seq[:, 1:], head.weight, head.bias)
    return torch.cat([cond[..., : posenet.traj_feat_dim], out], dim=-1)
