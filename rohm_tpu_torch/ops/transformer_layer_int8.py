"""int8 PoseNet encoder layer: the W8A8 throughput mode (`fused_posenet="int8"`,
and `"int8qa"` with quantized attention).

Replaces rohm_tpu/ops/transformer_layer_int8.py::_layer_kernel_int8 with
qattn=False and qattn=True. Weights are symmetric int8 with one f32 scale per output
column (set once by `prepare_layer_int8`); each GEMM input is quantized per
row right before the product; int32 accumulation; dequant acc*row*col, then
an f32 bias. Attention, LayerNorm and residuals are those of the bf16 layer.
On the H100 the layer is a chain of eleven launches of five hand-written
CUDA kernels:

  qx   = quant_rows_int8(x)
  qkv  = gemm_int8(qx, Wqkv, bqkv, "bf16")     cast to bf16 AFTER the bias
  attn = attention_bf16(qkv)
  a    = gemm_int8(quant_rows_int8(attn), Wo, bo, "f32")
  y    = residual_layernorm(x, a)              f32
  h1   = gemm_int8(quant_rows_int8(y), W1, b1, "gelu")   f32
  h2   = gemm_int8(quant_rows_int8(h1), W2, b2, "f32")
  out  = residual_layernorm(y, h2) -> bf16

With qattn=True ("int8qa") `attention_int8` (csrc/attention_int8.cu) takes
the place of attention_bf16: both attention products on int8 codes.

The whole stack of L such layers also runs as one launch,
`fused_encoder_stack_int8` (csrc/encoder_stack_int8.cu; replaces
_mega_kernel_int8): a persistent cooperative kernel whose phases are the
chain above, separated by grid-wide barriers, with the intermediates in a
workspace that stays largely in L2. Its phases run the same device
routines as the per-layer kernels (csrc/layer_routines.cuh), so its output
is bit-identical to L launches of the chain. `prepare_posenet_int8(mega=True)`
files the layers under "layers_stacked" (16 tensors with a leading [L]
dim), which selects it in posenet_apply_prepared.

`quant_rows_int8` (csrc/quant_rows_int8.cu), `gemm_int8` (csrc/gemm_int8.cu),
`attention_int8` and the stack kernel live here.
"""

from __future__ import annotations

import ctypes

import torch

from rohm_tpu_torch.ops._build import check_cuda, launch, ptr, stream
from rohm_tpu_torch.ops.kernel_common import (
    LN_EPS,
    attention_bf16,
    attention_bf16_plain,
    fuse_qkv,
    gelu_tanh,
    posenet_prep_tail,
    residual_layernorm,
    residual_layernorm_plain,
)

GEMM_INT8_MODES = {"bf16": 0, "f32": 1, "gelu": 2}


def _quant(x: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 along `dim`: amax/127 scales, round half to even."""
    xf = x.float()
    amax = torch.clamp(xf.abs().amax(dim=dim, keepdim=True), min=1e-12)
    # tensor / tensor: `127.0 / amax` would be reciprocal(amax) * 127 in
    # torch, one rounding more than the JAX package's (and the kernel's) division
    inv = torch.full_like(amax, 127.0) / amax
    q = torch.clamp(torch.round(xf * inv), -127.0, 127.0).to(torch.int8)
    return q, (amax * (1.0 / 127.0)).squeeze(dim)


def quant_rows_int8_plain(x: torch.Tensor, fixed_scale: float | None = None):
    """[R, C] bf16/f32 -> (int8 [R, C], f32 row scales [R]); with
    `fixed_scale`, codes clip(rint(x / fixed_scale)) and that scale on
    every row (the fixed_quant ablation of scripts/bench_int8_layer.py)."""
    if fixed_scale is None:
        return _quant(x, -1)
    inv = 1.0 / fixed_scale
    q = torch.clamp(torch.round(x.float() * inv), -127.0, 127.0).to(torch.int8)
    return q, torch.full((x.shape[0],), fixed_scale, dtype=torch.float32, device=x.device)


def quant_rows_int8(x: torch.Tensor, fixed_scale: float | None = None):
    """Per-row int8 quantization of an activation [R, C] (bf16 or f32) ->
    (int8 [R, C], f32 scales [R]). `x` may be a column slice of a wider
    buffer (rows apart by x.stride(0), e.g. the q third of a QKV buffer):
    the kernel reads it in place. `fixed_scale` (a power of two, as the
    1/8 of scripts/bench_int8_layer.py) replaces the per-row scale; those
    launches count in `fixed_launches`.

    Replaces `_quant_rows` inside _layer_kernel_int8. CUDA:
    csrc/quant_rows_int8.cu, one block per row; memory-bound."""
    if x.device.type == "cpu":
        return quant_rows_int8_plain(x, fixed_scale)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quant_rows_int8: x must be bf16 or f32, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"x: expected a CUDA tensor, got {x.device}")
    if x.dim() != 2 or x.stride(1) != 1 or x.stride(0) < x.shape[1]:
        raise ValueError(f"quant_rows_int8: expected rows of contiguous columns, got strides {x.stride()}")
    if fixed_scale is not None and not fixed_scale > 0.0:
        raise ValueError(f"quant_rows_int8: fixed_scale must be positive, got {fixed_scale}")
    rows, cols = x.shape
    q = torch.empty(rows, cols, dtype=torch.int8, device=x.device)
    scale = torch.empty(rows, dtype=torch.float32, device=x.device)
    launch("rt_quant_rows_int8", ptr(x), int(x.dtype == torch.bfloat16), ptr(q), ptr(scale),
           rows, cols, x.stride(0), 0.0 if fixed_scale is None else 1.0 / fixed_scale, stream())
    if fixed_scale is None:
        quant_rows_int8.launches += 1
    else:
        quant_rows_int8.fixed_launches += 1
    return q, scale


quant_rows_int8.launches = 0  # per-row scale launches
quant_rows_int8.fixed_launches = 0


def _quant_cols(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 [K, N] -> (int8 [K, N], f32 col scales [N])."""
    return _quant(w, 0)


def gemm_int8_plain(qa, row_scale, w_q, col_scale, bias, mode: str) -> torch.Tensor:
    """The W8A8 product in plain PyTorch. The int8 values multiply as f32,
    which is exact: every partial sum is an integer below K*127^2 <= 2^24."""
    acc = qa.float() @ w_q.float()
    v = acc * row_scale[:, None] * col_scale + bias
    if mode == "bf16":
        return v.to(torch.bfloat16)
    if mode == "f32":
        return v
    if mode == "gelu":
        return gelu_tanh(v)
    raise ValueError(f"gemm_int8: unknown mode {mode!r}")


def gemm_int8(qa: torch.Tensor, row_scale: torch.Tensor, w_q: torch.Tensor,
              col_scale: torch.Tensor, bias: torch.Tensor, mode: str) -> torch.Tensor:
    """(float(qa [M,K] i8 @ w_q [K,N] i8) * row_scale[m]) * col_scale[n] + bias[n],
    int32 accumulation; "bf16" stores bf16, "f32" f32, "gelu" tanh-gelu f32.

    Replaces `_dot_i8` + bias inside _layer_kernel_int8. CUDA:
    csrc/gemm_int8.cu, WMMA s8 tensor-core tiles; tensor-core bound."""
    if qa.device.type == "cpu":
        return gemm_int8_plain(qa, row_scale, w_q, col_scale, bias, mode)
    if mode not in GEMM_INT8_MODES:
        raise ValueError(f"gemm_int8: unknown mode {mode!r}")
    check_cuda(qa, torch.int8, 2, "qa")
    check_cuda(w_q, torch.int8, 2, "w_q")
    for t, name in ((row_scale, "row_scale"), (col_scale, "col_scale"), (bias, "bias")):
        check_cuda(t, torch.float32, 1, name)
    m, k = qa.shape
    n = w_q.shape[1]
    if (w_q.shape[0] != k or row_scale.shape[0] != m or col_scale.shape[0] != n
            or bias.shape[0] != n or n % 64 or k % 32):
        raise ValueError(f"gemm_int8: shapes {tuple(qa.shape)} @ {tuple(w_q.shape)} unsupported")
    out_dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    out = torch.empty(m, n, dtype=out_dtype, device=qa.device)
    launch("rt_gemm_int8", ptr(qa), ptr(row_scale), ptr(w_q), ptr(col_scale), ptr(bias),
           ptr(out), m, n, k, GEMM_INT8_MODES[mode], stream())
    gemm_int8.launches += 1
    return out


gemm_int8.launches = 0


def attention_int8_codes(qkv: torch.Tensor, seq_len: int, num_heads: int):
    """The quantized operands of attention_int8 in plain PyTorch, each
    [B, H, ...]: (Q codes, Q row scales, K codes, K row scales, prob codes,
    V codes, V column amax [B, H, 1, dh]). Codes are int8 values held in f32."""
    rows, d3 = qkv.shape
    d = d3 // 3
    dh = d // num_heads
    q, k, v = (
        t.reshape(rows // seq_len, seq_len, num_heads, dh).transpose(1, 2).float()
        for t in qkv.split(d, dim=-1)
    )
    qq, rq = _quant(q, -1)
    kk, rk = _quant(k, -1)
    # int8 x int8 sums multiply exactly in f32: every partial sum is an
    # integer below dh * 127^2 < 2^24
    scores = (qq.float() @ kk.float().transpose(-1, -2)) * rq[..., :, None] * rk[..., None, :]
    probs = torch.round(torch.softmax(scores, dim=-1) * 127.0)
    vq, _ = _quant(v, -2)
    vmax = torch.clamp(v.abs().amax(dim=-2, keepdim=True), min=1e-12)
    return qq.float(), rq, kk.float(), rk, probs, vq.float(), vmax


def attention_int8_plain(qkv: torch.Tensor, seq_len: int, num_heads: int) -> torch.Tensor:
    """qkv [B*S, 3D] bf16 -> [B*S, D] bf16, the arithmetic of
    rohm_tpu/ops/transformer_layer_int8.py::attention_int8."""
    rows, d3 = qkv.shape
    *_, probs, vq, vmax = attention_int8_codes(qkv, seq_len, num_heads)
    # exact in f32 (sums below seq_len * 127^2 < 2^24); tensor / tensor, a
    # division as in the JAX package (a scalar divisor would be a reciprocal
    # multiply on the card)
    out = (probs @ vq) * (vmax / torch.full_like(vmax, 127.0 * 127.0))
    return out.to(torch.bfloat16).transpose(1, 2).reshape(rows, d3 // 3)


def attention_int8(qkv: torch.Tensor, seq_len: int, num_heads: int) -> torch.Tensor:
    """Fully quantized self-attention of every (sequence, head) on the fused
    QKV buffer [B*S, 3D] bf16 -> [B*S, D] bf16: Q and K int8 per row, int32
    scores, f32 softmax, probs int8 at the fixed scale 127, V int8 per
    column, int32 P.V.

    Replaces `attention_int8` inside _layer_kernel_int8 (qattn=True). CUDA:
    csrc/attention_int8.cu, one block per (48 queries, sequence, head) with
    the head's K and V codes in shared memory, int8 WMMA for both products."""
    if qkv.device.type == "cpu":
        return attention_int8_plain(qkv, seq_len, num_heads)
    check_cuda(qkv, torch.bfloat16, 2, "qkv")
    rows, d3 = qkv.shape
    d = d3 // 3
    if rows % seq_len or d3 % 3 or d % num_heads or (d // num_heads) % 16:
        raise ValueError(f"attention_int8: bad shape {tuple(qkv.shape)} for S={seq_len}, H={num_heads}")
    out = torch.empty(rows, d, dtype=torch.bfloat16, device=qkv.device)
    launch("rt_attention_int8", ptr(qkv), ptr(out), rows // seq_len, seq_len, num_heads,
           d // num_heads, stream())
    attention_int8.launches += 1
    return out


attention_int8.launches = 0


def _layer(x, prepared, num_heads, quant, gemm, attention, res_ln):
    """One int8 layer through the given kernel functions (wrappers or plain)."""
    (wqkv, sqkv, bqkv, wo, so, bo, ln1_s, ln1_b,
     w1, s1, b1, w2, s2, b2, ln2_s, ln2_b) = prepared
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    qkv = gemm(*quant(x2), wqkv, sqkv, bqkv, "bf16")
    attn = gemm(*quant(attention(qkv, s, num_heads)), wo, so, bo, "f32")
    y, _ = res_ln(x2, attn, ln1_s, ln1_b, True, False)
    h1 = gemm(*quant(y), w1, s1, b1, "gelu")
    h2 = gemm(*quant(h1), w2, s2, b2, "f32")
    _, out = res_ln(y, h2, ln2_s, ln2_b, False, True)
    return out.reshape(b, s, d)


def fused_encoder_layer_int8(x: torch.Tensor, prepared: tuple, num_heads: int = 4,
                             qattn: bool = False) -> torch.Tensor:
    """One int8 encoder layer. x [B, S, D] bf16 -> [B, S, D] bf16; with
    `qattn` the attention runs on int8 codes too."""
    return _layer(x.to(torch.bfloat16).contiguous(), prepared, num_heads,
                  quant_rows_int8, gemm_int8, attention_int8 if qattn else attention_bf16,
                  residual_layernorm)


def fused_encoder_layer_int8_plain(x: torch.Tensor, prepared: tuple, num_heads: int = 4,
                                   qattn: bool = False) -> torch.Tensor:
    """The same layer through the plain PyTorch versions, on any device."""
    return _layer(x.to(torch.bfloat16), prepared, num_heads, quant_rows_int8_plain,
                  gemm_int8_plain, attention_int8_plain if qattn else attention_bf16_plain,
                  residual_layernorm_plain)


def prepare_layer_int8(layer) -> tuple:
    """Quantize one TransformerEncoderLayer for the int8 path (call once,
    outside the sampling loop)."""
    wqkv, bqkv = fuse_qkv(layer.self_attn)

    def f32(t):
        return t.detach().float().contiguous()

    wqkv_q, sqkv = _quant_cols(wqkv)
    wo_q, so = _quant_cols(f32(layer.self_attn.out_proj.weight.t()))
    w1_q, s1 = _quant_cols(f32(layer.linear1.weight.t()))
    w2_q, s2 = _quant_cols(f32(layer.linear2.weight.t()))
    return (
        wqkv_q.contiguous(), sqkv, f32(bqkv),
        wo_q.contiguous(), so, f32(layer.self_attn.out_proj.bias),
        f32(layer.norm1.weight), f32(layer.norm1.bias),
        w1_q.contiguous(), s1, f32(layer.linear1.bias),
        w2_q.contiguous(), s2, f32(layer.linear2.bias),
        f32(layer.norm2.weight), f32(layer.norm2.bias),
    )


def fused_encoder_stack_int8_plain(x: torch.Tensor, stacked: tuple, num_heads: int = 4) -> torch.Tensor:
    """The whole stack through the plain PyTorch versions: the plain layer
    on each layer's slice of the stacked tensors, on any device."""
    for l in range(stacked[0].shape[0]):
        x = fused_encoder_layer_int8_plain(x, tuple(t[l] for t in stacked), num_heads)
    return x


STACK_PHASES = ("QKV GEMM", "attention", "quant attn", "out GEMM", "LN1 + quant y", "FF1 GEMM + gelu",
                "quant h1", "FF2 GEMM", "LN2 + quant x")


def fused_encoder_stack_int8(x: torch.Tensor, stacked: tuple, num_heads: int = 4,
                             phase_ns: torch.Tensor | None = None) -> torch.Tensor:
    """All L int8 encoder layers in one launch. x [B, S, D] bf16 -> [B, S, D]
    bf16; `stacked` is 16 tensors with a leading [L] dim
    (`prepare_posenet_int8(mega=True)["layers_stacked"]`). `phase_ns`, an
    int64 CUDA tensor [2 + 9L], receives the card's global timer at the
    start, after layer 0's input quantization and after each of the L x 9
    phases (STACK_PHASES), for a breakdown of the launch (the plain version
    has no phases and leaves it untouched).

    Replaces _mega_kernel_int8 (rohm_tpu/ops/transformer_layer_int8.py).
    CUDA: csrc/encoder_stack_int8.cu, one persistent cooperative kernel
    whose phases (the K3 chain's GEMM tiles, attention items and rows,
    separated by grid-wide barriers) run the per-layer kernels' routines:
    bit-identical to L launches of the fused_encoder_layer_int8 chain. The
    intermediates live in a workspace allocated here per call (~66 MB at
    B=32, S=144). A grid the card cannot hold at once raises."""
    if x.device.type == "cpu":
        return fused_encoder_stack_int8_plain(x, stacked, num_heads)
    x = x.to(torch.bfloat16).contiguous()
    check_cuda(x, torch.bfloat16, 3, "x")
    b, s, d = x.shape
    num_layers, f = stacked[0].shape[0], stacked[8].shape[-1]
    if d % 64 or f % 64 or d % num_heads or (d // num_heads) % 16:
        raise ValueError(f"fused_encoder_stack_int8: D={d}, F={f}, H={num_heads} unsupported")
    shapes = _stack_shapes(num_layers, d, f)
    for i, (t, shape) in enumerate(zip(stacked, shapes, strict=True)):
        check_cuda(t, torch.int8 if i in (0, 3, 8, 11) else torch.float32, len(shape), f"stacked[{i}]")
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_encoder_stack_int8: stacked[{i}] is {tuple(t.shape)}, expected {shape}")
    if phase_ns is not None:
        check_cuda(phase_ns, torch.int64, 1, "phase_ns")
        if phase_ns.shape[0] != 2 + 9 * num_layers:
            raise ValueError(f"fused_encoder_stack_int8: phase_ns needs {2 + 9 * num_layers} entries")
    r = b * s

    def empty(*shape, dtype):
        return torch.empty(shape, dtype=dtype, device=x.device)

    out = torch.empty_like(x)
    # xbuf, q, qscale, qkv, attn, a, y, h1 (csrc/encoder_stack_int8.cu)
    work = (empty(r, d, dtype=torch.bfloat16), empty(r, f, dtype=torch.int8), empty(r, dtype=torch.float32),
            empty(r, 3 * d, dtype=torch.bfloat16), empty(r, d, dtype=torch.bfloat16),
            empty(r, d, dtype=torch.float32), empty(r, d, dtype=torch.float32), empty(r, f, dtype=torch.float32))
    weights = (ctypes.c_void_p * 16)(*(t.data_ptr() for t in stacked))
    buffers = (ctypes.c_void_p * 8)(*(t.data_ptr() for t in work))
    launch("rt_encoder_stack_int8", ptr(x), ptr(out), ctypes.addressof(weights), ctypes.addressof(buffers),
           ptr(phase_ns), b, s, d, f, num_heads, num_layers, LN_EPS, stream())
    fused_encoder_stack_int8.launches += 1
    return out


fused_encoder_stack_int8.launches = 0


def stack_grid(seq_len: int, head_dim: int) -> tuple[int, int]:
    """(blocks per SM, SMs) of fused_encoder_stack_int8's launch on the
    current card: the grid is their product."""
    out = (ctypes.c_int * 2)()
    launch("rt_encoder_stack_int8_grid", seq_len, head_dim, ctypes.addressof(out))
    return out[0], out[1]


def _stack_shapes(num_layers: int, d: int, f: int) -> list[tuple]:
    """The 16 stacked tensors' shapes, in prepare_layer_int8's order."""
    per_layer = [(d, 3 * d), (3 * d,), (3 * d,), (d, d), (d,), (d,), (d,), (d,),
                 (d, f), (f,), (f,), (f, d), (d,), (d,), (d,), (d,)]
    return [(num_layers, *shape) for shape in per_layer]


def prepare_posenet_int8(posenet, qattn: bool = False, mega: bool = False) -> dict:
    """One-time quantization of a PoseNet for the int8 path; the embedding,
    head and timestep params stay f32. The key the layers go under selects
    the kernels in posenet_apply_prepared, as in the JAX package:
    "layers" (per-layer chain), "layers_qattn" (with `qattn`: the quantized
    attention; an int8 layer tuple has 16 entries either way) or, with
    `mega`, "layers_stacked": the 16 tensors stacked with a leading [L] dim
    for the whole-stack kernel. `mega` takes precedence over `qattn`."""
    layers = tuple(prepare_layer_int8(layer) for layer in posenet.seqTransEncoder.layers)
    if mega:
        entry = {"layers_stacked": tuple(torch.stack([lay[i] for lay in layers]) for i in range(16))}
    else:
        entry = {"layers_qattn" if qattn else "layers": layers}
    return {**entry, **posenet_prep_tail(posenet)}
