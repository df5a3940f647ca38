"""int8 PoseNet encoder layer: the W8A8 throughput mode (`fused_posenet="int8"`,
and `"int8qa"` with quantized attention).

Replaces rohm_tpu/ops/transformer_layer_int8.py::_layer_kernel_int8 with
qattn=False and qattn=True. Weights are symmetric int8 with one f32 scale per output
column (set once by `prepare_layer_int8`), each a [K, N] tensor stored
K-major (the .t() view of an [N, K] buffer: the layout Hopper's int8 tensor
cores read); each GEMM input is quantized per row right before the product;
int32 accumulation; dequant acc*row*col, then an f32 bias. Attention,
LayerNorm and residuals are those of the bf16 layer.
On the H100 an L-layer stack is a chain of 1 + 9 L launches of five
hand-written CUDA kernels, the LayerNorms writing the codes of what they
write (so 2 L + 1 quant_rows_int8 launches, not 4 L):

  qx   = quant_rows_int8(x)                    the stack's input only
  qkv  = gemm_int8(qx, Wqkv, bqkv, "bf16")     cast to bf16 AFTER the bias
  attn = attention_bf16(qkv)
  a    = gemm_int8(quant_rows_int8(attn), Wo, bo, "f32")
  y, qy = residual_layernorm(x, a, quant)      f32, and y's codes
  h1   = gemm_int8(qy, W1, b1, "gelu")         f32
  h2   = gemm_int8(quant_rows_int8(h1), W2, b2, "f32")
  out, qx = residual_layernorm(y, h2, quant) -> bf16, and its codes for
                                               the next layer (none after the last)

With qattn=True ("int8qa") `attention_int8` (csrc/attention_int8.cu) takes
the place of attention_bf16: both attention products on int8 codes.

The whole stack of L such layers also runs as one launch,
`fused_encoder_stack_int8` (csrc/encoder_stack_int8.cu; replaces
_mega_kernel_int8): a persistent cooperative kernel whose phases are the
chain above, separated by grid-wide barriers, with the intermediates in a
workspace that stays largely in L2. Its phases run the same device
routines as the per-layer kernels (gemm_int8's TMA + wgmma main loop and
epilogue, csrc/layer_routines.cuh's rows and attention), so its output is
bit-identical to L launches of the chain. `prepare_posenet_int8(mega=True)`
files the layers under "layers_stacked" (16 tensors with a leading [L]
dim, the four weights [L, K, N] stored K-major), which selects it in
posenet_apply_prepared.

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
    csrc/quant_rows_int8.cu, one warp per row from registers filled by
    16-byte loads; memory-bound. Each row must start on a 16-byte boundary
    and hold whole 16-byte vectors (C and the row stride multiples of 8
    bf16 or 4 f32 elements); other rows raise ValueError."""
    if x.device.type == "cpu":
        return quant_rows_int8_plain(x, fixed_scale)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quant_rows_int8: x must be bf16 or f32, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"x: expected a CUDA tensor, got {x.device}")
    if x.dim() != 2 or x.stride(1) != 1 or x.stride(0) < x.shape[1]:
        raise ValueError(f"quant_rows_int8: expected rows of contiguous columns, got strides {x.stride()}")
    per_vec = 16 // x.element_size()
    if x.shape[1] % per_vec or x.stride(0) % per_vec or x.data_ptr() % 16:
        raise ValueError(f"quant_rows_int8: rows must start on 16-byte boundaries and hold whole 16-byte vectors "
                         f"(width and row stride multiples of {per_vec}), got {tuple(x.shape)}, strides {x.stride()}")
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
    """f32 [K, N] (any layout) -> (int8 [K, N] stored K-major, strides
    (1, K), f32 col scales [N]): each column quantized as one row of the
    [N, K] buffer, which gives the codes and scales of _quant(w, 0) exactly
    (the same amax, the same product per element). gemm_int8 takes its
    weights only in this layout."""
    q, scale = _quant(w.t().contiguous(), -1)
    return q.t(), scale


def check_gemm_int8_operands(qa: torch.Tensor, w_q: torch.Tensor) -> None:
    """The layout and shape limits of gemm_int8's kernel, on any device:
    qa [M, K], w_q [K, N] stored K-major (strides (1, K), as _quant_cols
    makes it; wgmma reads 8-bit operands only K-major, and a weight in
    another layout is refused, not copied per call), K a multiple of 16
    (TMA's 16-byte row pitch), N a multiple of 4 (the epilogue's four
    columns). Raises ValueError."""
    if qa.dim() != 2 or w_q.dim() != 2:
        raise ValueError(f"gemm_int8: expected 2-D operands, got {tuple(qa.shape)} and {tuple(w_q.shape)}")
    (m, k), (kw, n) = qa.shape, w_q.shape
    if w_q.stride() != (1, kw):
        raise ValueError(f"gemm_int8: w_q [K, N] must be stored K-major (strides (1, K) = (1, {kw}), the .t() "
                         f"view of an [N, K] buffer; prepare_layer_int8 makes it so), got strides {w_q.stride()}")
    if kw != k or m < 1 or k % 16 or n % 4:
        raise ValueError(f"gemm_int8: shapes {tuple(qa.shape)} @ {tuple(w_q.shape)} unsupported "
                         "(K a multiple of 16, N of 4)")


STACKED_WEIGHTS = (0, 3, 8, 11)  # the int8 weights among the 16 stacked tensors


def check_stack_int8_weights(stacked: tuple) -> None:
    """The layout of the whole-stack kernel's weights, on any device: each
    of the four int8 weights [L, K, N] stored K-major (strides (N K, 1, K),
    the .transpose(1, 2) view of a contiguous [L, N, K], as
    prepare_posenet_int8(mega=True) makes it; its tensor maps read [L, N, K]
    and a weight in another layout is refused, not copied per call).
    Raises ValueError."""
    for i in STACKED_WEIGHTS:
        w = stacked[i]
        if w.dim() != 3:
            raise ValueError(f"fused_encoder_stack_int8: stacked[{i}] must be [L, K, N], got {tuple(w.shape)}")
        _, k, n = w.shape
        if w.stride() != (n * k, 1, k):
            raise ValueError(f"fused_encoder_stack_int8: stacked[{i}] [L, K, N] must be stored K-major (strides "
                             f"(N K, 1, K) = ({n * k}, 1, {k}), the .transpose(1, 2) view of a contiguous [L, N, K]; "
                             f"prepare_posenet_int8(mega=True) makes it so), got strides {w.stride()}")


def gemm_int8_plain(qa, row_scale, w_q, col_scale, bias, mode: str) -> torch.Tensor:
    """The W8A8 product in plain PyTorch, on a weight in any layout. The
    int8 values multiply as f32, which is exact: every partial sum is an
    integer below K*127^2 <= 2^24."""
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
    w_q is stored K-major (check_gemm_int8_operands).

    Replaces `_dot_i8` + bias inside _layer_kernel_int8. CUDA:
    csrc/gemm_int8.cu, the TMA + wgmma main loop of csrc/wgmma_gemm.cuh on
    s8 operands; bound by its bytes at the layer's shapes."""
    if qa.device.type == "cpu":
        return gemm_int8_plain(qa, row_scale, w_q, col_scale, bias, mode)
    if mode not in GEMM_INT8_MODES:
        raise ValueError(f"gemm_int8: unknown mode {mode!r}")
    check_cuda(qa, torch.int8, 2, "qa")
    check_gemm_int8_operands(qa, w_q)
    check_cuda(w_q.t(), torch.int8, 2, "w_q^T")
    for t, name in ((row_scale, "row_scale"), (col_scale, "col_scale"), (bias, "bias")):
        check_cuda(t, torch.float32, 1, name)
    m, k = qa.shape
    n = w_q.shape[1]
    if row_scale.shape[0] != m or col_scale.shape[0] != n or bias.shape[0] != n:
        raise ValueError(f"gemm_int8: scales or bias do not match {tuple(qa.shape)} @ {tuple(w_q.shape)}")
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
    csrc/attention_int8.cu. Up to S = ATTENTION_INT8_HEAD_KEYS (dh a
    multiple of 32 up to 128): one block per (sequence, head), K and V
    quantized once into shared memory, each warp's 16 query rows through
    mma.sync s8 with the scores in registers. Past it: one block per (48
    queries, sequence, head), K and V staged and quantized in tiles of up
    to 176 keys (any S), int8 WMMA for both products."""
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
ATTENTION_INT8_HEAD_KEYS = 192  # csrc/attention_int8.cu's HEAD_KEYS: one block per (sequence, head) up to it


def _layer(x2, qx, prepared, seq_len, num_heads, gemm, attention, quant, res_ln, last):
    """One int8 layer on rows x2 [R, D] bf16 and their codes qx, through the
    given kernel functions (wrappers or plain) -> (out [R, D] bf16, out's
    codes, or None for the `last` layer). The LayerNorms write the codes of
    their outputs (residual_layernorm's `quant`)."""
    (wqkv, sqkv, bqkv, wo, so, bo, ln1_s, ln1_b,
     w1, s1, b1, w2, s2, b2, ln2_s, ln2_b) = prepared
    qkv = gemm(*qx, wqkv, sqkv, bqkv, "bf16")
    attn = gemm(*quant(attention(qkv, seq_len, num_heads)), wo, so, bo, "f32")
    y, _, qy = res_ln(x2, attn, ln1_s, ln1_b, True, False, quant=True)
    h1 = gemm(*qy, w1, s1, b1, "gelu")
    h2 = gemm(*quant(h1), w2, s2, b2, "f32")
    _, out, *q_out = res_ln(y, h2, ln2_s, ln2_b, False, True, quant=not last)
    return out, (q_out[0] if q_out else None)


def _layers(x, layers, num_heads, gemm, attention, quant, res_ln):
    """The layers in turn on x [B, S, D] bf16: one quantization of the
    stack's input, then each layer on the codes the one before wrote."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    qx = quant(x2)
    for i, prepared in enumerate(layers):
        x2, qx = _layer(x2, qx, prepared, s, num_heads, gemm, attention, quant, res_ln, i == len(layers) - 1)
    return x2.reshape(b, s, d)


def fused_encoder_layers_int8(x: torch.Tensor, layers, num_heads: int = 4, qattn: bool = False) -> torch.Tensor:
    """A stack of int8 encoder layers, each a 16-tuple of prepare_layer_int8,
    launched layer by layer (1 + 9 L launches). x [B, S, D] bf16 -> [B, S,
    D] bf16; with `qattn` the attention runs on int8 codes too."""
    return _layers(x.to(torch.bfloat16).contiguous(), layers, num_heads, gemm_int8,
                   attention_int8 if qattn else attention_bf16, quant_rows_int8, residual_layernorm)


def fused_encoder_layers_int8_plain(x: torch.Tensor, layers, num_heads: int = 4,
                                    qattn: bool = False) -> torch.Tensor:
    """The same stack through the plain PyTorch versions, on any device."""
    return _layers(x.to(torch.bfloat16), layers, num_heads, gemm_int8_plain,
                   attention_int8_plain if qattn else attention_bf16_plain, quant_rows_int8_plain,
                   residual_layernorm_plain)


def fused_encoder_layer_int8(x: torch.Tensor, prepared: tuple, num_heads: int = 4,
                             qattn: bool = False) -> torch.Tensor:
    """One int8 encoder layer. x [B, S, D] bf16 -> [B, S, D] bf16; with
    `qattn` the attention runs on int8 codes too."""
    return fused_encoder_layers_int8(x, (prepared,), num_heads, qattn)


def fused_encoder_layer_int8_plain(x: torch.Tensor, prepared: tuple, num_heads: int = 4,
                                   qattn: bool = False) -> torch.Tensor:
    """The same layer through the plain PyTorch versions, on any device."""
    return fused_encoder_layers_int8_plain(x, (prepared,), num_heads, qattn)


def prepare_layer_int8(layer) -> tuple:
    """Quantize one TransformerEncoderLayer for the int8 path (call once,
    outside the sampling loop). The four weights are [K, N] (the JAX
    package's [in, out] shape and codes) stored K-major: each quantized per
    row of torch's own [out, in] weight (fuse_qkv's [D, 3D] transposed for
    the fused QKV), then handed out as the .t() view."""
    wqkv, bqkv = fuse_qkv(layer.self_attn)

    def f32(t):
        return t.detach().float().contiguous()

    wqkv_q, sqkv = _quant_cols(wqkv)
    wo_q, so = _quant_cols(f32(layer.self_attn.out_proj.weight).t())
    w1_q, s1 = _quant_cols(f32(layer.linear1.weight).t())
    w2_q, s2 = _quant_cols(f32(layer.linear2.weight).t())
    return (
        wqkv_q, sqkv, f32(bqkv),
        wo_q, so, f32(layer.self_attn.out_proj.bias),
        f32(layer.norm1.weight), f32(layer.norm1.bias),
        w1_q, s1, f32(layer.linear1.bias),
        w2_q, s2, f32(layer.linear2.bias),
        f32(layer.norm2.weight), f32(layer.norm2.bias),
    )


def fused_encoder_stack_int8_plain(x: torch.Tensor, stacked: tuple, num_heads: int = 4) -> torch.Tensor:
    """The whole stack through the plain PyTorch versions: the plain layer
    on each layer's slice of the stacked tensors, on any device."""
    layers = [tuple(t[l] for t in stacked) for l in range(stacked[0].shape[0])]
    return fused_encoder_layers_int8_plain(x, layers, num_heads)


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
    whose phases (the K3 chain's GEMM tiles on the TMA + wgmma s8 main
    loop, attention items and rows, separated by grid-wide barriers) run
    the per-layer kernels' routines: bit-identical to the L-layer
    fused_encoder_layers_int8 chain. The four weights are stored K-major
    (check_stack_int8_weights). The intermediates live in a workspace
    allocated here per call (~66 MB at B=32, S=144). A grid the card cannot
    hold at once raises."""
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
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_encoder_stack_int8: stacked[{i}] is {tuple(t.shape)}, expected {shape}")
    check_stack_int8_weights(stacked)
    for i, t in enumerate(stacked):
        if i in STACKED_WEIGHTS:
            check_cuda(t.transpose(1, 2), torch.int8, 3, f"stacked[{i}]^T")
        else:
            check_cuda(t, torch.float32, t.dim(), f"stacked[{i}]")
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


def stack_grid(seq_len: int, head_dim: int) -> tuple[int, int, int]:
    """(blocks per SM, SMs, threads per block) of fused_encoder_stack_int8's
    launch on the current card: the grid is the product of the first two."""
    out = (ctypes.c_int * 3)()
    launch("rt_encoder_stack_int8_grid", seq_len, head_dim, ctypes.addressof(out))
    return out[0], out[1], out[2]


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
        # each int8 weight stacked as a contiguous [L, N, K] and handed out as
        # its [L, K, N] view, K-major as the stack kernel's tensor maps read
        # it (its wrapper refuses any other layout); a layer's slice is then
        # the per-layer prep's [K, N] view, strides (1, K)
        entry = {"layers_stacked": tuple(
            torch.stack([lay[i].t() for lay in layers]).transpose(1, 2) if i in STACKED_WEIGHTS
            else torch.stack([lay[i] for lay in layers]) for i in range(16))}
    else:
        entry = {"layers_qattn" if qattn else "layers": layers}
    return {**entry, **posenet_prep_tail(posenet)}
