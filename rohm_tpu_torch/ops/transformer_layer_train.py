"""PoseNet encoder layer for TRAINING: `--fused_train=bfloat16|float32`.

The port of rohm_tpu/ops/transformer_layer_train.py. The TPU package wraps
one encoder layer in a `jax.custom_vjp` whose forward is one Pallas kernel
(K6, `_fwd_kernel`) and whose backward is another (K7, `_bwd_kernel`,
recomputing the forward in VMEM). Here `fused_train_layer` is a
`torch.autograd.Function` whose forward and backward are chains of
hand-written CUDA kernels (csrc/gemm_train.cu, attention_train.cu,
layernorm_train.cu, colsum.cu), on the module's own parameters in torch's
layout, so autograd writes every gradient straight into `.grad`
(`in_proj_weight.grad` [3D, D] is the TPU kernel's dWqkv [D, 3D] transposed).

Forward (per layer, R = B*S rows; c() = bf16 rounding in the bf16 mode):
  qkv = c(x) c(W_in)^T + b_in                        gemm_train
  attn = attention(qkv, mask_p)                      attention_train_fwd
  od = (c(attn) c(W_o)^T + b_o) * mask_o * inv_keep  gemm_train
  y1, norm1, rstd1 = LN1(x + od)   (one-pass var)    layernorm_train_fwd
  h1 = c(y1) c(W_1)^T + b_1; gld = gelu(h1) * mask_h * inv_keep
  ffd = (c(gld) c(W_2)^T + b_2) * mask_f * inv_keep
  y, norm2, rstd2 = LN2(y1 + ffd)
Backward: the 8 products of _bwd_kernel (dW as dY^T X, dX as dY W), the
attention backward, two LayerNorm backwards and six column sums for the
bias and LayerNorm gradients. The forward's activations are saved (about
230 MB per layer at B = 64, S = 145, D = 512, F = 1024), not recomputed as
K7 does: that spares a third of the step's work at 1.8 GB for 8 layers.

Dropout masks are int8 keep-masks drawn outside the kernels from an
explicit torch.Generator (`gen_dropout_masks`); the TPU package draws them
from rbg keys, which torch cannot reproduce, so tests hand both packages the
same masks. Every kernel's plain PyTorch version sits beside its wrapper,
which takes it only for a CPU tensor; the chains run with either set
(`KERNELS`, `PLAIN`), and the plain module forward
(`models.blocks.TransformerEncoderLayer.forward_train`) is the reference.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from rohm_tpu_torch.ops._build import check_cuda, launch, ptr, stream
from rohm_tpu_torch.ops.kernel_common import LN_EPS
from rohm_tpu_torch.ops.transformer_layer import erf_as

SQRT_2 = 1.4142135623730951
INV_SQRT_2PI = 0.3989422804014327
GEMM_TILES = {True: (64, 64, 32), False: (128, 64, 16)}  # bf16 / f32: (BM, BN, BK)


def gelu_as(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf gelu with the TPU kernel's Abramowitz-Stegun erf
    (rohm_tpu/ops/transformer_layer_train.py:58-61, x / sqrt(2) divided)."""
    return 0.5 * x * (1.0 + erf_as(x / SQRT_2))


def gelu_grad_as(x: torch.Tensor) -> torch.Tensor:
    """Its derivative, erf by A-S and an exact exp (:64-67)."""
    return 0.5 * (1.0 + erf_as(x / SQRT_2)) + x * INV_SQRT_2PI * torch.exp(-0.5 * x * x)


def _rnd(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _keep(mask: torch.Tensor, inv_keep: float) -> torch.Tensor:
    return mask.float() * inv_keep


# ---------------------------------------------------------------------------
# gemm_train
# ---------------------------------------------------------------------------


def gemm_train_plain(a, b, a_t=False, b_t=False, bf16=False, bias=None, mask=None,
                     inv_keep=1.0, gelu=0, aux=None, add=None):
    """op(a) @ op(b) (op = transpose where a_t / b_t), operands rounded to
    bf16 in the bf16 mode, f32 sums, then the epilogue: + bias; gelu=1:
    keep the pre-gelu h and apply gelu (returns (v, h)); * mask * inv_keep;
    gelu=2: * gelu'(aux); add + v."""
    a = a.t() if a_t else a
    b = b.t() if b_t else b
    if bf16:
        a, b = _rnd(a), _rnd(b)
    v = a @ b
    if bias is not None:
        v = v + bias
    h = None
    if gelu == 1:
        h, v = v, gelu_as(v)
    if mask is not None:
        v = v * _keep(mask, inv_keep)
    if gelu == 2:
        v = v * gelu_grad_as(aux)
    if add is not None:
        v = add + v
    return (v, h) if gelu == 1 else v


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _splits(m: int, n: int, k: int, bf16: bool, device) -> tuple[int, int]:
    """Split-K for a product with too few output tiles to fill the card:
    aim at two blocks per SM, each split at least 8 k-steps deep."""
    bm, bn, bk = GEMM_TILES[bf16]
    tiles = _ceil(m, bm) * _ceil(n, bn)
    target = 2 * torch.cuda.get_device_properties(device).multi_processor_count
    splits = max(1, min(_ceil(target, tiles), k // (8 * bk)))
    chunk = _ceil(_ceil(k, splits), bk) * bk
    return _ceil(k, chunk), chunk


def gemm_train(a: torch.Tensor, b: torch.Tensor, a_t: bool = False, b_t: bool = False,
               bf16: bool = False, bias=None, mask=None, inv_keep: float = 1.0, gelu: int = 0,
               aux=None, add=None):
    """The training layer's dense products with fused epilogues (see
    gemm_train_plain): bf16 on WMMA or f32 on SIMT FFMA, f32 in memory.

    Replaces the dense products of _forward_body and _bwd_kernel (K6, K7).
    CUDA: csrc/gemm_train.cu; a weight gradient with too few output tiles
    is split over K and its slices added in a fixed order (no atomics)."""
    if a.device.type == "cpu":
        return gemm_train_plain(a, b, a_t, b_t, bf16, bias, mask, inv_keep, gelu, aux, add)
    check_cuda(a, torch.float32, 2, "a")
    check_cuda(b, torch.float32, 2, "b")
    m, k = (a.shape[1], a.shape[0]) if a_t else a.shape
    kb, n = (b.shape[1], b.shape[0]) if b_t else b.shape
    # the contiguous dimension of each operand and of the output is read
    # and written 4 floats at a time; the row counts are free
    if kb != k or n % 4 or (m if a_t else k) % 4 or (b_t and k % 4):
        raise ValueError(f"gemm_train: shapes {tuple(a.shape)}, {tuple(b.shape)} "
                         f"(a_t={a_t}, b_t={b_t}) unsupported")
    for name, t, dtype, shape in (("bias", bias, torch.float32, (n,)), ("mask", mask, torch.int8, (m, n)),
                                  ("add", add, torch.float32, (m, n))):
        if t is not None:
            check_cuda(t, dtype, len(shape), name)
            if tuple(t.shape) != shape:
                raise ValueError(f"gemm_train: {name} {tuple(t.shape)}, expected {shape}")
    if gelu not in (0, 1, 2):
        raise ValueError(f"gemm_train: gelu={gelu}")
    out = torch.empty(m, n, dtype=torch.float32, device=a.device)
    if gelu == 1:
        aux = torch.empty_like(out)
    elif gelu == 2:
        check_cuda(aux, torch.float32, 2, "aux")
    has_epi = bias is not None or mask is not None or gelu or add is not None
    bk = GEMM_TILES[bf16][2]
    splits, chunk = (1, _ceil(k, bk) * bk) if has_epi else _splits(m, n, k, bf16, a.device)
    ws = torch.empty(splits, m, n, dtype=torch.float32, device=a.device) if splits > 1 else None
    launch("rt_gemm_train", ptr(a), ptr(b), ptr(out), m, n, k, int(a_t), int(b_t), int(bf16),
           ptr(bias), ptr(mask), inv_keep, gelu, ptr(aux), ptr(add), splits, chunk, ptr(ws), stream())
    if bf16:
        gemm_train.launches_bf16 += 1
    else:
        gemm_train.launches_f32 += 1
    return (out, aux) if gelu == 1 else out


gemm_train.launches_bf16 = 0  # counted per operand mode: two kernels of one source
gemm_train.launches_f32 = 0


# ---------------------------------------------------------------------------
# attention_train
# ---------------------------------------------------------------------------


def _heads(t: torch.Tensor, seq_len: int, num_heads: int) -> torch.Tensor:
    rows, d = t.shape
    return t.reshape(rows // seq_len, seq_len, num_heads, d // num_heads).transpose(1, 2)


def _unheads(t: torch.Tensor) -> torch.Tensor:
    b, h, s, dh = t.shape
    return t.transpose(1, 2).reshape(b * s, h * dh)


def _probs(q, k, mask, inv_keep, bf16):
    """(p, pd) of every (sequence, head): f32 scores of c(q) c(k)^T, scaled
    after the product as the TPU kernel does (:118-121)."""
    rnd = _rnd if bf16 else (lambda t: t)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    p = torch.softmax((rnd(q) @ rnd(k).transpose(-1, -2)) * scale, dim=-1)
    return p, p * _keep(mask, inv_keep)


def attention_train_fwd_plain(qkv, mask, seq_len, num_heads, inv_keep=1.0, bf16=False):
    """qkv [B*S, 3D] f32, mask [B, H, S, S] int8 -> [B*S, D] f32."""
    rnd = _rnd if bf16 else (lambda t: t)
    q, k, v = (_heads(t, seq_len, num_heads) for t in qkv.split(qkv.shape[1] // 3, dim=-1))
    _, pd = _probs(q, k, mask, inv_keep, bf16)
    return _unheads(rnd(pd) @ rnd(v))


def attention_train_fwd(qkv: torch.Tensor, mask: torch.Tensor, seq_len: int, num_heads: int,
                        inv_keep: float = 1.0, bf16: bool = False) -> torch.Tensor:
    """Per-(sequence, head) attention with dropout on the probabilities,
    q/k/v read in place from the f32 QKV buffer.

    Replaces the attention of _forward_body (K6). CUDA:
    csrc/attention_train.cu, one block per (48 queries, sequence, head)."""
    if qkv.device.type == "cpu":
        return attention_train_fwd_plain(qkv, mask, seq_len, num_heads, inv_keep, bf16)
    b, dh = _attention_checks(qkv, mask, seq_len, num_heads)
    out = torch.empty(qkv.shape[0], qkv.shape[1] // 3, dtype=torch.float32, device=qkv.device)
    launch("rt_attention_train_fwd", ptr(qkv), ptr(mask), ptr(out), b, seq_len, num_heads, dh,
           1.0 / (dh ** 0.5), inv_keep, int(bf16), stream())
    attention_train_fwd.launches += 1
    return out


attention_train_fwd.launches = 0


def _attention_checks(qkv, mask, seq_len, num_heads) -> tuple[int, int]:
    check_cuda(qkv, torch.float32, 2, "qkv")
    check_cuda(mask, torch.int8, 4, "mask")
    rows, d3 = qkv.shape
    dh = d3 // 3 // num_heads
    b = rows // seq_len
    if rows % seq_len or d3 % (3 * num_heads) or dh % 4 or tuple(mask.shape) != (b, num_heads, seq_len, seq_len):
        raise ValueError(f"attention_train: qkv {tuple(qkv.shape)}, mask {tuple(mask.shape)} "
                         f"for S={seq_len}, H={num_heads}")
    return b, dh


def attention_train_bwd_plain(qkv, da, mask, seq_len, num_heads, inv_keep=1.0, bf16=False):
    """d(qkv) [B*S, 3D] from qkv, d(attn) [B*S, D] and the mask, with the
    probabilities recomputed (_bwd_kernel :259-301)."""
    rnd = _rnd if bf16 else (lambda t: t)
    q, k, v = (_heads(t, seq_len, num_heads) for t in qkv.split(qkv.shape[1] // 3, dim=-1))
    da = _heads(da, seq_len, num_heads)
    p, pd = _probs(q, k, mask, inv_keep, bf16)
    dpd = rnd(da) @ rnd(v).transpose(-1, -2)
    dv = rnd(pd).transpose(-1, -2) @ rnd(da)
    dp = dpd * _keep(mask, inv_keep)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = ds * (1.0 / (q.shape[-1] ** 0.5))
    dq = rnd(ds) @ rnd(k)
    dk = rnd(ds).transpose(-1, -2) @ rnd(q)
    return torch.cat([_unheads(dq), _unheads(dk), _unheads(dv)], dim=-1)


def attention_train_bwd(qkv: torch.Tensor, da: torch.Tensor, mask: torch.Tensor, seq_len: int,
                        num_heads: int, inv_keep: float = 1.0, bf16: bool = False) -> torch.Tensor:
    """The attention backward (dq, dk, dv into one [B*S, 3D] buffer).

    Replaces the attention backward of _bwd_kernel (K7). CUDA:
    csrc/attention_train.cu, two passes (queries, then keys) through a
    [B, H, S, S] scratch of pd and ds; no atomics."""
    if qkv.device.type == "cpu":
        return attention_train_bwd_plain(qkv, da, mask, seq_len, num_heads, inv_keep, bf16)
    b, dh = _attention_checks(qkv, mask, seq_len, num_heads)
    check_cuda(da, torch.float32, 2, "da")
    if tuple(da.shape) != (qkv.shape[0], qkv.shape[1] // 3):
        raise ValueError(f"attention_train_bwd: da {tuple(da.shape)} for qkv {tuple(qkv.shape)}")
    dqkv = torch.empty_like(qkv)
    scratch = torch.empty(2, b, num_heads, seq_len, seq_len, dtype=torch.float32, device=qkv.device)
    launch("rt_attention_train_bwd", ptr(qkv), ptr(da), ptr(mask), ptr(dqkv), ptr(scratch[0]),
           ptr(scratch[1]), b, seq_len, num_heads, dh, 1.0 / (dh ** 0.5), inv_keep, int(bf16),
           stream())
    attention_train_bwd.launches += 1
    return dqkv


attention_train_bwd.launches = 0


# ---------------------------------------------------------------------------
# layernorm_train
# ---------------------------------------------------------------------------


def layernorm_train_fwd_plain(a, b, gamma, beta):
    """LN(a + b) with the one-pass variance -> (y, norm, rstd [R])."""
    r = a + b
    mu = r.mean(-1, keepdim=True)
    var = (r * r).mean(-1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(var + LN_EPS)
    norm = (r - mu) * rstd
    return norm * gamma + beta, norm, rstd[:, 0]


def layernorm_train_fwd(a: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    """Residual + one-pass LayerNorm keeping norm and rstd for the backward.

    Replaces _ln_fwd of _forward_body (K6). CUDA: csrc/layernorm_train.cu,
    one block per row; memory-bound."""
    if a.device.type == "cpu":
        return layernorm_train_fwd_plain(a, b, gamma, beta)
    for name, t, nd in (("a", a, 2), ("b", b, 2), ("gamma", gamma, 1), ("beta", beta, 1)):
        check_cuda(t, torch.float32, nd, name)
    rows, d = a.shape
    if b.shape != a.shape or gamma.shape[0] != d or beta.shape[0] != d:
        raise ValueError("layernorm_train_fwd: shape mismatch")
    y, norm = torch.empty_like(a), torch.empty_like(a)
    rstd = torch.empty(rows, dtype=torch.float32, device=a.device)
    launch("rt_layernorm_train_fwd", ptr(a), ptr(b), ptr(gamma), ptr(beta), ptr(y), ptr(norm),
           ptr(rstd), rows, d, LN_EPS, stream())
    layernorm_train_fwd.launches += 1
    return y, norm, rstd


layernorm_train_fwd.launches = 0


def layernorm_train_bwd_plain(dy, norm, rstd, gamma, mask=None, inv_keep=1.0):
    """_ln_bwd's dr, and dr * mask * inv_keep when a mask is given."""
    gdy = dy * gamma
    m1 = gdy.mean(-1, keepdim=True)
    m2 = (gdy * norm).mean(-1, keepdim=True)
    dr = (gdy - m1 - norm * m2) * rstd[:, None]
    return dr, (dr * _keep(mask, inv_keep) if mask is not None else None)


def layernorm_train_bwd(dy: torch.Tensor, norm: torch.Tensor, rstd: torch.Tensor,
                        gamma: torch.Tensor, mask=None, inv_keep: float = 1.0):
    """The LayerNorm backward per row, with the dropout-ed branch's gradient.

    Replaces _ln_bwd of _bwd_kernel (K7). CUDA: csrc/layernorm_train.cu."""
    if dy.device.type == "cpu":
        return layernorm_train_bwd_plain(dy, norm, rstd, gamma, mask, inv_keep)
    for name, t, nd in (("dy", dy, 2), ("norm", norm, 2), ("rstd", rstd, 1), ("gamma", gamma, 1)):
        check_cuda(t, torch.float32, nd, name)
    rows, d = dy.shape
    if norm.shape != dy.shape or rstd.shape[0] != rows or gamma.shape[0] != d:
        raise ValueError("layernorm_train_bwd: shape mismatch")
    if mask is not None:
        check_cuda(mask, torch.int8, 2, "mask")
        if mask.shape != dy.shape:
            raise ValueError("layernorm_train_bwd: mask shape")
    dr = torch.empty_like(dy)
    drm = torch.empty_like(dy) if mask is not None else None
    launch("rt_layernorm_train_bwd", ptr(dy), ptr(norm), ptr(rstd), ptr(gamma), ptr(mask), inv_keep,
           ptr(dr), ptr(drm), rows, d, stream())
    layernorm_train_bwd.launches += 1
    return dr, drm


layernorm_train_bwd.launches = 0


# ---------------------------------------------------------------------------
# colsum
# ---------------------------------------------------------------------------

COLSUM_ROWS = 64  # rows per stage-1 chunk


def colsum_plain(a, b=None):
    """sum over rows of a, and (with b) of a * b first: (sum a*b, sum a)."""
    if b is None:
        return a.sum(0)
    return (a * b).sum(0), a.sum(0)


def colsum(a: torch.Tensor, b=None):
    """Deterministic column sums (bias and LayerNorm parameter gradients).

    Replaces the per-group gradient sums of _bwd_kernel (K7). CUDA:
    csrc/colsum.cu, chunked partial sums added in a fixed order."""
    if a.device.type == "cpu":
        return colsum_plain(a, b)
    check_cuda(a, torch.float32, 2, "a")
    if b is not None:
        check_cuda(b, torch.float32, 2, "b")
        if b.shape != a.shape:
            raise ValueError("colsum: shape mismatch")
    rows, n = a.shape
    chunks = -(-rows // COLSUM_ROWS)
    out_a = torch.empty(n, dtype=torch.float32, device=a.device)
    out_ab = torch.empty_like(out_a) if b is not None else None
    ws = torch.empty(2, chunks, n, dtype=torch.float32, device=a.device)
    launch("rt_colsum", ptr(a), ptr(b), ptr(out_a), ptr(out_ab), ptr(ws), rows, n, COLSUM_ROWS,
           stream())
    colsum.launches += 1
    return out_a if b is None else (out_ab, out_a)


colsum.launches = 0


# ---------------------------------------------------------------------------
# the layer: forward and backward chains
# ---------------------------------------------------------------------------


class Kernels(NamedTuple):
    gemm: Callable
    attn_fwd: Callable
    attn_bwd: Callable
    ln_fwd: Callable
    ln_bwd: Callable
    colsum: Callable


KERNELS = Kernels(gemm_train, attention_train_fwd, attention_train_bwd, layernorm_train_fwd,
                  layernorm_train_bwd, colsum)
PLAIN = Kernels(gemm_train_plain, attention_train_fwd_plain, attention_train_bwd_plain,
                layernorm_train_fwd_plain, layernorm_train_bwd_plain, colsum_plain)


def layer_params(layer) -> tuple:
    """A TransformerEncoderLayer's 12 parameters in the kernels' order
    (torch layouts: Linear weights [out, in], in_proj_weight [3D, D])."""
    sa = layer.self_attn
    return (sa.in_proj_weight, sa.in_proj_bias, sa.out_proj.weight, sa.out_proj.bias,
            layer.norm1.weight, layer.norm1.bias, layer.linear1.weight, layer.linear1.bias,
            layer.linear2.weight, layer.linear2.bias, layer.norm2.weight, layer.norm2.bias)


def flat_masks(masks: tuple, rows: int) -> tuple:
    """(mask_p [B,H,S,S], mask_o [B,S,D], mask_h [B,S,F], mask_f [B,S,D])
    int8 -> the per-row [R, D|F] views the chains take."""
    mp, mo, mh, mf = masks
    return (mp.contiguous(), mo.reshape(rows, -1).contiguous(), mh.reshape(rows, -1).contiguous(),
            mf.reshape(rows, -1).contiguous())


def layer_train_fwd(x, params, masks, seq_len, num_heads, inv_keep, bf16, k: Kernels = KERNELS):
    """K6's forward on x [R, D] f32 -> (y [R, D], the backward's saved tensors)."""
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = params
    mp, mo, mh, mf = masks
    qkv = k.gemm(x, wqkv, b_t=True, bf16=bf16, bias=bqkv)
    attn = k.attn_fwd(qkv, mp, seq_len, num_heads, inv_keep, bf16)
    od = k.gemm(attn, wo, b_t=True, bf16=bf16, bias=bo, mask=mo, inv_keep=inv_keep)
    y1, norm1, rstd1 = k.ln_fwd(x, od, g1, be1)
    gld, h1 = k.gemm(y1, w1, b_t=True, bf16=bf16, bias=b1, mask=mh, inv_keep=inv_keep, gelu=1)
    ffd = k.gemm(gld, w2, b_t=True, bf16=bf16, bias=b2, mask=mf, inv_keep=inv_keep)
    y, norm2, rstd2 = k.ln_fwd(y1, ffd, g2, be2)
    return y, (x, qkv, attn, y1, norm1, rstd1, h1, gld, norm2, rstd2)


def layer_train_bwd(dy, saved, params, masks, seq_len, num_heads, inv_keep, bf16,
                    k: Kernels = KERNELS):
    """K7's backward: dy [R, D] -> (dx [R, D], the 12 parameter gradients
    in torch's layouts, in layer_params order)."""
    x, qkv, attn, y1, norm1, rstd1, h1, gld, norm2, rstd2 = saved
    wqkv, _, wo, _, g1, _, w1, _, w2, _, g2, _ = params
    mp, mo, mh, mf = masks
    g = dict(bf16=bf16)
    dr2, df = k.ln_bwd(dy, norm2, rstd2, g2, mf, inv_keep)
    dg2, dbe2 = k.colsum(dy, norm2)
    dw2 = k.gemm(df, gld, a_t=True, **g)
    db2 = k.colsum(df)
    dh1 = k.gemm(df, w2, mask=mh, inv_keep=inv_keep, gelu=2, aux=h1, **g)
    dw1 = k.gemm(dh1, y1, a_t=True, **g)
    db1 = k.colsum(dh1)
    dy1 = k.gemm(dh1, w1, add=dr2, **g)
    dr1, do = k.ln_bwd(dy1, norm1, rstd1, g1, mo, inv_keep)
    dg1, dbe1 = k.colsum(dy1, norm1)
    dwo = k.gemm(do, attn, a_t=True, **g)
    dbo = k.colsum(do)
    dattn = k.gemm(do, wo, **g)
    dqkv = k.attn_bwd(qkv, dattn, mp, seq_len, num_heads, inv_keep, bf16)
    dwqkv = k.gemm(dqkv, x, a_t=True, **g)
    dbqkv = k.colsum(dqkv)
    dx = k.gemm(dqkv, wqkv, add=dr1, **g)
    return dx, (dwqkv, dbqkv, dwo, dbo, dg1, dbe1, dw1, db1, dw2, db2, dg2, dbe2)


class _TrainLayer(torch.autograd.Function):
    """y = layer(x) with K6's forward chain and K7's backward chain."""

    @staticmethod
    def forward(ctx, x, masks, cfg, *params):
        num_heads, p, bf16, kernels = cfg
        b, s, d = x.shape
        inv_keep = 1.0 / (1.0 - p) if p > 0 else 1.0
        m = flat_masks(masks, b * s)
        y, saved = layer_train_fwd(x.reshape(b * s, d).float().contiguous(), params, m, s,
                                   num_heads, inv_keep, bf16, kernels)
        ctx.save_for_backward(*saved, *params, *m)
        ctx.cfg = (b, s, d, num_heads, inv_keep, bf16, kernels)
        return y.reshape(b, s, d)

    @staticmethod
    def backward(ctx, dy):
        b, s, d, num_heads, inv_keep, bf16, kernels = ctx.cfg
        t = ctx.saved_tensors
        saved, params, m = t[:10], t[10:22], t[22:]
        dx, grads = layer_train_bwd(dy.reshape(b * s, d).float().contiguous(), saved, params, m, s,
                                    num_heads, inv_keep, bf16, kernels)
        return (dx.reshape(b, s, d), None, None, *grads)


def _is_bf16(dtype: str) -> bool:
    if dtype not in ("bfloat16", "float32"):
        raise ValueError(f"fused_train dtype must be 'bfloat16' or 'float32', got {dtype!r}")
    return dtype == "bfloat16"


def fused_train_layer(layer, x: torch.Tensor, masks: tuple, num_heads: int = 4,
                      dropout_p: float = 0.1, dtype: str = "bfloat16",
                      kernels: Kernels = KERNELS) -> torch.Tensor:
    """One trainable encoder layer (a TransformerEncoderLayer module):
    x [B, S, D] f32 -> [B, S, D] f32, differentiable in x and in every
    parameter of `layer`. masks: this layer's gen_dropout_masks. dtype:
    the GEMM operand mode, "bfloat16" or "float32". kernels=PLAIN runs the
    plain chains (the reference the card checks hold the kernels to)."""
    cfg = (num_heads, float(dropout_p), _is_bf16(dtype), kernels)
    return _TrainLayer.apply(x, masks, cfg, *layer_params(layer))


# ---------------------------------------------------------------------------
# dropout masks and the PoseNet training forward
# ---------------------------------------------------------------------------


def gen_dropout_masks(generator: torch.Generator, b: int, s: int, d: int, f: int, num_heads: int,
                      p: float) -> tuple:
    """int8 keep-masks of one layer, (probs [B,H,S,S], out-proj [B,S,D],
    gelu [B,S,F], FF2 [B,S,D]), each 1 with probability 1 - p, drawn from
    `generator` on its device (all ones, with no draw, at p = 0)."""
    dev = generator.device

    def mk(shape):
        if p <= 0:
            return torch.ones(shape, dtype=torch.int8, device=dev)
        return (torch.rand(shape, generator=generator, device=dev) < 1.0 - p).to(torch.int8)

    return mk((b, num_heads, s, s)), mk((b, s, d)), mk((b, s, f)), mk((b, s, d))


def posenet_dropout_masks(generator: torch.Generator, posenet, bsz: int, seq_len: int) -> tuple:
    """Every dropout mask of one PoseNet training forward over seq_len
    frames (seq_len + 1 tokens): (input keep-mask [B, T+1, D] bool or None
    at p = 0, [per-layer gen_dropout_masks])."""
    p, d = posenet.dropout, posenet.latent_dim
    s = seq_len + 1
    f = posenet.seqTransEncoder.layers[0].linear1.out_features
    keep = None
    if p > 0:
        keep = torch.rand((bsz, s, d), generator=generator, device=generator.device) < 1.0 - p
    layers = [gen_dropout_masks(generator, bsz, s, d, f, posenet.num_heads, p)
              for _ in range(posenet.num_layers)]
    return keep, layers


def posenet_apply_train(posenet, x_t: torch.Tensor, cond: torch.Tensor, t: torch.Tensor,
                        masks: tuple, dtype: str = "bfloat16") -> torch.Tensor:
    """PoseNet TRAINING forward with the encoder layers through
    fused_train_layer (rohm_tpu/ops/transformer_layer_train.py::
    posenet_apply_train); the embeddings, the input dropout and the head
    are plain PyTorch. masks: posenet_dropout_masks(...) or the same
    structure handed in by a caller. PoseNet.forward_train with this
    layer in place of the module's."""
    def layer_fn(layer, seq, m, p):
        return fused_train_layer(layer, seq, m, posenet.num_heads, p, dtype)

    return posenet.forward_train(x_t, cond, t, masks, layer_fn)
