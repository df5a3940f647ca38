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
150 MB per layer in bf16, 230 MB in f32, at B = 64, S = 145, D = 512, F = 1024), not
recomputed as K7 does: that spares a third of the step's work.

In the bf16 mode every product operand lies in device memory as bf16, so
the GEMM's TMA loads move half the bytes and round nothing: the four weight
matrices are cast once per layer call (`cast_weight_mats`, as the TPU
package's `_cast_weight_mats` does outside its kernel), and each activation
operand is cast once where it is made: by the epilogue of the product that
makes it (qkv, gld, dh1, dattn), by the attention backward (its bf16 copy
of dqkv), by the LayerNorm kernel that makes it (y1 forward; df and do, the
masked outputs of the backward) or, for x and attn, by `round_bf16`: 2
casts per layer call. Rounding to nearest even is idempotent, so every
product and both attention kernels see the values that the TPU kernel's
c() gives them.

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
GEMM_TILES = {True: (128, 128, 64), False: (64, 64, 32)}  # bf16 (wgmma) / f32 (3xTF32): (BM, BN, BK)
GEMM_OUTS = ("f32", "operand", "both")


def gelu_as(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf gelu with the TPU kernel's Abramowitz-Stegun erf
    (rohm_tpu/ops/transformer_layer_train.py:58-61, x / sqrt(2) divided)."""
    return 0.5 * x * (1.0 + erf_as(x / SQRT_2))


def gelu_grad_as(x: torch.Tensor) -> torch.Tensor:
    """Its derivative, erf by A-S and an exact exp (:64-67)."""
    return 0.5 * (1.0 + erf_as(x / SQRT_2)) + x * INV_SQRT_2PI * torch.exp(-0.5 * x * x)


def _rnd(t: torch.Tensor) -> torch.Tensor:
    """c(): round to bf16, computing on in f32 (in f64 for an f64 tensor)."""
    return t.to(torch.bfloat16).to(torch.promote_types(t.dtype, torch.float32))


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _keep(mask: torch.Tensor, inv_keep: float) -> torch.Tensor:
    return mask.float() * inv_keep


# ---------------------------------------------------------------------------
# gemm_train
# ---------------------------------------------------------------------------


def _outputs(v: torch.Tensor, out: str, bf16: bool):
    """A product's result as the chain asks for it: "f32"; "operand", the
    next product's operand (bf16 in the bf16 mode); "both", (f32, operand),
    the same tensor twice in the f32 mode."""
    op = v.to(torch.bfloat16) if bf16 else v
    return {"f32": v, "operand": op, "both": (v, op)}[out]


def gemm_train_plain(a, b, a_t=False, b_t=False, bf16=False, bias=None, mask=None,
                     inv_keep=1.0, gelu=0, aux=None, add=None, out="f32"):
    """op(a) @ op(b) (op = transpose where a_t / b_t), operands rounded to
    bf16 in the bf16 mode (a no-op on bf16 operands), f32 sums, then the
    epilogue: + bias; gelu=1: keep the pre-gelu h and apply gelu (returns
    (v, h)); * mask * inv_keep; gelu=2: * gelu'(aux); add + v. `out` picks
    the result's form (_outputs)."""
    a = a.t() if a_t else a
    b = b.t() if b_t else b
    if bf16:
        a, b = _rnd(a.float()), _rnd(b.float())
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
    v = _outputs(v, out, bf16)
    return (v, h) if gelu == 1 else v


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def plan_splits(m: int, n: int, k: int, tile: tuple, sms: int) -> tuple[int, int]:
    """(splits, chunk) of a product with too few output tiles to fill the
    card: aim at two blocks per SM (tiles * splits >= 2 * sms), each split
    at least 8 k-steps deep and a whole number of them."""
    bm, bn, bk = tile
    tiles = _ceil(m, bm) * _ceil(n, bn)
    splits = max(1, min(_ceil(2 * sms, tiles), k // (8 * bk)))
    chunk = _ceil(_ceil(k, splits), bk) * bk
    return _ceil(k, chunk), chunk


def gemm_train(a: torch.Tensor, b: torch.Tensor, a_t: bool = False, b_t: bool = False,
               bf16: bool = False, bias=None, mask=None, inv_keep: float = 1.0, gelu: int = 0,
               aux=None, add=None, out: str = "f32"):
    """The training layer's dense products with fused epilogues (see
    gemm_train_plain): bf16 operands on TMA + wgmma, or f32 operands as
    3xTF32 on mma.sync fed by a cp.async ring (csrc/f32_gemm.cuh). The
    epilogue writes the f32 result and, in the bf16 mode, its bf16 copy as
    the chain asks (`out`).

    Replaces the dense products of _forward_body and _bwd_kernel (K6, K7).
    CUDA: csrc/gemm_train.cu; a weight gradient with too few output tiles
    is split over K and its slices added in a fixed order (no atomics)."""
    if a.device.type == "cpu":
        return gemm_train_plain(a, b, a_t, b_t, bf16, bias, mask, inv_keep, gelu, aux, add, out)
    dtype = torch.bfloat16 if bf16 else torch.float32
    check_cuda(a, dtype, 2, "a")
    check_cuda(b, dtype, 2, "b")
    m, k = (a.shape[1], a.shape[0]) if a_t else a.shape
    kb, n = (b.shape[1], b.shape[0]) if b_t else b.shape
    # the contiguous dimension of each operand and of the output: 16-byte
    # rows for TMA (8 bf16) or 16-byte copies (4 floats); the row counts are free
    align = 8 if bf16 else 4
    if kb != k or n % align or (m if a_t else k) % align or (b_t and k % align):
        raise ValueError(f"gemm_train: shapes {tuple(a.shape)}, {tuple(b.shape)} "
                         f"(a_t={a_t}, b_t={b_t}, bf16={bf16}) unsupported")
    for name, t, tdtype, shape in (("bias", bias, torch.float32, (n,)), ("mask", mask, torch.int8, (m, n)),
                                   ("add", add, torch.float32, (m, n))):
        if t is not None:
            check_cuda(t, tdtype, len(shape), name)
            if tuple(t.shape) != shape:
                raise ValueError(f"gemm_train: {name} {tuple(t.shape)}, expected {shape}")
    if gelu not in (0, 1, 2) or out not in GEMM_OUTS:
        raise ValueError(f"gemm_train: gelu={gelu}, out={out!r}")
    c32 = torch.empty(m, n, dtype=torch.float32, device=a.device) if out != "operand" or not bf16 else None
    c16 = torch.empty(m, n, dtype=torch.bfloat16, device=a.device) if out != "f32" and bf16 else None
    if gelu == 1:
        aux = torch.empty(m, n, dtype=torch.float32, device=a.device)
    elif gelu == 2:
        check_cuda(aux, torch.float32, 2, "aux")
    has_epi = bias is not None or mask is not None or gelu or add is not None
    tile = GEMM_TILES[bf16]
    if has_epi or c16 is not None:
        splits, chunk = 1, _ceil(k, tile[2]) * tile[2]
    else:
        splits, chunk = plan_splits(m, n, k, tile, torch.cuda.get_device_properties(a.device).multi_processor_count)
    ws = torch.empty(splits, m, n, dtype=torch.float32, device=a.device) if splits > 1 else None
    launch("rt_gemm_train", ptr(a), ptr(b), ptr(c32), ptr(c16), m, n, k, int(a_t), int(b_t), int(bf16),
           ptr(bias), ptr(mask), inv_keep, gelu, ptr(aux), ptr(add), splits, chunk, ptr(ws), stream())
    if bf16:
        gemm_train.launches_bf16 += 1
    else:
        gemm_train.launches_f32 += 1
    res = {"f32": c32, "operand": c16 if bf16 else c32, "both": (c32, c16 if bf16 else c32)}[out]
    return (res, aux) if gelu == 1 else res


gemm_train.launches_bf16 = 0  # counted per operand mode: two kernels of one source
gemm_train.launches_f32 = 0


def round_bf16_plain(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x [R, N] f32 -> bf16, round to nearest even: the bf16 mode's cast of
    an activation operand that no kernel hands over in bf16 (x, attn).

    Replaces the TPU kernel's c() on its activation operands
    (rohm_tpu/ops/transformer_layer_train.py:103). CUDA: csrc/gemm_train.cu,
    8 elements per thread and step, a grid that fills the card;
    memory-bound."""
    if x.device.type == "cpu":
        return round_bf16_plain(x)
    check_cuda(x, torch.float32, 2, "x")
    y = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    launch("rt_round_bf16", ptr(x), ptr(y), x.numel(), stream())
    round_bf16.launches += 1
    return y


round_bf16.launches = 0


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
    rnd = _rnd if bf16 else _same
    scale = 1.0 / (q.shape[-1] ** 0.5)
    p = torch.softmax((rnd(q) @ rnd(k).transpose(-1, -2)) * scale, dim=-1)
    return p, p * _keep(mask, inv_keep)


def attention_train_fwd_plain(qkv, mask, seq_len, num_heads, inv_keep=1.0, bf16=False):
    """qkv [B*S, 3D] f32, mask [B, H, S, S] int8 -> [B*S, D] f32."""
    rnd = _rnd if bf16 else _same
    q, k, v = (_heads(t, seq_len, num_heads) for t in qkv.split(qkv.shape[1] // 3, dim=-1))
    _, pd = _probs(q, k, mask, inv_keep, bf16)
    return _unheads(rnd(pd) @ rnd(v))


def attention_train_fwd(qkv: torch.Tensor, mask: torch.Tensor, seq_len: int, num_heads: int,
                        inv_keep: float = 1.0, bf16: bool = False) -> torch.Tensor:
    """Per-(sequence, head) attention with dropout on the probabilities,
    q/k/v read in place from the QKV buffer (bf16 in the bf16 mode, which
    rounds them anyway; f32 in the f32 mode).

    Replaces the attention of _forward_body (K6). CUDA:
    csrc/attention_train.cu, any S: the keys stream through shared memory
    in tiles, and a sequence longer than one tile takes three sweeps (the
    row's max, its sum, then p and P.V), so p is formed from the row's final
    statistics as in the plain version. bf16 mode: tensor cores, dh a
    multiple of 16 up to 128; f32 mode: tensor cores in 3xTF32
    (csrc/attention_tf32.cuh, f32 accuracy), dh a multiple of 4 up to 128."""
    if qkv.device.type == "cpu":
        return attention_train_fwd_plain(qkv, mask, seq_len, num_heads, inv_keep, bf16)
    b, dh = _attention_checks(qkv, mask, seq_len, num_heads, bf16)
    out = torch.empty(qkv.shape[0], qkv.shape[1] // 3, dtype=torch.float32, device=qkv.device)
    launch("rt_attention_train_fwd", ptr(qkv), ptr(mask), ptr(out), b, seq_len, num_heads, dh,
           1.0 / (dh ** 0.5), inv_keep, int(bf16), stream())
    attention_train_fwd.launches += 1
    return out


attention_train_fwd.launches = 0


def _attention_checks(qkv, mask, seq_len, num_heads, bf16) -> tuple[int, int]:
    check_cuda(qkv, torch.bfloat16 if bf16 else torch.float32, 2, "qkv")
    check_cuda(mask, torch.int8, 4, "mask")
    rows, d3 = qkv.shape
    dh = d3 // 3 // num_heads
    b = rows // seq_len
    if (rows % seq_len or d3 % (3 * num_heads) or dh % (16 if bf16 else 4) or dh > 128
            or tuple(mask.shape) != (b, num_heads, seq_len, seq_len)):
        raise ValueError(f"attention_train: qkv {tuple(qkv.shape)}, mask {tuple(mask.shape)} "
                         f"for S={seq_len}, H={num_heads} (dh a multiple of {16 if bf16 else 4} up to 128)")
    return b, dh


def attention_train_bwd_plain(qkv, da, mask, seq_len, num_heads, inv_keep=1.0, bf16=False):
    """d(qkv) [B*S, 3D] from qkv, d(attn) [B*S, D] and the mask, with the
    probabilities recomputed (_bwd_kernel :259-301); in the bf16 mode with
    its bf16 copy beside it, (dqkv, c(dqkv))."""
    rnd = _rnd if bf16 else _same
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
    dqkv = torch.cat([_unheads(dq), _unheads(dk), _unheads(dv)], dim=-1).float()
    return (dqkv, dqkv.to(torch.bfloat16)) if bf16 else dqkv


def attention_train_bwd(qkv: torch.Tensor, da: torch.Tensor, mask: torch.Tensor, seq_len: int,
                        num_heads: int, inv_keep: float = 1.0, bf16: bool = False):
    """The attention backward: dq, dk and dv in one [B*S, 3D] f32 buffer,
    and in the bf16 mode (dqkv, its bf16 copy), the copy being the
    operand of the dWqkv and dx products. qkv and da are bf16 in the bf16
    mode.

    Replaces the attention backward of _bwd_kernel (K7). CUDA:
    csrc/attention_train.cu, any S, no atomics. bf16 mode: one kernel per
    query tile (row statistics, D = sum dp p, dq) and one per key tile
    (dk, dv), p recomputed from q and k, nothing of [B, H, S, S] in
    memory; the score and dpd products are sequential f32 sums on the FMA
    units, as the plain version's f32 GEMM forms them, and the products of
    the rounded operands run on the tensor cores. f32 mode: a query kernel
    and a key kernel of the same plan, all seven products in 3xTF32 on the
    tensor cores (csrc/attention_tf32.cuh, f32 accuracy), dh a multiple of
    4 up to 128."""
    if qkv.device.type == "cpu":
        return attention_train_bwd_plain(qkv, da, mask, seq_len, num_heads, inv_keep, bf16)
    b, dh = _attention_checks(qkv, mask, seq_len, num_heads, bf16)
    check_cuda(da, qkv.dtype, 2, "da")
    if tuple(da.shape) != (qkv.shape[0], qkv.shape[1] // 3):
        raise ValueError(f"attention_train_bwd: da {tuple(da.shape)} for qkv {tuple(qkv.shape)}")
    dqkv = torch.empty(qkv.shape, dtype=torch.float32, device=qkv.device)
    dqkv16 = torch.empty(qkv.shape, dtype=torch.bfloat16, device=qkv.device) if bf16 else None
    # per row: max, sum and D = sum_k dp p, from the query kernel to the key kernel
    work = torch.empty(3, b, num_heads, seq_len, dtype=torch.float32, device=qkv.device)
    launch("rt_attention_train_bwd", ptr(qkv), ptr(da), ptr(mask), ptr(dqkv), ptr(dqkv16), ptr(work), b,
           seq_len, num_heads, dh, 1.0 / (dh ** 0.5), inv_keep, int(bf16), stream())
    attention_train_bwd.launches += 1
    return (dqkv, dqkv16) if bf16 else dqkv


attention_train_bwd.launches = 0


# ---------------------------------------------------------------------------
# layernorm_train
# ---------------------------------------------------------------------------


def layernorm_train_fwd_plain(a, b, gamma, beta, out_bf16=False):
    """LN(a + b) with the one-pass variance -> (y, norm, rstd [R]), and
    with `out_bf16` y's bf16 copy after them."""
    r = a + b
    mu = r.mean(-1, keepdim=True)
    var = (r * r).mean(-1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(var + LN_EPS)
    norm = (r - mu) * rstd
    y = norm * gamma + beta
    return (y, norm, rstd[:, 0], y.to(torch.bfloat16)) if out_bf16 else (y, norm, rstd[:, 0])


def layernorm_train_fwd(a: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        out_bf16: bool = False):
    """Residual + one-pass LayerNorm keeping norm and rstd for the backward;
    with `out_bf16` also y rounded to bf16 (the bf16 mode's operand of FF1),
    stored beside y: (y, norm, rstd, y16).

    Replaces _ln_fwd of _forward_body (K6). CUDA: csrc/layernorm_train.cu,
    one block per row; memory-bound."""
    if a.device.type == "cpu":
        return layernorm_train_fwd_plain(a, b, gamma, beta, out_bf16)
    for name, t, nd in (("a", a, 2), ("b", b, 2), ("gamma", gamma, 1), ("beta", beta, 1)):
        check_cuda(t, torch.float32, nd, name)
    rows, d = a.shape
    if b.shape != a.shape or gamma.shape[0] != d or beta.shape[0] != d:
        raise ValueError("layernorm_train_fwd: shape mismatch")
    y, norm = torch.empty_like(a), torch.empty_like(a)
    rstd = torch.empty(rows, dtype=torch.float32, device=a.device)
    y16 = torch.empty(rows, d, dtype=torch.bfloat16, device=a.device) if out_bf16 else None
    launch("rt_layernorm_train_fwd", ptr(a), ptr(b), ptr(gamma), ptr(beta), ptr(y), ptr(norm),
           ptr(rstd), ptr(y16), rows, d, LN_EPS, stream())
    layernorm_train_fwd.launches += 1
    return (y, norm, rstd, y16) if out_bf16 else (y, norm, rstd)


layernorm_train_fwd.launches = 0


def layernorm_train_bwd_plain(dy, norm, rstd, gamma, mask=None, inv_keep=1.0, out_bf16=False):
    """_ln_bwd's dr, and dr * mask * inv_keep when a mask is given; with
    `out_bf16` the latter's bf16 copy after them."""
    gdy = dy * gamma
    m1 = gdy.mean(-1, keepdim=True)
    m2 = (gdy * norm).mean(-1, keepdim=True)
    dr = (gdy - m1 - norm * m2) * rstd[:, None]
    drm = dr * _keep(mask, inv_keep) if mask is not None else None
    return (dr, drm, drm.to(torch.bfloat16)) if out_bf16 else (dr, drm)


def layernorm_train_bwd(dy: torch.Tensor, norm: torch.Tensor, rstd: torch.Tensor,
                        gamma: torch.Tensor, mask=None, inv_keep: float = 1.0, out_bf16: bool = False):
    """The LayerNorm backward per row, with the dropout-ed branch's gradient;
    with `out_bf16` (a mask given) also that gradient rounded to bf16 (the
    bf16 mode's operand of the next products), stored beside it:
    (dr, dr_masked, dr_masked16).

    Replaces _ln_bwd of _bwd_kernel (K7). CUDA: csrc/layernorm_train.cu."""
    if out_bf16 and mask is None:
        raise ValueError("layernorm_train_bwd: out_bf16 copies the masked output and needs a mask")
    if dy.device.type == "cpu":
        return layernorm_train_bwd_plain(dy, norm, rstd, gamma, mask, inv_keep, out_bf16)
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
    drm16 = torch.empty(rows, d, dtype=torch.bfloat16, device=dy.device) if out_bf16 else None
    launch("rt_layernorm_train_bwd", ptr(dy), ptr(norm), ptr(rstd), ptr(gamma), ptr(mask), inv_keep,
           ptr(dr), ptr(drm), ptr(drm16), rows, d, stream())
    layernorm_train_bwd.launches += 1
    return (dr, drm, drm16) if out_bf16 else (dr, drm)


layernorm_train_bwd.launches = 0


# ---------------------------------------------------------------------------
# colsum
# ---------------------------------------------------------------------------

def colsum_plain(a, b=None):
    """sum over rows of a, and (with b) of a * b first: (sum a*b, sum a)."""
    if b is None:
        return a.sum(0)
    return (a * b).sum(0), a.sum(0)


def colsum(a: torch.Tensor, b=None):
    """Deterministic column sums (bias and LayerNorm parameter gradients).

    Replaces the per-group gradient sums of _bwd_kernel (K7). CUDA:
    csrc/colsum.cu, one launch: a cluster of 8 blocks per 32 columns, each
    block a range of rows in 16-byte loads, the partial sums added in a
    fixed order in shared memory and across the cluster; the same bits
    from run to run. N must be a multiple of 4."""
    if a.device.type == "cpu":
        return colsum_plain(a, b)
    check_cuda(a, torch.float32, 2, "a")
    if b is not None:
        check_cuda(b, torch.float32, 2, "b")
        if b.shape != a.shape:
            raise ValueError("colsum: shape mismatch")
    rows, n = a.shape
    if n % 4:
        raise ValueError(f"colsum: N must be a multiple of 4 (16-byte loads), got {n}")
    out_a = torch.empty(n, dtype=torch.float32, device=a.device)
    out_ab = torch.empty_like(out_a) if b is not None else None
    launch("rt_colsum", ptr(a), ptr(b), ptr(out_a), ptr(out_ab), rows, n, stream())
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
    cast: Callable


KERNELS = Kernels(gemm_train, attention_train_fwd, attention_train_bwd, layernorm_train_fwd,
                  layernorm_train_bwd, colsum, round_bf16)
PLAIN = Kernels(gemm_train_plain, attention_train_fwd_plain, attention_train_bwd_plain,
                layernorm_train_fwd_plain, layernorm_train_bwd_plain, colsum_plain, round_bf16_plain)
WEIGHT_MATS = (0, 2, 6, 8)  # in_proj, out_proj, linear1 and linear2 weights in layer_params order


def layer_params(layer) -> tuple:
    """A TransformerEncoderLayer's 12 parameters in the kernels' order
    (torch layouts: Linear weights [out, in], in_proj_weight [3D, D])."""
    sa = layer.self_attn
    return (sa.in_proj_weight, sa.in_proj_bias, sa.out_proj.weight, sa.out_proj.bias,
            layer.norm1.weight, layer.norm1.bias, layer.linear1.weight, layer.linear1.bias,
            layer.linear2.weight, layer.linear2.bias, layer.norm2.weight, layer.norm2.bias)


def cast_weight_mats(params: tuple) -> tuple:
    """layer_params with the four weight matrices cast to bf16 (once per
    layer call, outside the kernels, as rohm_tpu/ops/
    transformer_layer_train.py::_cast_weight_mats); vectors stay f32."""
    return tuple(p.to(torch.bfloat16) if i in WEIGHT_MATS else p for i, p in enumerate(params))


def flat_masks(masks: tuple, rows: int) -> tuple:
    """(mask_p [B,H,S,S], mask_o [B,S,D], mask_h [B,S,F], mask_f [B,S,D])
    int8 -> the per-row [R, D|F] views the chains take."""
    mp, mo, mh, mf = masks
    return (mp.contiguous(), mo.reshape(rows, -1).contiguous(), mh.reshape(rows, -1).contiguous(),
            mf.reshape(rows, -1).contiguous())


def layer_train_fwd(x, params, masks, seq_len, num_heads, inv_keep, bf16, k: Kernels = KERNELS):
    """K6's forward on x [R, D] f32 -> (y [R, D], the backward's saved
    tensors). params: layer_params, through cast_weight_mats in the bf16
    mode."""
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = params
    mp, mo, mh, mf = masks
    c = k.cast if bf16 else _same
    g = dict(b_t=True, bf16=bf16)
    xc = c(x)
    qkv = k.gemm(xc, wqkv, bias=bqkv, out="operand", **g)
    attn = c(k.attn_fwd(qkv, mp, seq_len, num_heads, inv_keep, bf16))
    od = k.gemm(attn, wo, bias=bo, mask=mo, inv_keep=inv_keep, **g)
    y1, norm1, rstd1, *y1c = k.ln_fwd(x, od, g1, be1, out_bf16=bf16)
    y1c = y1c[0] if bf16 else y1  # LN1's bf16 copy of y1
    gld, h1 = k.gemm(y1c, w1, bias=b1, mask=mh, inv_keep=inv_keep, gelu=1, out="operand", **g)
    ffd = k.gemm(gld, w2, bias=b2, mask=mf, inv_keep=inv_keep, **g)
    y, norm2, rstd2 = k.ln_fwd(y1, ffd, g2, be2)
    return y, (xc, qkv, attn, y1c, norm1, rstd1, h1, gld, norm2, rstd2)


def layer_train_bwd(dy, saved, params, masks, seq_len, num_heads, inv_keep, bf16,
                    k: Kernels = KERNELS):
    """K7's backward: dy [R, D] -> (dx [R, D], the 12 parameter gradients
    in torch's layouts, in layer_params order)."""
    xc, qkv, attn, y1c, norm1, rstd1, h1, gld, norm2, rstd2 = saved
    wqkv, _, wo, _, g1, _, w1, _, w2, _, g2, _ = params
    mp, mo, mh, mf = masks
    g = dict(bf16=bf16)
    dr2, df, *dfc = k.ln_bwd(dy, norm2, rstd2, g2, mf, inv_keep, out_bf16=bf16)
    dfc = dfc[0] if bf16 else df  # the LN2 backward's bf16 copy of df
    dg2, dbe2 = k.colsum(dy, norm2)
    dw2 = k.gemm(dfc, gld, a_t=True, **g)
    db2 = k.colsum(df)
    dh1, dh1c = k.gemm(dfc, w2, mask=mh, inv_keep=inv_keep, gelu=2, aux=h1, out="both", **g)
    dw1 = k.gemm(dh1c, y1c, a_t=True, **g)
    db1 = k.colsum(dh1)
    dy1 = k.gemm(dh1c, w1, add=dr2, **g)
    dr1, do, *doc = k.ln_bwd(dy1, norm1, rstd1, g1, mo, inv_keep, out_bf16=bf16)
    doc = doc[0] if bf16 else do
    dg1, dbe1 = k.colsum(dy1, norm1)
    dwo = k.gemm(doc, attn, a_t=True, **g)
    dbo = k.colsum(do)
    dattn = k.gemm(doc, wo, out="operand", **g)
    dqkv = k.attn_bwd(qkv, dattn, mp, seq_len, num_heads, inv_keep, bf16)
    dqkv, dqkvc = dqkv if bf16 else (dqkv, dqkv)
    dwqkv = k.gemm(dqkvc, xc, a_t=True, **g)
    dbqkv = k.colsum(dqkv)
    dx = k.gemm(dqkvc, wqkv, add=dr1, **g)
    return dx, (dwqkv, dbqkv, dwo, dbo, dg1, dbe1, dw1, db1, dw2, db2, dg2, dbe2)


class _TrainLayer(torch.autograd.Function):
    """y = layer(x) with K6's forward chain and K7's backward chain."""

    @staticmethod
    def forward(ctx, x, masks, cfg, *params):
        num_heads, p, bf16, kernels = cfg
        b, s, d = x.shape
        inv_keep = 1.0 / (1.0 - p) if p > 0 else 1.0
        m = flat_masks(masks, b * s)
        kp = cast_weight_mats(params) if bf16 else params
        y, saved = layer_train_fwd(x.reshape(b * s, d).float().contiguous(), kp, m, s,
                                   num_heads, inv_keep, bf16, kernels)
        ctx.save_for_backward(*saved, *kp, *m)
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
