"""A/B of the port's attention kernels, GEMMs and layers between two checkouts, on one card.

    python -m rohm_tpu_torch.scripts.ab_train_kernels --other DIR [--seed 0]

DIR is another checkout of the repository (for example the parent commit,
`git archive` unpacked into `.chipscratch/parent`). The script runs one
measurement process per checkout in the order other / this / this / other,
each on that checkout's own package and kernels (built at first use), so
the two versions are compared on the same card in turns. Each process
times, at the training shapes (64 clips x 145 tokens, D=512, H=4, F=1024,
dropout 0.1, random weights from --seed): `attention_train_fwd` and
`attention_train_bwd` in both modes, the 12 `gemm_train` products of one
layer in each mode as that checkout's chain calls them (and a digest of
the bf16 products' outputs, which must agree bit for bit where their code
is meant not to change), and the layer's forward and backward in each
mode (and each backward's peak memory), `round_bf16` on the two
activations the bf16 chain casts (x, attn) beside `.to(bfloat16)`, and
the LayerNorms as the bf16 chain runs them (LN1's forward and a backward
with their bf16 operand: one launch where the kernel writes the copy, a
`round_bf16` more where it does not) and without the copy;
`attention_f32` and `attention_train_fwd` in the f32 mode at 8
sequences of 1024 tokens; at the inference shapes (32 clips x 144
tokens): `attention_f32`,
`attention_bf16`, `attention_int8` (also at 32 sequences of its one-block
limit, ATTENTION_INT8_HEAD_KEYS, and one key past it), the four
`gemm_bf16` products of a
bf16 layer (each, their sum, and the host's microseconds to enqueue one),
the four `gemm_int8` products of an int8 layer (each, their sum, and
`torch._int_mm` on the same operands; in this checkout's runs also the
four on two other tile choices, INT8_TILE_VARIANTS, from variant
libraries built once before the runs)
and the four `gemm_f32` products of an f32 layer (each, their sum), the
f32, bf16, int8 and int8qa inference layers (`fused_encoder_layer`,
`fused_encoder_layer_bf16` / `_int8`), `quant_rows_int8` on the int8
layer's four GEMM inputs, its two LayerNorms as the int8 chain runs them
(writing the codes of their outputs where the checkout's
`residual_layernorm` can), the 8-layer int8 chain, the six `colsum`
calls of a training layer's backward (each, and together), and the whole-stack
`encoder_stack_int8` (8 layers, with its phases from the global timer at
its barriers, the median of 9 launches, and its registers and spills from
the build log; in this checkout's runs also two other tile choices and
two blocks per SM, STACK_VARIANTS, each held bit for bit to the shipped
kernel), and one f32 PoseNet step (`posenet_apply_fused`, 32 x 143,
by events) and one int8 and one int8qa step (`posenet_apply_prepared`, by
events and on the card alone). Each is timed with CUDA events around
one call and on the card alone with a cold L2 (card_ms: a CUDA graph of
10 calls, each after a 128 MB write, less a graph of the writes alone);
K5's cooperative launch by events only. It prints one JSON line per
process, then a table with the card's name and power limit. It runs only
on a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import inspect
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

THIS_TREE = Path(__file__).resolve().parents[2]
TB, TS, D, H, F = 64, 145, 512, 4, 1024


def _median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


FLUSH_BYTES = 128 * 2**20  # over twice the H100's 50 MB L2


@functools.cache
def _flush_buffer():
    import torch

    return torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")


def card_ms(fn, calls: int = 10, reps: int = 20) -> float:
    """fn's time on the card alone, with a cold L2: a CUDA graph of `calls`
    calls of fn, each after a 128 MB write that evicts the L2 (so every
    call finds its inputs in device memory, as a layer's chain does), and
    beside it a graph of the writes alone. The two replay in turns; the
    median of their differences over `reps` pairs, per call. No host
    launch cost is inside a replay. chip_smoke.py times with this too."""
    import torch

    flush = _flush_buffer()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up before capture
        flush.zero_()
    torch.cuda.current_stream().wait_stream(side)
    graphs = []
    for with_fn in (True, False):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(calls):
                flush.zero_()
                if with_fn:
                    fn()
        graphs.append(graph)
    for graph in graphs:
        graph.replay()
    diffs = []
    for _ in range(reps):
        times = []
        for graph in graphs:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        diffs.append((times[0] - times[1]) / calls)
    del graphs
    return statistics.median(diffs)


def measure(seed: int, variant_libs: dict | None = None, stack_libs: dict | None = None) -> dict:
    """The numbers of one checkout: whichever `rohm_tpu_torch` is first on
    sys.path. Its chain may stage bf16 operands in memory (round_bf16,
    cast_weight_mats) or round f32 operands inside each product.
    `variant_libs` (name -> library path): gemm_int8's four products also
    through each of those libraries (INT8_TILE_VARIANTS); `stack_libs`
    the same for K5 (STACK_VARIANTS)."""
    import torch

    from rohm_tpu_torch.models import PoseNet
    from rohm_tpu_torch.models.blocks import TransformerEncoderLayer
    from rohm_tpu_torch.ops import kernel_common as kc
    from rohm_tpu_torch.ops import transformer_layer as l32
    from rohm_tpu_torch.ops import transformer_layer_bf16 as l16
    from rohm_tpu_torch.ops import transformer_layer_int8 as l8
    from rohm_tpu_torch.ops import transformer_layer_train as lt

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the A/B measures the card")
    staged = hasattr(lt, "round_bf16")
    torch.manual_seed(seed)  # the layers' initial weights
    g = torch.Generator(device="cuda").manual_seed(seed)
    layer = TransformerEncoderLayer(D, H, F).cuda()
    with torch.no_grad():
        for prm in layer.parameters():
            if prm.dim() == 1:
                prm.add_(0.1 * torch.randn(prm.shape[0], generator=g, device="cuda"))
    params = tuple(t.detach() for t in lt.layer_params(layer))
    kp = lt.cast_weight_mats(params) if staged else params
    wq, bqkv, wo, bo, g1, _, w1, b1, w2, b2, g2, _ = kp
    ik = 1.0 / 0.9
    fm = lt.flat_masks(lt.gen_dropout_masks(g, TB, TS, D, F, H, 0.1), TB * TS)
    mp, mo, mh, mf = fm
    x = torch.randn(TB * TS, D, generator=g, device="cuda")
    dy = torch.randn(TB * TS, D, generator=g, device="cuda")

    # every product's operands as the chain hands them over (the plain chain)
    P = lt.PLAIN
    c = P.cast if staged else (lambda t: t)
    both = {"out": "both"} if staged else {}
    _, saved = lt.layer_train_fwd(x, kp, fm, TS, H, ik, True, P)
    xs, qkv, attn, y1s, norm1, rstd1, h1, gld, norm2, rstd2 = saved
    # qkv, dattn and dqkv's copy bf16 in memory (the attention kernels take bf16 in the bf16 mode)
    bf16_qkv = qkv.dtype == torch.bfloat16
    operand = {"out": "operand"} if bf16_qkv else {}
    dr2, df = P.ln_bwd(dy, norm2, rstd2, g2, mf, ik)
    dfc = c(df)
    dh1 = P.gemm(dfc, w2, bf16=True, mask=mh, inv_keep=ik, gelu=2, aux=h1, **both)
    dh1c = dh1[1] if staged else dh1
    dy1 = P.gemm(dh1c, w1, bf16=True, add=dr2)
    dr1, do = P.ln_bwd(dy1, norm1, rstd1, g1, mo, ik)
    doc = c(do)
    dattn = P.gemm(doc, wo, bf16=True, **operand)
    dqkv = P.attn_bwd(qkv, dattn, mp, TS, H, ik, True)
    dqkvc = dqkv[1] if bf16_qkv else c(dqkv)  # the bf16 copy beside dqkv, or dqkv cast
    products = [
        dict(a=xs, b=wq, b_t=True, bias=bqkv, **operand),
        dict(a=attn, b=wo, b_t=True, bias=bo, mask=mo, inv_keep=ik),
        dict(a=y1s, b=w1, b_t=True, bias=b1, mask=mh, inv_keep=ik, gelu=1, **({"out": "operand"} if staged else {})),
        dict(a=gld, b=w2, b_t=True, bias=b2, mask=mf, inv_keep=ik),
        dict(a=dfc, b=gld, a_t=True),
        dict(a=dfc, b=w2, mask=mh, inv_keep=ik, gelu=2, aux=h1, **both),
        dict(a=dh1c, b=y1s, a_t=True),
        dict(a=dh1c, b=w1, add=dr2),
        dict(a=doc, b=attn, a_t=True),
        dict(a=doc, b=wo, **operand),
        dict(a=dqkvc, b=xs, a_t=True),
        dict(a=dqkvc, b=wq, add=dr1),
    ]

    def gemms():
        return [lt.gemm_train(bf16=True, **kw) for kw in products]

    # the f32 mode's 12 products on the operands of the f32 chain
    wqf, bqkvf, wof, bof, _, _, w1f, b1f, w2f, b2f, _, _ = params
    _, saved32 = lt.layer_train_fwd(x, params, fm, TS, H, ik, False, P)
    x32, qkv32c, attn32, y1_32, norm1_32, rstd1_32, h1_32, gld32, norm2_32, rstd2_32 = saved32
    dr2_32, df32 = P.ln_bwd(dy, norm2_32, rstd2_32, g2, mf, ik)
    dh1_32 = P.gemm(df32, w2f, mask=mh, inv_keep=ik, gelu=2, aux=h1_32)
    dy1_32 = P.gemm(dh1_32, w1f, add=dr2_32)
    dr1_32, do32 = P.ln_bwd(dy1_32, norm1_32, rstd1_32, g1, mo, ik)
    dattn_32 = P.gemm(do32, wof)
    dqkv32 = P.attn_bwd(qkv32c, dattn_32, mp, TS, H, ik, False)
    products32 = [
        dict(a=x32, b=wqf, b_t=True, bias=bqkvf),
        dict(a=attn32, b=wof, b_t=True, bias=bof, mask=mo, inv_keep=ik),
        dict(a=y1_32, b=w1f, b_t=True, bias=b1f, mask=mh, inv_keep=ik, gelu=1),
        dict(a=gld32, b=w2f, b_t=True, bias=b2f, mask=mf, inv_keep=ik),
        dict(a=df32, b=gld32, a_t=True),
        dict(a=df32, b=w2f, mask=mh, inv_keep=ik, gelu=2, aux=h1_32),
        dict(a=dh1_32, b=y1_32, a_t=True),
        dict(a=dh1_32, b=w1f, add=dr2_32),
        dict(a=do32, b=attn32, a_t=True),
        dict(a=do32, b=wof),
        dict(a=dqkv32, b=x32, a_t=True),
        dict(a=dqkv32, b=wqf, add=dr1_32),
    ]

    def gemms32():
        return [lt.gemm_train(bf16=False, **kw) for kw in products32]

    digest = hashlib.sha256()
    for res in gemms():
        for t in res if isinstance(res, tuple) else (res,):
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())

    def attention():
        lt.attention_train_fwd(qkv, mp, TS, H, ik, True)

    def attention_bwd():
        lt.attention_train_bwd(qkv, dattn, mp, TS, H, ik, True)

    qkv32, dattn32 = qkv.float(), dattn.float()

    def attention_f32_mode():
        lt.attention_train_fwd(qkv32, mp, TS, H, ik, False)

    def attention_bwd_f32_mode():
        lt.attention_train_bwd(qkv32, dattn32, mp, TS, H, ik, False)

    # the inference attention kernels and K5 at 32 x 144
    b_inf, s_inf = 32, 144
    qkv_i = torch.randn(b_inf * s_inf, 3 * D, generator=g, device="cuda")
    qkv_i[:, :D] *= (D // H) ** -0.5
    qkv_i16 = qkv_i.to(torch.bfloat16)
    torch.manual_seed(seed)
    stacked = l8.prepare_posenet_int8(PoseNet().cuda(), mega=True)["layers_stacked"]
    x_inf = torch.randn(b_inf, s_inf, D, generator=g, device="cuda").to(torch.bfloat16)
    inference = {
        "attention_f32": lambda: l32.attention_f32(qkv_i, s_inf, H),
        "attention_bf16": lambda: kc.attention_bf16(qkv_i16, s_inf, H),
        "attention_int8": lambda: l8.attention_int8(qkv_i16, s_inf, H),
    }
    # the bf16 and int8 inference layers of a random layer (biases and
    # LayerNorm parameters moved off their initial values), and the four
    # gemm_bf16 products of the bf16 one on operands of its scale
    inf_layer = TransformerEncoderLayer(D, H, F).cuda()
    with torch.no_grad():
        for prm in inf_layer.parameters():
            if prm.dim() == 1:
                prm.add_(0.1 * torch.randn(prm.shape[0], generator=g, device="cuda"))
    p16, p8 = l16.prepare_layer_bf16(inf_layer), l8.prepare_layer_int8(inf_layer)
    rows = b_inf * s_inf
    a_d, a_f = (torch.randn(rows, n, generator=g, device="cuda").to(torch.bfloat16) for n in (D, F))
    x2 = x_inf.reshape(rows, D)
    gemm_bf16 = {
        "gemm_bf16_qkv": lambda: l16.gemm_bf16(x2, p16[0], p16[1], "qkv"),
        "gemm_bf16_out": lambda: l16.gemm_bf16(a_d, p16[2], p16[3], "f32"),
        "gemm_bf16_ff1": lambda: l16.gemm_bf16(x2, p16[6], p16[7], "gelu"),
        "gemm_bf16_ff2": lambda: l16.gemm_bf16(a_f, p16[8], p16[9], "f32"),
    }
    inference.update(gemm_bf16)
    # the f32 layer's four products on its raw weights, operands f32
    sa = inf_layer.self_attn
    x2f, a_df, a_ff = x2.float(), a_d.float(), a_f.float()
    ws = [t.detach() for t in (sa.in_proj_weight, sa.in_proj_bias, sa.out_proj.weight, sa.out_proj.bias,
                               inf_layer.linear1.weight, inf_layer.linear1.bias,
                               inf_layer.linear2.weight, inf_layer.linear2.bias)]
    gemm_f32 = {
        "gemm_f32_qkv": lambda: l32.gemm_f32(x2f, ws[0], ws[1], "qkv", (D // H) ** -0.5, D),
        "gemm_f32_out": lambda: l32.gemm_f32(a_df, ws[2], ws[3], "bias"),
        "gemm_f32_ff1": lambda: l32.gemm_f32(x2f, ws[4], ws[5], "gelu"),
        "gemm_f32_ff2": lambda: l32.gemm_f32(a_ff, ws[6], ws[7], "bias"),
    }
    inference.update(gemm_f32)
    # the f32 attention forwards past one key tile: 8 sequences of 1024
    # (their own generator, so that every input above stays as it was)
    gl = torch.Generator(device="cuda").manual_seed(seed + 1)
    qkv_l = torch.randn(8 * 1024, 3 * D, generator=gl, device="cuda")
    qkv_l[:, :D] *= (D // H) ** -0.5
    mask_l = (torch.rand(8, H, 1024, 1024, generator=gl, device="cuda") >= 0.1).to(torch.int8)
    inference["attention_f32_s1024"] = lambda: l32.attention_f32(qkv_l, 1024, H)
    inference["attention_fwd_f32_mode_s1024"] = lambda: lt.attention_train_fwd(qkv_l, mask_l, 1024, H, ik, False)
    x_inf32 = x_inf.float()
    inference["layer_f32_inf"] = lambda: l32.fused_encoder_layer(x_inf32, inf_layer, H)
    inference["layer_bf16_inf"] = lambda: l16.fused_encoder_layer_bf16(x_inf, p16, H)
    inference["layer_int8_inf"] = lambda: l8.fused_encoder_layer_int8(x_inf, p8, H)
    inference["layer_int8qa_inf"] = lambda: l8.fused_encoder_layer_int8(x_inf, p8, H, qattn=True)
    # attention_int8 at its one-block limit and one past it (32 sequences)
    head_keys = getattr(l8, "ATTENTION_INT8_HEAD_KEYS", 192)
    for s_k4 in (head_keys, head_keys + 1):
        qkv_k4 = torch.randn(b_inf * s_k4, 3 * D, generator=gl, device="cuda")
        qkv_k4[:, :D] *= (D // H) ** -0.5
        q16_k4 = qkv_k4.to(torch.bfloat16)
        inference[f"attention_int8_s{s_k4}"] = functools.partial(l8.attention_int8, q16_k4, s_k4, H)
    # the four gemm_int8 products of the int8 layer on its own weights (K-major
    # where the tree's prep makes them so), and torch._int_mm on the same
    # operands (int32 sums only)
    (qa_d, rs_d), (qa_f, rs_f) = l8.quant_rows_int8(x2), l8.quant_rows_int8(a_f)
    int8_products = {"qkv": (qa_d, rs_d, *p8[0:3], "bf16"), "out": (qa_d, rs_d, *p8[3:6], "f32"),
                     "ff1": (qa_d, rs_d, *p8[8:11], "gelu"), "ff2": (qa_f, rs_f, *p8[11:14], "f32")}
    gemm_int8 = {f"gemm_int8_{name}": functools.partial(l8.gemm_int8, *args) for name, args in int8_products.items()}
    inference.update(gemm_int8)
    int_mm = {f"int_mm_{name}": functools.partial(torch._int_mm, args[0], args[2])
              for name, args in int8_products.items()}
    inference.update(int_mm)
    # round_bf16 on the two activations the bf16 chain casts (x, attn), and
    # .to(bfloat16) on them; the LayerNorms as the bf16 chain runs them: the
    # forward of LN1 and each backward with its bf16 operand (one launch
    # where the kernel writes the copy, plus round_bf16 where it does not)
    gl2 = torch.Generator(device="cuda").manual_seed(seed + 2)
    b_ln = torch.randn(TB * TS, D, generator=gl2, device="cuda")
    _, n_ln, r_ln = lt.layernorm_train_fwd_plain(x, b_ln, g1, kp[5])
    ln_copies = "out_bf16" in inspect.signature(lt.layernorm_train_fwd).parameters

    def ln1_fwd_bf16():
        if ln_copies:
            return lt.layernorm_train_fwd(x, b_ln, g1, kp[5], out_bf16=True)
        return lt.round_bf16(lt.layernorm_train_fwd(x, b_ln, g1, kp[5])[0])

    def ln_bwd_bf16():
        if ln_copies:
            return lt.layernorm_train_bwd(dy, n_ln, r_ln, g2, mf, ik, out_bf16=True)
        return lt.round_bf16(lt.layernorm_train_bwd(dy, n_ln, r_ln, g2, mf, ik)[1])

    inference.update({
        "round_bf16_x": lambda: lt.round_bf16(x), "round_bf16_attn": lambda: lt.round_bf16(attn32),
        "to_bf16_x": lambda: x.to(torch.bfloat16), "to_bf16_attn": lambda: attn32.to(torch.bfloat16),
        "ln_fwd_bf16_ln1": ln1_fwd_bf16, "ln_fwd": lambda: lt.layernorm_train_fwd(x, b_ln, g1, kp[5]),
        "ln_bwd_bf16": ln_bwd_bf16, "ln_bwd": lambda: lt.layernorm_train_bwd(dy, n_ln, r_ln, g2, mf, ik),
    })

    # quant_rows_int8 on the int8 layer's four GEMM inputs, the two
    # LayerNorms as the int8 chain runs them (writing the codes of their
    # outputs where the tree's residual_layernorm can), the 8-layer int8
    # chain, and the six colsum calls of a training layer's backward
    y_q, h1_q = (torch.randn(rows, n, generator=gl2, device="cuda") for n in (D, F))
    folded = "quant" in inspect.signature(kc.residual_layernorm).parameters
    codes = {"quant": True} if folded else {}
    inference.update({
        "quant_rows_int8_x": lambda: l8.quant_rows_int8(x2), "quant_rows_int8_attn": lambda: l8.quant_rows_int8(a_d),
        "quant_rows_int8_y": lambda: l8.quant_rows_int8(y_q), "quant_rows_int8_h1": lambda: l8.quant_rows_int8(h1_q),
        "residual_layernorm_ln1_int8": lambda: kc.residual_layernorm(x2, y_q, p8[6], p8[7], True, False, **codes),
        "residual_layernorm_ln2_int8": lambda: kc.residual_layernorm(y_q, a_df, p8[14], p8[15], False, True, **codes),
    })
    layers8 = l8.prepare_posenet_int8(PoseNet().cuda())["layers"]
    if hasattr(l8, "fused_encoder_layers_int8"):
        inference["int8_chain_8_layers"] = lambda: l8.fused_encoder_layers_int8(x_inf, layers8, H)
    else:
        inference["int8_chain_8_layers"] = lambda: functools.reduce(
            lambda xx, prep: l8.fused_encoder_layer_int8(xx, prep, H), layers8, x_inf)
    cs = [torch.randn(TB * TS, n, generator=gl2, device="cuda") for n in (D, D, F, 3 * D)]
    colsum_calls = ((cs[0], cs[1]), (cs[0], None), (cs[2], None), (cs[1], cs[0]), (cs[1], None), (cs[3], None))
    for i, (a_, b_) in enumerate(colsum_calls):
        inference[f"colsum_{i}_n{a_.shape[1]}{'_ab' if b_ is not None else ''}"] = functools.partial(lt.colsum, a_, b_)

    def fwd():
        return lt.layer_train_fwd(x, kp, fm, TS, H, ik, True)

    _, saved_k = fwd()

    def bwd():
        lt.layer_train_bwd(dy, saved_k, kp, fm, TS, H, ik, True)

    def fwd32():
        return lt.layer_train_fwd(x, params, fm, TS, H, ik, False)

    _, saved32_k = fwd32()

    def bwd32():
        lt.layer_train_bwd(dy, saved32_k, params, fm, TS, H, ik, False)

    out = {"tree": str(Path(lt.__file__).resolve().parents[2]), "staged": staged, "bf16_qkv": bf16_qkv,
           "gemm_12_digest": digest.hexdigest()[:16], "ln_codes_folded": folded}
    for name, fn in (("attention_fwd", attention), ("attention_bwd", attention_bwd),
                     ("attention_fwd_f32_mode", attention_f32_mode), ("attention_bwd_f32_mode", attention_bwd_f32_mode),
                     ("gemm_12", gemms), ("layer_fwd", fwd), ("layer_bwd", bwd), ("gemm_12_f32", gemms32),
                     ("layer_fwd_f32", fwd32), ("layer_bwd_f32", bwd32), *inference.items()):
        out[f"{name}_card_ms"], out[f"{name}_ms"] = card_ms(fn), _median_ms(fn)
    out["gemm_bf16_4_card_ms"] = sum(out[f"{name}_card_ms"] for name in gemm_bf16)
    out["gemm_int8_4_card_ms"] = sum(out[f"{name}_card_ms"] for name in gemm_int8)
    out["int_mm_4_card_ms"] = sum(out[f"{name}_card_ms"] for name in int_mm)
    out["quant_rows_int8_4_card_ms"] = sum(out[f"quant_rows_int8_{n}_card_ms"] for n in ("x", "attn", "y", "h1"))
    out["colsum_6_card_ms"] = sum(v for k, v in out.items() if k.startswith("colsum_") and k.endswith("_card_ms"))
    for variant, path in (variant_libs or {}).items():
        # the four products on the variant library's tiles
        from rohm_tpu_torch.ops import _build
        from rohm_tpu_torch.scripts.f32_gemm_variants import _load

        shipped = _build.library
        lib = _load(Path(path), ("rt_gemm_int8",))
        _build.library = lambda lib=lib: lib
        try:
            for name, fn in gemm_int8.items():
                out[f"{name}_{variant}_card_ms"] = card_ms(fn)
        finally:
            _build.library = shipped
    out["gemm_f32_4_card_ms"] = sum(out[f"{name}_card_ms"] for name in gemm_f32)
    out["gemm_f32_4_ms"] = sum(out[f"{name}_ms"] for name in gemm_f32)
    # the host's time to enqueue one gemm_bf16 call (wrapper, checks,
    # allocation, launch), with the card kept ahead of it
    fn = gemm_bf16["gemm_bf16_qkv"]
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        fn()
    out["gemm_bf16_host_us"] = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    # device time per kernel of the two attention backwards (torch.profiler)
    for name, fn in (("attention_bwd", attention_bwd), ("attention_bwd_f32_mode", attention_bwd_f32_mode)):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        out[f"{name}_kernels_us"] = {e.key.split("(__nv_bfloat16")[0].split("(float")[0][-70:]: e.self_device_time_total / 10
                                     for e in prof.key_averages()
                                     if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total}
    for name, fn in (("layer_bwd", bwd), ("layer_bwd_f32", bwd32)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        fn()
        out[f"{name}_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        out[f"{name}_above_mib"] = (torch.cuda.max_memory_allocated() - held) / 2**20
    # one f32 PoseNet step (8 layers, 32 x 143 frames), as the sampling loop
    # calls it: CUDA events around the call, as chip_smoke.py times it
    from rohm_tpu_torch.ops import embed_cond_f32, posenet_apply_fused

    torch.manual_seed(seed)
    posenet = PoseNet().cuda()
    x_p, cond_p = (torch.randn(b_inf, s_inf - 1, 294, generator=gl, device="cuda") for _ in range(2))
    with torch.no_grad():
        cond_emb = embed_cond_f32(posenet, cond_p)
        out["posenet_step_f32_ms"] = _median_ms(lambda: posenet_apply_fused(posenet, x_p, cond_p, 500,
                                                                            cond_emb=cond_emb))
        # the int8 and int8qa steps (the chain bench.py times), by events and
        # on the card alone
        from rohm_tpu_torch.ops import embed_cond, posenet_apply_prepared

        t_dev = torch.full((b_inf,), 500, dtype=torch.long, device="cuda")  # no host copy inside a graph
        for mode, qattn in (("int8", False), ("int8qa", True)):
            prep = l8.prepare_posenet_int8(posenet, qattn=qattn)
            emb = embed_cond(prep, cond_p)

            def step(prep=prep, emb=emb):
                return posenet_apply_prepared(prep, x_p, cond_p, t_dev, num_heads=H, cond_emb=emb)

            out[f"posenet_step_{mode}_ms"], out[f"posenet_step_{mode}_card_ms"] = _median_ms(step), card_ms(step)
    from rohm_tpu_torch.ops import _build

    shipped = _stack_numbers(l8, x_inf, stacked, s_inf, "encoder_stack_int8", out,
                             _build.BUILD_ROOT / _build.source_hash() / "build.log")
    for variant, path in (stack_libs or {}).items():
        # K5 built with another tile choice or block shape: its numbers, and
        # whether its output is the shipped kernel's bit for bit
        from rohm_tpu_torch.scripts.f32_gemm_variants import _load

        shipped_lib = _build.library
        lib = _load(Path(path), ("rt_encoder_stack_int8", "rt_encoder_stack_int8_grid"))
        _build.library = lambda lib=lib: lib
        try:
            got = _stack_numbers(l8, x_inf, stacked, s_inf, f"encoder_stack_int8_{variant}", out,
                                 Path(path).parent / "build.log")
            out[f"encoder_stack_int8_{variant}_same"] = bool(torch.equal(got, shipped))
        finally:
            _build.library = shipped_lib
    # attention_int8's registers and spills, from the tree's build log: its
    # one-block kernel per count of 32-key blocks, and the key-tiled one
    log = (_build.BUILD_ROOT / _build.source_hash() / "build.log").read_text().splitlines()
    for i, line in enumerate(log):
        if "Function properties for" in line and "attention_int8_" in line and "_kernel" in line:
            name = "head_" + line.split("head_kernelILi")[1][0] if "head_kernelILi" in line else "tiled"
            out[f"attention_int8_build_{name}"] = " ".join(x.strip() for x in log[i + 1:i + 3])
    return out


def _stack_numbers(l8, x, stacked, seq_len: int, label: str, out: dict, build_log: Path):
    """K5 on x by events (median of 20), its phases from the global timer
    at its barriers (the median of 9 stamped launches per phase), its grid
    and its registers and spills from `build_log`, under keys that start
    with `label`. Returns its output."""
    import torch

    out[f"{label}_ms"] = _median_ms(lambda: l8.fused_encoder_stack_int8(x, stacked, H))
    per_launch = []
    for _ in range(9):
        stamps = torch.zeros(2 + 9 * 8, dtype=torch.int64, device="cuda")
        l8.fused_encoder_stack_int8(x, stacked, H, phase_ns=stamps)
        per_launch.append((stamps[1:] - stamps[:-1]).tolist())
    for j, name in enumerate(l8.STACK_PHASES):
        out[f"{label}_{name.replace(' ', '_')}_us"] = statistics.median(
            sum(gaps[1 + 9 * i + j] for i in range(8)) / 1e3 for gaps in per_launch)
    out[f"{label}_phases_total_us"] = statistics.median(sum(gaps) / 1e3 for gaps in per_launch)
    log = build_log.read_text().splitlines()
    for i, line in enumerate(log):
        if "Function properties for" in line and "encoder_stack_int8_kernelILb0" in line:
            out[f"{label}_build"] = " ".join(x.strip() for x in log[i + 1:i + 3])
    out[f"{label}_grid"] = list(l8.stack_grid(seq_len, D // H))
    return l8.fused_encoder_stack_int8(x, stacked, H)


# gemm_int8.cu's tile widths (128 above N = WIDE_ABOVE, NARROW_BN up to it)
# and the variants the A/B times beside them: every product on 128-wide
# tiles; 64-wide ones for N <= 512 only (FF1 on 128); 64-wide for all four
INT8_TILES = "constexpr int NARROW_BN = 64, WIDE_ABOVE = 1024;"
INT8_TILE_VARIANTS = {"bn128": "constexpr int NARROW_BN = 128, WIDE_ABOVE = 1024;",
                      "bn64_to_512": "constexpr int NARROW_BN = 64, WIDE_ABOVE = 512;",
                      "bn64_all": "constexpr int NARROW_BN = 64, WIDE_ABOVE = 1 << 30;"}


# encoder_stack_int8.cu's tile width per GEMM phase and its block shape
# (one block of 288 threads per SM, at most 168 registers a thread, every
# phase on 64-wide tiles), and the variants the A/B times beside them: the
# QKV phase on 128-wide tiles; every phase on 128-wide ones; two blocks
# per SM (at most 96 registers a thread)
STACK_TILES = "constexpr int BN_QKV = 64, BN_OUT = 64, BN_FF1 = 64, BN_FF2 = 64;"
STACK_BLOCKS = "constexpr int BLOCKS_PER_SM = 1;"
STACK_VARIANTS = {
    "bn128_qkv": (STACK_TILES, "constexpr int BN_QKV = 128, BN_OUT = 64, BN_FF1 = 64, BN_FF2 = 64;"),
    "bn128_all": (STACK_TILES, "constexpr int BN_QKV = 128, BN_OUT = 128, BN_FF1 = 128, BN_FF2 = 128;"),
    "two_blocks_per_sm": (STACK_BLOCKS, "constexpr int BLOCKS_PER_SM = 2;"),
}


def _tile_variants() -> tuple[dict, dict]:
    """name -> the path of this tree's gemm_int8.cu (INT8_TILE_VARIANTS)
    and of its encoder_stack_int8.cu (STACK_VARIANTS) built with that
    choice into a library of its own (every nvcc at once)."""
    from rohm_tpu_torch.scripts.f32_gemm_variants import build_libraries

    gemms = build_libraries({f"gemm_int8 {name}": [("gemm_int8.cu", INT8_TILES, text)]
                             for name, text in INT8_TILE_VARIANTS.items()}, ("gemm_int8.cu",), ("rt_gemm_int8",))
    stacks = build_libraries({f"encoder_stack_int8 {name}": [("encoder_stack_int8.cu", *edit)]
                              for name, edit in STACK_VARIANTS.items()}, ("encoder_stack_int8.cu",),
                             ("rt_encoder_stack_int8", "rt_encoder_stack_int8_grid"))
    return ({name: gemms[f"gemm_int8 {name}"]._name for name in INT8_TILE_VARIANTS},
            {name: stacks[f"encoder_stack_int8 {name}"]._name for name in STACK_VARIANTS})


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--other", help="the other checkout (its root directory)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--variant-lib", action="append", default=[], help=argparse.SUPPRESS)
    parser.add_argument("--stack-lib", action="append", default=[], help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.measure:
        print(json.dumps(measure(args.seed, dict(v.split("=", 1) for v in args.variant_lib),
                                 dict(v.split("=", 1) for v in args.stack_lib))), flush=True)
        return []
    if not args.other:
        parser.error("--other is required")
    other = Path(args.other).resolve()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    variants, stack_variants = _tile_variants()
    runs = []
    for label, tree in (("other", other), ("this", THIS_TREE), ("this", THIS_TREE), ("other", other)):
        env = {**os.environ, "PYTHONPATH": str(tree)}
        extra = ([f"--variant-lib={name}={path}" for name, path in variants.items()]
                 + [f"--stack-lib={name}={path}" for name, path in stack_variants.items()]) if label == "this" else []
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--measure", f"--seed={args.seed}",
                               *extra], cwd=tree, env=env, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"the {label} run failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        res = {"run": label, **json.loads(proc.stdout.strip().splitlines()[-1])}
        print(json.dumps(res), flush=True)
        runs.append(res)
    keys = [k for k in dict.fromkeys(k for r in runs for k in r)
            if k.endswith(("_ms", "_mib", "_us")) and any(isinstance(r.get(k), float) for r in runs)]
    print(f"{card}; ms, runs in order " + " / ".join(r["run"] for r in runs))
    for k in keys:
        print(f"{k:36s} " + " / ".join(f"{r[k]:.4f}" if k in r else "-" for r in runs))
    for k in dict.fromkeys(k for r in runs for k in r):
        if k in ("gemm_12_digest", "ln_codes_folded") or k.endswith(("_grid", "_same")) or "_build" in k:
            print(f"{k:36s} " + " / ".join(str(r.get(k, "-")) for r in runs))
    return runs


if __name__ == "__main__":
    main()
