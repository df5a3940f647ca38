"""Smoke run of the PyTorch port on one CUDA GPU: build, check, drive.

    python3 chip_smoke.py [--seed 0]

Phases (each failure ends the run with a non-zero exit code):
  1. device: the card's name and power limit; no CUDA device is an error.
  2. build: nvcc builds rohm_tpu_torch/ops/csrc into rohm_tpu_torch/_build/,
     one nvcc process per source, all at once.
  3. kernels: every CUDA kernel of the PoseNet encoder layers, and each whole
     layer (bf16, int8, int8qa, f32), against its plain PyTorch version on
     the card, at the main path's shapes (32 clips x 144 tokens, D=512, H=4,
     F=1024): max/mean abs error within the stated tolerance, median
     CUDA-event times.
  4. slice: the full-width AMASS inference pipeline (TrajNet + TrajControl
     mid_dim 512, PoseNet 512d x 8 layers, synthetic SMPL-X body, cosine
     100/1000-step schedules, skating guidance, 2 iterations, lower-body
     mask) on batches of 32 clips x 144 frames built with the port's own FK
     and encoder, through RohmPipeline.run_batch with fused_posenet "int8"
     and "bf16". Weights are random from --seed. Checks shapes, finiteness,
     the kernels' launch counts, and the fused PoseNet of every mode (bf16,
     int8, int8qa, f32) against the plain f32 PoseNet on one step.
  5. breakdown: each piece of a batch (TrajNet step, bridge, guidance
     gradient, PoseNet step per mode) timed alone, the batch predicted
     from them, and the device's busy share over PoseNet steps.
  6. cli: `rohm_tpu_torch.cli.test_amass_full.main` at full width with the
     shipped amass_occ_leg_noise_3.yaml, on a synthetic AMASS test tree
     (3 x 11 sequences of 149 frames) and a real-size synthetic SMPL-X .npz,
     one batch of 32 clips with fused_posenet "f32" and one with "int8qa",
     then `eval_amass_full.main` on each pickle. Checks the launch counts,
     the pickle's keys, shapes and finiteness.
The second-to-last stdout line is the kernels' JSON (launches: the slice's
and the CLI's runs); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import functools
import json
import pickle
import shutil
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from rohm_tpu_torch.body.model import SMPLX_PARENTS, forward_joints, synthetic_model
from rohm_tpu_torch.diffusion.schedule import make_schedule
from rohm_tpu_torch.models import PoseNet, TrajNet
from rohm_tpu_torch.ops import _build, kernel_common as kc
from rohm_tpu_torch.ops import transformer_layer as l32
from rohm_tpu_torch.ops import transformer_layer_bf16 as l16
from rohm_tpu_torch.ops import transformer_layer_int8 as l8
from rohm_tpu_torch.pipeline import RohmPipeline, amass_eval_pose_mask, traj_to_pose_bridge
from rohm_tpu_torch.reprs.encode import get_repr
from rohm_tpu_torch.reprs.schema import REPR_DIM_DICT, REPR_LIST, TRAJ_ABS_INDEX

B, S, D, H, F, LAYERS = 32, 144, 512, 4, 1024, 8
CLIP_LEN = 145  # frames per clip -> 144 repr frames (TrajNet) -> 143 (PoseNet)
N_INT8, N_BF16 = 2, 1  # batches through run_batch per mode
KERNELS = {  # name -> (wrapper, its launch counter, source, the TPU kernel it replaces a part of)
    # attention_bf16 and residual_layernorm serve the int8 layer too
    # (rohm_tpu/ops/transformer_layer_int8.py:106 calls the same helpers)
    "gemm_bf16": (l16.gemm_bf16, "launches", "rohm_tpu_torch/ops/csrc/gemm_bf16.cu",
                  "rohm_tpu/ops/transformer_layer_bf16.py:42"),
    "attention_bf16": (kc.attention_bf16, "launches", "rohm_tpu_torch/ops/csrc/attention_bf16.cu",
                       "rohm_tpu/ops/transformer_layer_bf16.py:42"),
    "residual_layernorm": (kc.residual_layernorm, "launches", "rohm_tpu_torch/ops/csrc/residual_layernorm.cu",
                           "rohm_tpu/ops/transformer_layer_bf16.py:42"),
    "quant_rows_int8": (l8.quant_rows_int8, "launches", "rohm_tpu_torch/ops/csrc/quant_rows_int8.cu",
                        "rohm_tpu/ops/transformer_layer_int8.py:106"),
    "gemm_int8": (l8.gemm_int8, "launches", "rohm_tpu_torch/ops/csrc/gemm_int8.cu",
                  "rohm_tpu/ops/transformer_layer_int8.py:106"),
    "gemm_f32": (l32.gemm_f32, "launches", "rohm_tpu_torch/ops/csrc/gemm_f32.cu",
                 "rohm_tpu/ops/transformer_layer.py:37"),
    "attention_f32": (l32.attention_f32, "launches", "rohm_tpu_torch/ops/csrc/attention_f32.cu",
                      "rohm_tpu/ops/transformer_layer.py:37"),
    # the f32 layer's LayerNorm: the same source in its two-pass mode
    "residual_layernorm two-pass": (kc.residual_layernorm, "two_pass_launches",
                                    "rohm_tpu_torch/ops/csrc/residual_layernorm.cu",
                                    "rohm_tpu/ops/transformer_layer.py:37"),
    "attention_int8": (l8.attention_int8, "launches", "rohm_tpu_torch/ops/csrc/attention_int8.cu",
                       "rohm_tpu/ops/transformer_layer_int8.py:68"),
}
BF16_ULP = 2.0 ** -7  # bf16 spacing relative to |x| is at most 2^-7


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_launches() -> None:
    for fn, counter, _, _ in KERNELS.values():
        setattr(fn, counter, 0)


def read_launches() -> dict:
    return {name: getattr(fn, counter) for name, (fn, counter, _, _) in KERNELS.items()}


# ---------------------------------------------------------------------------
# phases 1-2
# ---------------------------------------------------------------------------


def device_phase() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py measures the GPU and has no CPU fallback")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def build_phase() -> None:
    t0 = time.perf_counter()
    lib_path, nvcc_s = _build.build()
    _build.library()
    log(f"[build] {lib_path} nvcc {nvcc_s:.1f} s, total {time.perf_counter() - t0:.1f} s")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line.lower() or "error" in line.lower():
            log(f"[build] {line.strip()}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
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


def _check(name: str, got, ref, tol, why: str, stats: dict, kernel: str) -> None:
    """Elementwise |got - ref| <= tol (tol a number or a tensor)."""
    err = (got.float() - ref.float()).abs()
    ok = bool((err <= tol).all())
    max_err, mean_err = err.max().item(), err.mean().item()
    log(f"[kernels] {name}: max_abs_err {max_err:.3e} mean_abs_err {mean_err:.3e} "
        f"({'ok' if ok else 'FAIL'}: {why})")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: max err {max_err}")
    stats[kernel]["max_abs_err"] = max(stats[kernel]["max_abs_err"], max_err)


def _time(name: str, kernel_fn, plain_fn, stats: dict, kernel: str) -> None:
    ms, plain_ms = median_ms(kernel_fn), median_ms(plain_fn)
    log(f"[kernels] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20)")
    stats[kernel]["ms"] += ms
    stats[kernel]["plain_ms"] += plain_ms


def kernel_phase(seed: int) -> dict:
    """Each kernel at every shape one layer gives it. stats[kernel]["ms"] is
    the summed median time of the kernel's launches in one layer."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    r = B * S

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    stats = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0} for k in KERNELS}
    posenet = PoseNet().to(dev)
    layer = posenet.seqTransEncoder.layers[0]
    p16, p8 = l16.prepare_layer_bf16(layer), l8.prepare_layer_int8(layer)
    x = randn(B, S, D).to(torch.bfloat16)
    x2 = x.reshape(r, D)

    # gemm_bf16: the four products of one bf16 layer
    attn_in = randn(r, D).to(torch.bfloat16)
    h1_in = randn(r, F).to(torch.bfloat16)
    for name, a, w, bias, mode in (
        ("gemm_bf16 qkv [4608,512]x[512,1536]", x2, p16[0], p16[1], "qkv"),
        ("gemm_bf16 out [4608,512]x[512,512]", attn_in, p16[2], p16[3], "f32"),
        ("gemm_bf16 ff1+gelu [4608,512]x[512,1024]", x2, p16[6], p16[7], "gelu"),
        ("gemm_bf16 ff2 [4608,1024]x[1024,512]", h1_in, p16[8], p16[9], "f32"),
    ):
        got, ref = l16.gemm_bf16(a, w, bias, mode), l16.gemm_bf16_plain(a, w, bias, mode)
        if mode == "f32":
            # f32 sums in another order (WMMA tiles vs cuBLAS): relative
            # error ~sqrt(K) * 2^-24 of the row's magnitude
            tol = 1e-5 * ref.abs().max().item() + 1e-6
            why = "f32 accumulation order, 1e-5 of max|ref|"
        else:
            # the f32 sums differ in order, which may flip one bf16 rounding
            # of the product (and of the sum with a bf16 bias)
            tol = BF16_ULP * (ref.float().abs() + bias.float().abs()) + 1e-5
            why = "one bf16 ulp of |ref| + |bias|"
        _check(name, got, ref, tol, why, stats, "gemm_bf16")
        _time(name, lambda: l16.gemm_bf16(a, w, bias, mode),
              lambda: l16.gemm_bf16_plain(a, w, bias, mode), stats, "gemm_bf16")

    # attention_bf16 on a QKV buffer of the layer's scale
    qkv = l16.gemm_bf16(x2, p16[0], p16[1], "qkv")
    got, ref = kc.attention_bf16(qkv, S, H), kc.attention_bf16_plain(qkv, S, H)
    vmax = qkv[:, 2 * D:].float().abs().max().item()
    # each prob may flip one bf16 rounding (<= 2^-8 p), moving the output by
    # <= 2^-8 max|v| in all (sum p = 1), plus the output's own bf16 rounding
    _check("attention_bf16 [32 seq x 4 heads, S=144, dh=128]", got, ref, 2.0 ** -6 * vmax,
           "2^-6 max|v|: one bf16 flip per prob + output rounding", stats, "attention_bf16")
    _time("attention_bf16", lambda: kc.attention_bf16(qkv, S, H),
          lambda: kc.attention_bf16_plain(qkv, S, H), stats, "attention_bf16")

    # residual_layernorm, both uses in a layer
    res = randn(r, D)
    y32 = randn(r, D)
    for name, a, bb, s_, b_, of, ob in (
        ("residual_layernorm LN1 (bf16+f32 -> f32, bf16)", x2, res, p16[4], p16[5], True, True),
        ("residual_layernorm LN2 (f32+f32 -> bf16)", y32, res, p16[10], p16[11], False, True),
    ):
        got, ref = kc.residual_layernorm(a, bb, s_, b_, of, ob), kc.residual_layernorm_plain(a, bb, s_, b_, of, ob)
        if of:
            _check(name + " f32", got[0], ref[0], 1e-5 * ref[0].abs().max().item(),
                   "f32 mean/var reduction order, 1e-5 of max|ref|", stats, "residual_layernorm")
        _check(name + " bf16", got[1], ref[1], BF16_ULP * ref[1].float().abs() + 1e-5,
               "one bf16 ulp", stats, "residual_layernorm")
        _time(name, lambda: kc.residual_layernorm(a, bb, s_, b_, of, ob),
              lambda: kc.residual_layernorm_plain(a, bb, s_, b_, of, ob), stats, "residual_layernorm")

    # quant_rows_int8 on each of the layer's four GEMM inputs
    for name, a in (
        ("quant_rows_int8 x bf16 [4608,512]", x2),
        ("quant_rows_int8 attn bf16 [4608,512]", attn_in),
        ("quant_rows_int8 y f32 [4608,512]", y32),
        ("quant_rows_int8 h1 f32 [4608,1024]", randn(r, F)),
    ):
        (q, sc), (q_ref, sc_ref) = l8.quant_rows_int8(a), l8.quant_rows_int8_plain(a)
        _check(name + " codes", q, q_ref, 0.0, "exact: same rounded division and product, rint",
               stats, "quant_rows_int8")
        _check(name + " scales", sc, sc_ref, 0.0, "exact", stats, "quant_rows_int8")
        _time(name, lambda: l8.quant_rows_int8(a), lambda: l8.quant_rows_int8_plain(a),
              stats, "quant_rows_int8")

    # gemm_int8: int32 sums exactly (unit scales, zero bias), then the four
    # products of one int8 layer with their epilogues
    qa, rs = l8.quant_rows_int8(x2)
    ones_m, ones_n = torch.ones(r, device=dev), torch.ones(3 * D, device=dev)
    zeros_n = torch.zeros(3 * D, device=dev)
    _check("gemm_int8 int32 sums [4608,512]x[512,1536]",
           l8.gemm_int8(qa, ones_m, p8[0], ones_n, zeros_n, "f32"),
           l8.gemm_int8_plain(qa, ones_m, p8[0], ones_n, zeros_n, "f32"), 0.0,
           "exact: integer sums below 2^24", stats, "gemm_int8")
    qh, rh = l8.quant_rows_int8(randn(r, F))
    for name, a, s_a, w, s_w, bias, mode in (
        ("gemm_int8 qkv [4608,512]x[512,1536]", qa, rs, p8[0], p8[1], p8[2], "bf16"),
        ("gemm_int8 out [4608,512]x[512,512]", qa, rs, p8[3], p8[4], p8[5], "f32"),
        ("gemm_int8 ff1+gelu [4608,512]x[512,1024]", qa, rs, p8[8], p8[9], p8[10], "gelu"),
        ("gemm_int8 ff2 [4608,1024]x[1024,512]", qh, rh, p8[11], p8[12], p8[13], "f32"),
    ):
        got, ref = l8.gemm_int8(a, s_a, w, s_w, bias, mode), l8.gemm_int8_plain(a, s_a, w, s_w, bias, mode)
        # exact int32 sums and the same rounded steps: only tanhf/bf16
        # rounding could differ, by at most one ulp of the output type
        ulp = BF16_ULP if mode == "bf16" else 2.0 ** -22
        _check(name, got, ref, ulp * ref.float().abs() + 1e-6, "one ulp of the output type",
               stats, "gemm_int8")
        _time(name, lambda: l8.gemm_int8(a, s_a, w, s_w, bias, mode),
              lambda: l8.gemm_int8_plain(a, s_a, w, s_w, bias, mode), stats, "gemm_int8")

    # attention_int8 (K4) on the int8 layer's own QKV buffer
    qkv8 = l8.gemm_int8(qa, rs, p8[0], p8[1], p8[2], "bf16")
    got, ref = l8.attention_int8(qkv8, S, H), l8.attention_int8_plain(qkv8, S, H)
    vmax = l8.attention_int8_codes(qkv8, S, H)[-1]  # [B, H, 1, dh] per-column amax of V
    vmax = vmax.expand(B, H, S, D // H).transpose(1, 2).reshape(r, D)
    # int32 sums are exact; a softmax expf difference may flip a prob code
    # by one, moving an output by <= vmax/127 of its column, plus one bf16
    # ulp of the output rounding
    _check("attention_int8 [32 seq x 4 heads, S=144, dh=128]", got, ref,
           vmax / 127.0 + BF16_ULP * ref.float().abs(),
           "one prob code (vmax/127 of the column) + one bf16 ulp", stats, "attention_int8")
    _time("attention_int8", lambda: l8.attention_int8(qkv8, S, H),
          lambda: l8.attention_int8_plain(qkv8, S, H), stats, "attention_int8")

    # the f32 layer (K1): its four products with their epilogues, on the
    # module's raw weights (a random in_proj bias, so the q scale after the
    # bias is seen)
    with torch.no_grad():
        layer.self_attn.in_proj_bias.copy_(0.1 * randn(3 * D))
    sa = layer.self_attn
    x32 = randn(r, D)
    scale = 1.0 / (D // H) ** 0.5
    for name, a, w, bias, mode in (
        ("gemm_f32 qkv [4608,512]x[1536,512]^T", x32, sa.in_proj_weight, sa.in_proj_bias, "qkv"),
        ("gemm_f32 out [4608,512]x[512,512]^T", attn_in.float(), sa.out_proj.weight, sa.out_proj.bias, "bias"),
        ("gemm_f32 ff1+gelu [4608,512]x[1024,512]^T", y32, layer.linear1.weight, layer.linear1.bias, "gelu"),
        ("gemm_f32 ff2 [4608,1024]x[512,1024]^T", h1_in.float(), layer.linear2.weight, layer.linear2.bias, "bias"),
    ):
        w, bias = w.detach(), bias.detach()
        got, ref = l32.gemm_f32(a, w, bias, mode, scale, D), l32.gemm_f32_plain(a, w, bias, mode, scale, D)
        # f32 FFMA sums in another order than cuBLAS's f32 (TF32 off):
        # ~sqrt(K) * 2^-24 of the row's magnitude; gelu's erff against the
        # A-S polynomial adds <= 1.5e-7 * |x| / 2
        _check(name, got, ref, 1e-5 * ref.abs().max().item() + 1e-6,
               "f32 accumulation order, 1e-5 of max|ref|", stats, "gemm_f32")
        _time(name, lambda: l32.gemm_f32(a, w, bias, mode, scale, D),
              lambda: l32.gemm_f32_plain(a, w, bias, mode, scale, D), stats, "gemm_f32")

    qkv32 = l32.gemm_f32(x32, sa.in_proj_weight.detach(), sa.in_proj_bias.detach(), "qkv", scale, D)
    got, ref = l32.attention_f32(qkv32, S, H), l32.attention_f32_plain(qkv32, S, H)
    # f32 both sides: scores, exp and P.V sums in another order
    _check("attention_f32 [32 seq x 4 heads, S=144, dh=128]", got, ref,
           1e-5 * qkv32[:, 2 * D:].abs().max().item(), "f32 sum order, 1e-5 of max|v|", stats,
           "attention_f32")
    _time("attention_f32", lambda: l32.attention_f32(qkv32, S, H),
          lambda: l32.attention_f32_plain(qkv32, S, H), stats, "attention_f32")

    # residual_layernorm in K1's two-pass mode, var = E[(y - mu)^2]: both
    # uses in the f32 layer, on f32 inputs of the layer's scale
    s1, b1 = layer.norm1.weight.detach(), layer.norm1.bias.detach()
    s2, b2 = layer.norm2.weight.detach(), layer.norm2.bias.detach()
    for name, a, bb, s_, b_ in (
        ("residual_layernorm two-pass LN1 (f32+f32 -> f32)", x32, res, s1, b1),
        ("residual_layernorm two-pass LN2 (f32+f32 -> f32)", y32, res, s2, b2),
    ):
        ln_args = (a, bb, s_, b_, True, False, True)
        got, ref = kc.residual_layernorm(*ln_args)[0], kc.residual_layernorm_plain(*ln_args)[0]
        _check(name, got, ref, 1e-5 * ref.abs().max().item(),
               "f32 mean/var reduction order, 1e-5 of max|ref|", stats, "residual_layernorm two-pass")
        _time(name, lambda: kc.residual_layernorm(*ln_args),
              lambda: kc.residual_layernorm_plain(*ln_args), stats, "residual_layernorm two-pass")
    # Rows of mean 1024 and spread ~1 tell the two variances apart. Their
    # values are multiples of 1/16 and every partial sum of a row stays
    # below 2^20, so each sum is exact in f32 and mu is the same in any
    # order: the two-pass kernel must stay within the tolerance above. The
    # one-pass E[y^2] - mu^2 (terms near 2^20, sums near 2^29) loses the
    # variance to cancellation, so the one-pass kernel must fall outside it.
    big = torch.round(16.0 * randn(r, D)) / 16.0 + 1024.0
    zeros = torch.zeros(r, D, device=dev)
    ln_args = (big, zeros, s1, b1, True, False, True)
    got, ref = kc.residual_layernorm(*ln_args)[0], kc.residual_layernorm_plain(*ln_args)[0]
    tol = 1e-5 * ref.abs().max().item()
    _check("residual_layernorm two-pass, rows of mean 1024", got, ref, tol,
           "exact mu, var in another order: 1e-5 of max|ref|", stats, "residual_layernorm two-pass")
    one_pass = kc.residual_layernorm(big, zeros, s1, b1, True, False, False)[0]
    err = (one_pass - ref).abs()
    log(f"[kernels] residual_layernorm one-pass kernel on the same rows: max_abs_err {err.max().item():.3e} "
        f"against the two-pass plain version (must exceed {tol:.3e})")
    if bool((err <= tol).all()):
        raise AssertionError("the one-pass kernel passes the two-pass check: the check cannot tell the modes apart")

    # whole layers: bf16 flips upstream propagate through LayerNorm, so the
    # kernels' own envelope vs flax applies (tests/test_ops.py); the f32
    # layer is f32 throughout, its gate is summation order through four
    # products of 512-1024 terms and two LayerNorms
    layers = (
        ("layer bf16", l16.fused_encoder_layer_bf16, l16.fused_encoder_layer_bf16_plain, p16, x, 6e-2, 1e-2),
        ("layer int8", l8.fused_encoder_layer_int8, l8.fused_encoder_layer_int8_plain, p8, x, 0.3, 5e-2),
        ("layer int8qa", functools.partial(l8.fused_encoder_layer_int8, qattn=True),
         functools.partial(l8.fused_encoder_layer_int8_plain, qattn=True), p8, x, 0.3, 5e-2),
        ("layer f32", l32.fused_encoder_layer, l32.fused_encoder_layer_plain, layer,
         x32.reshape(B, S, D), 2e-4, 2e-5),
    )
    for name, fn, plain, prep, xin, atol, mean_tol in layers:
        got, ref = fn(xin, prep, H), plain(xin, prep, H)
        err = (got.float() - ref.float()).abs()
        log(f"[kernels] {name}: max_abs_err {err.max().item():.3e} mean_abs_err {err.mean().item():.3e} "
            f"(tolerance max {atol}, mean {mean_tol})")
        if err.max().item() > atol or err.mean().item() > mean_tol:
            raise AssertionError(f"{name} disagrees with its plain version")
        ms, plain_ms = median_ms(lambda: fn(xin, prep, H)), median_ms(lambda: plain(xin, prep, H))
        log(f"[kernels] {name}: kernels {ms:.4f} ms, plain {plain_ms:.4f} ms per layer (median of 20)")
        stats[name] = {"ms": ms, "plain_ms": plain_ms}
    torch.cuda.synchronize()
    return stats


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------


def synthetic_params(rng: np.random.Generator, n_clips: int, n_frames: int) -> dict:
    """Smooth SMPL-X motion (axis-angle), [n_clips, n_frames, ...] float32:
    low-frequency sinusoids per body dof, a slowly turning heading about z,
    a walking xy path with a bobbing pelvis, constant betas per clip."""
    t = np.arange(n_frames)[None, :, None]
    freqs = rng.uniform(0.02, 0.12, (n_clips, 1, 63))
    phases = rng.uniform(0, 2 * np.pi, (n_clips, 1, 63))
    amps = rng.uniform(0.05, 0.35, (n_clips, 1, 63))
    body_pose = amps * np.sin(2 * np.pi * freqs * t + phases)
    heading = 0.5 * np.sin(2 * np.pi * 0.01 * t[..., 0]) + rng.uniform(-np.pi, np.pi, (n_clips, 1))
    tilt = np.broadcast_to(0.05 * np.sin(2 * np.pi * 0.03 * t[..., 0]), heading.shape)
    global_orient = np.stack([np.pi / 2 + tilt, np.zeros_like(tilt), heading], axis=-1)
    step = 0.02 * np.stack([np.cos(heading), np.sin(heading)], axis=-1)
    xy = np.cumsum(step, axis=1) + rng.normal(size=(n_clips, 1, 2))
    z = 0.95 + 0.02 * np.sin(2 * np.pi * 0.07 * t)
    z = np.broadcast_to(z, (n_clips, n_frames, 1))
    betas = np.broadcast_to(rng.normal(scale=0.5, size=(n_clips, 1, 10)), (n_clips, n_frames, 10))
    out = {"global_orient": global_orient, "body_pose": body_pose,
           "transl": np.concatenate([xy, z], axis=-1), "betas": betas}
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}


def encode(body, params: dict) -> torch.Tensor:
    """SMPL-X params -> repr [B, T-1, 294] through the port's FK and encoder."""
    p = {k: torch.from_numpy(v).cuda() for k, v in params.items()}
    joints = forward_joints(body, p["betas"], p["global_orient"], p["body_pose"], p["transl"])
    return get_repr(joints, global_orient=p["global_orient"], transl=p["transl"],
                    body_pose=p["body_pose"], betas=p["betas"])


def compute_stats(frames: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-block mean/std as rohm_tpu/reprs/stats.py computes them."""
    flat = frames.reshape(-1, frames.shape[-1]).astype(np.float64)
    mean, std = flat.mean(0), flat.std(0)
    start = 0
    for name in REPR_LIST:
        sl = slice(start, start + REPR_DIM_DICT[name])
        start = sl.stop
        if name == "foot_contact":
            mean[sl], std[sl] = 0.0, 1.0
        elif name != "smplx_betas":
            std[sl] = std[sl].mean()
    std[std == 0.0] = 1.0
    return mean.astype(np.float32), std.astype(np.float32)


def make_batch(body, rng: np.random.Generator):
    """One batch: clean and noisy reprs (noise: 3 deg on every rotation,
    3 cm on the translation, 0.1 on betas, as the shipped noise level 3)."""
    clean = synthetic_params(rng, B, CLIP_LEN)
    noisy = dict(clean)
    deg = np.deg2rad(3.0)
    noisy["global_orient"] = clean["global_orient"] + rng.normal(scale=deg, size=(B, CLIP_LEN, 3)).astype(np.float32)
    noisy["body_pose"] = clean["body_pose"] + rng.normal(scale=deg, size=(B, CLIP_LEN, 63)).astype(np.float32)
    noisy["transl"] = clean["transl"] + rng.normal(scale=0.03, size=(B, CLIP_LEN, 3)).astype(np.float32)
    noisy["betas"] = clean["betas"] + rng.normal(scale=0.1, size=(B, 1, 10)).astype(np.float32)
    return encode(body, clean), encode(body, noisy)


def expected_launches(batches: dict) -> dict:
    """Launches per kernel for full batches in each fused_posenet mode:
    2 iterations x 1000 PoseNet steps x 8 layers, each layer's chain."""
    per_layer = {  # mode -> kernel -> launches per layer
        "bf16": {"gemm_bf16": 4, "attention_bf16": 1, "residual_layernorm": 2},
        "int8": {"quant_rows_int8": 4, "gemm_int8": 4, "attention_bf16": 1, "residual_layernorm": 2},
        "int8qa": {"quant_rows_int8": 4, "gemm_int8": 4, "attention_int8": 1, "residual_layernorm": 2},
        "f32": {"gemm_f32": 4, "attention_f32": 1, "residual_layernorm two-pass": 2},
    }
    out = dict.fromkeys(KERNELS, 0)
    for mode, n in batches.items():
        for name, k in per_layer[mode].items():
            out[name] += k * 2 * 1000 * LAYERS * n
    return out


def slice_phase(seed: int, n_int8: int, n_bf16: int) -> dict:
    dev = "cuda"
    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    body = synthetic_model(num_verts=10475, seed=seed, device=dev)
    trajnet = TrajNet(traj_feat_dim=13, cond_dim=13, mid_dim=512).to(dev)
    trajcontrol = TrajNet(traj_feat_dim=13, cond_dim=13, mid_dim=512, trajcontrol=True).to(dev)
    posenet = PoseNet(latent_dim=D, ff_size=F, num_layers=LAYERS, num_heads=H).to(dev)
    batches = [make_batch(body, rng) for _ in range(n_int8 + n_bf16)]
    mean, std = compute_stats(torch.cat([c for c, _ in batches]).cpu().numpy())
    mean_t, std_t = torch.from_numpy(mean).to(dev), torch.from_numpy(std).to(dev)

    def pipeline(mode):
        return RohmPipeline(
            trajnet=trajnet, trajcontrol=trajcontrol, posenet=posenet,
            sched_traj=make_schedule("cosine", 100, device=dev),
            sched_pose=make_schedule("cosine", 1000, device=dev),
            body_model=body, mean=mean_t, std=std_t, repr_abs_only=True, traj_feat_dim=13,
            sample_iter=2, grad_type="amass", mask_scheme="lower", input_noise=True,
            iter2_cond_noisy_pose=True, iter2_cond_noisy_traj=True, fused_posenet=mode,
        )

    pipes = {mode: pipeline(mode) for mode in ("int8", "bf16", "int8qa", "f32")}
    pose_mask = amass_eval_pose_mask("lower", B, S - 1)
    traj_mask = np.ones((B, S), np.float32)
    abs_index = torch.as_tensor(TRAJ_ABS_INDEX, device=dev).long()

    # correctness on the batch: bridge round trip, fused PoseNet vs f32 module
    clean_n = (batches[0][0] - mean_t) / std_t
    bridged = traj_to_pose_bridge(clean_n[..., abs_index], clean_n, mean_t, std_t, body)
    med = (bridged - clean_n[:, : S - 1, :22]).abs().median().item()
    log(f"[slice] bridge round trip on clean traj: median |err| {med:.3e} (tolerance 0.2, tests/test_pipeline.py)")
    if not med < 0.2:
        raise AssertionError("bridge round trip off")
    noisy_n = ((batches[0][1] - mean_t) / std_t)[:, : S - 1]
    x_t = torch.randn(B, S - 1, 294, device=dev, generator=torch.Generator(dev).manual_seed(seed))
    ref = posenet(x_t, noisy_n, 500)
    # the per-layer envelope of tests/test_ops.py on the mean; the max may
    # grow over eight layers, so it is held at
    # four times the per-layer one; the f32 path is f32 throughout, so only
    # summation order (and erff against torch's erf) separates it
    for mode, atol, mean_tol in (("bf16", 6e-2 * 4, 1e-2), ("int8", 0.3 * 4, 5e-2),
                                 ("int8qa", 0.3 * 4, 5e-2), ("f32", 2e-3, 1e-4)):
        out = pipes[mode]._pose_model_fn(noisy_n)(x_t, 500)
        err = (out - ref).abs()
        log(f"[slice] PoseNet {mode} kernels vs f32 module, 8 layers, one step: "
            f"max {err.max().item():.3e} mean {err.mean().item():.3e}")
        if not (torch.isfinite(out).all() and err.mean().item() < mean_tol and err.max().item() < atol):
            raise AssertionError(f"PoseNet {mode} kernels stray from the f32 module")
        if not torch.equal(out[..., :22], noisy_n[..., :22]):
            raise AssertionError("traj passthrough dims are not the condition's")

    reset_launches()
    batch_s = []
    modes = ["int8"] * n_int8 + ["bf16"] * n_bf16
    for i, (mode, (clean, noisy)) in enumerate(zip(modes, batches)):
        gen = torch.Generator(device=dev).manual_seed(seed + 100 + i)
        traj_clean = (clean - mean_t) / std_t
        pose_noisy = (noisy - mean_t) / std_t
        traj_cond = pose_noisy[..., abs_index]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val_pose, val_traj = pipes[mode].run_batch(
            traj_cond, traj_clean, pose_noisy, pose_mask, traj_mask, gen
        )
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        batch_s.append((mode, seconds))
        log(f"[slice] batch {i} fused_posenet={mode}: {seconds:.2f} s wall "
            f"(2 x (100 TrajNet + 1000 PoseNet steps), {B} clips)")
        if tuple(val_pose.shape) != (B, S - 1, 294) or tuple(val_traj.shape) != (B, S, 13):
            raise AssertionError(f"bad output shapes {tuple(val_pose.shape)} {tuple(val_traj.shape)}")
        if not (torch.isfinite(val_pose).all() and torch.isfinite(val_traj).all()):
            raise AssertionError("non-finite pipeline output")
    launches = read_launches()

    expected = expected_launches({"int8": n_int8, "bf16": n_bf16})
    log(f"[slice] launches {launches}; expected {expected}")
    if launches != expected:
        raise AssertionError("kernel launch counts do not match the chain")
    breakdown_phase(pipes, noisy_n, x_t)
    return {"launches": launches, "batch_seconds": batch_s}


def breakdown_phase(pipes: dict, cond: torch.Tensor, x_pose: torch.Tensor) -> None:
    """Where a batch's time goes: each piece of one iteration timed alone
    (median CUDA-event ms), the batch predicted from them, and the device's
    busy share over PoseNet steps from a torch.profiler trace."""
    dev = cond.device
    pipe = pipes["int8"]
    g = torch.Generator(device=dev).manual_seed(1)
    x_traj = torch.randn(B, S, 13, device=dev, generator=g)
    traj_cond = torch.randn(B, S, 13, device=dev, generator=g)
    control = torch.randn(B, S, 272, device=dev, generator=g)
    traj_full = torch.randn(B, S, 294, device=dev, generator=g)
    spec = pipe._guidance()[0]

    def guidance_grad():
        x0 = x_pose.detach().requires_grad_()
        return torch.autograd.grad(spec.loss_fn(x0), x0)

    ms = {
        "trajnet step": median_ms(lambda: pipe.trajnet(x_traj, traj_cond, 50)),
        "trajcontrol step": median_ms(lambda: pipe.trajcontrol(x_traj, traj_cond, 50, control_cond=control)),
        "bridge": median_ms(lambda: traj_to_pose_bridge(x_traj, traj_full, pipe.mean, pipe.std, pipe.body_model)),
        "guidance grad": median_ms(guidance_grad),
    }
    steps = {}
    for mode, p in pipes.items():
        model_fn = p._pose_model_fn(cond)  # as the sampling loop calls it

        def step(model_fn=model_fn):
            return model_fn(x_pose, 500)

        steps[mode] = step
        ms[f"posenet step {mode}"] = median_ms(step)
    for name, v in ms.items():
        log(f"[breakdown] {name}: {v:.3f} ms (median of 20)")
    for mode in pipes:
        pred = 2 * (100 * ms["trajnet step"] / 2 + 100 * ms["trajcontrol step"] / 2 + ms["bridge"]
                    + 1000 * ms[f"posenet step {mode}"] + 51 * ms["guidance grad"]) / 1e3
        log(f"[breakdown] {mode} batch predicted from the pieces: {pred:.2f} s "
            f"(PoseNet steps {2 * 1000 * ms[f'posenet step {mode}'] / 1e3:.2f} s)")
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(20):
                steps[mode]()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = sorted(
            ((e.key, e.self_device_time_total) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda kv: -kv[1],
        )
        busy = sum(us for _, us in kernels)
        log(f"[breakdown] {mode} PoseNet steps x20 under the profiler: device busy {busy / wall_us:.3f} "
            f"of {wall_us / 1e3:.1f} ms wall")
        for name, us in kernels[:8]:
            log(f"[breakdown]   {us / busy:.3f}  {us / 20e3:.4f} ms/step  {name[:90]}")


# ---------------------------------------------------------------------------
# phase 6: the CLI
# ---------------------------------------------------------------------------

CLI_SEQS, CLI_SEQ_LEN = 11, 149  # per test dataset: 33 test clips of 145 frames


def write_smplx_npz(path: Path, seed: int) -> None:
    """A synthetic SMPL-X model file at the real size (10475 vertices), in
    the layout of SMPLX_NEUTRAL.npz, so the CLI loads it with load_smplx_npz."""
    m = synthetic_model(num_verts=10475, seed=seed)
    v = m.num_verts
    kintree = np.stack([np.maximum(SMPLX_PARENTS, 0), np.arange(len(SMPLX_PARENTS))])
    np.savez(
        path,
        v_template=m.v_template.numpy(), shapedirs=m.shapedirs.numpy(),
        posedirs=m.posedirs.numpy().T.reshape(v, 3, -1), J_regressor=m.j_regressor.numpy(),
        weights=m.lbs_weights.numpy(), kintree_table=kintree,
    )


def cli_phase(seed: int, work: Path) -> dict:
    """`test_amass_full.main` at full width on a synthetic AMASS test tree
    (3 datasets x 11 sequences of 149 frames: 33 clips) with a real-size
    synthetic SMPL-X file, one batch of 32 clips in each of "f32" and
    "int8qa", then `eval_amass_full.main` on each pickle."""
    from rohm_tpu_torch.cli import eval_amass_full, test_amass_full
    from rohm_tpu_torch.cli.common import AMASS_TEST_DATASETS
    from rohm_tpu_torch.data import write_synthetic_amass

    work.mkdir(parents=True, exist_ok=True)
    body_path = work / "SMPLX_NEUTRAL.npz"
    write_smplx_npz(body_path, seed)
    t0 = time.perf_counter()
    write_synthetic_amass(str(work / "amass"), synthetic_model(num_verts=10475, seed=seed, device="cuda"),
                          datasets={n: CLI_SEQS for n in AMASS_TEST_DATASETS}, seq_len=CLI_SEQ_LEN, seed=seed)
    log(f"[cli] synthetic tree: {len(AMASS_TEST_DATASETS)} x {CLI_SEQS} sequences of {CLI_SEQ_LEN} "
        f"frames, {time.perf_counter() - t0:.2f} s")
    launches = dict.fromkeys(KERNELS, 0)
    out = {}
    for mode in ("f32", "int8qa"):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pkl, timing = test_amass_full.run([
            "--config=cfg_files/test_cfg/amass_occ_leg_noise_3.yaml", "--synthetic_data=True",
            f"--dataset_root={work / 'amass'}", f"--body_model_path={body_path}",
            "--batch_size=32", "--max_batches=1", "--load_noise=False", f"--fused_posenet={mode}",
            "--model_path_trajnet=", "--model_path_trajnet_control=", "--model_path_posenet=",
            f"--save_root={work / ('results_' + mode)}", f"--seed={seed}", "--device=0",
        ])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_launches()
        expected = expected_launches({mode: 1})
        log(f"[cli] fused_posenet={mode}: launches {counts}; expected {expected}")
        if counts != expected:
            raise AssertionError(f"the {mode} CLI run did not go through its kernels as the chain implies")
        for name in launches:
            launches[name] += counts[name]
        batch_s = timing["batch_dispatch"] + timing["device_wait_and_collect"]
        log(f"[cli] fused_posenet={mode}: one batch of 32 clips {batch_s:.2f} s "
            f"(batch_dispatch + device_wait_and_collect), main() {seconds:.2f} s in all")

        with open(pkl, "rb") as f:
            saved = pickle.load(f)
        shapes = {k: tuple(v.shape) for k, v in saved.items() if isinstance(v, np.ndarray)}
        want = {k: (32, CLIP_LEN - 2, 22, 3) for k in (
            "rec_ric_data_clean_list", "rec_ric_data_noisy_list",
            "rec_ric_data_rec_list_from_abs_traj", "rec_ric_data_rec_list_from_smpl")}
        want.update({k: (32, CLIP_LEN - 2, 294) for k in (
            "motion_repr_clean_list", "motion_repr_noisy_list", "motion_repr_rec_list")})
        if shapes != want or set(saved) != set(want) | {"mask_scheme", "repr_name_list", "repr_dim_dict"}:
            raise AssertionError(f"bad pickle: keys {sorted(saved)}, shapes {shapes}")
        if not all(np.isfinite(saved[k]).all() for k in want):
            raise AssertionError(f"non-finite values in the {mode} pickle")
        metrics = eval_amass_full.main([f"--saved_data_path={pkl}"])
        if not np.isfinite(metrics["mpjpe_global_mm"]):
            raise AssertionError("non-finite MPJPE")
        out[mode] = {"batch_s": batch_s, "timing": timing, "metrics": metrics}
    shutil.rmtree(work)
    return {"launches": launches, "runs": out}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    device = device_phase()
    build_phase()
    stats = kernel_phase(args.seed)
    sl = slice_phase(args.seed, N_INT8, N_BF16)
    cli = cli_phase(args.seed, Path(".chipscratch") / "cli_smoke")
    # launches: the slice's and the CLI's main-path runs, each counted from 0
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sl["launches"][name] + cli["launches"][name],
         "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"]}
        for name, (_, _, src, rep) in KERNELS.items()
    ]
    unused = [k["name"] for k in kernels if k["launches"] == 0]
    if unused:
        raise AssertionError(f"kernels never launched by the main path: {unused}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
