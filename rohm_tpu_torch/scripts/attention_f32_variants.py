"""Variants of the f32 attention forward (csrc/attention_tf32.cuh) against the shipped one, on one card.

    python -m rohm_tpu_torch.scripts.attention_f32_variants [--seed 0] [--only NAME ...] [--phases]

Builds the shipped kernel library, then each variant: a copy of
`rohm_tpu_torch/ops/csrc/` with one design choice edited (the grid, the
warps of a block, the TF32 split and its rounding), compiled with the library's own nvcc
flags into a library of its own under `rohm_tpu_torch/_build/variants/`
(`f32_gemm_variants.build_libraries`). The wrappers then launch each
library in turn in this one process, on the same inputs: `attention_f32`
at the f32 inference layer's shapes (32 x 144 tokens, D = 512, H = 4, Q
pre-scaled) and `attention_train_fwd` in the f32 mode at the training
layer's (64 x 145, dropout 0.1), each also at S = 1024 (8 sequences), where
the keys take more than one tile. qkv is the QKV product of an N(0, 1)
input with a xavier in_proj weight, as the layers make it. For each it
prints the time on the card alone with a cold L2 (`card_ms`) and the worst
error as a fraction of `chip_smoke.py`'s gates (1e-5 max|v|; 1e-5 inv_keep
max|v|), then `scaled_dot_product_attention`'s time on the same shapes,
pinned to its fastest backend (`chip_smoke.sdpa_library`). With --phases
it also builds the shipped routine with clock64 stamps at its phase
boundaries and prints where a block's cycles go at 32 x 144. The card's
name and power limit head the output. It runs only on a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from rohm_tpu_torch.ops import _build
from rohm_tpu_torch.ops import transformer_layer as l32
from rohm_tpu_torch.ops import transformer_layer_train as lt
from rohm_tpu_torch.scripts.ab_train_kernels import card_ms
from rohm_tpu_torch.scripts.f32_gemm_variants import SPLIT, SPLITS, build_libraries

D, H = 512, 4
IK = 1.0 / 0.9
# (label, sequences, S, training)
SHAPES = (("attention_f32 32x144", 32, 144, False), ("attention_train_fwd f32 64x145", 64, 145, True),
          ("attention_f32 8x1024", 8, 1024, False), ("attention_train_fwd f32 8x1024", 8, 1024, True))

ONE_PASS = [
    ("attention_tf32.cuh",
     "    for (int u = 0; u < W; ++u) mma_tf32(part[u], as[kk], bb[u][0], bb[u][1]);\n#pragma unroll\n"
     "    for (int u = 0; u < W; ++u) mma_tf32(part[u], ab[kk], bs[u][0], bs[u][1]);\n#pragma unroll\n", ""),
    ("attention_tf32.cuh",
     "    for (int n = 0; n < 4; ++n) mma_tf32(part[n], as, bb[n][0], bb[n][1]);\n#pragma unroll\n"
     "    for (int n = 0; n < 4; ++n) mma_tf32(part[n], ab, bs[n][0], bs[n][1]);\n#pragma unroll\n", ""),
]

# name -> [(file, text, replacement)]
VARIANTS = {
    "a block per 80 query rows": [("attention_tf32.cuh", "constexpr bool HEAD_GRID = true;",
                                   "constexpr bool HEAD_GRID = false;")],
    "10 warps a block up to 160 keys": [("attention_tf32.cuh", "constexpr int WARPS = 5;",
                                         "constexpr int WARPS = 10;")],
    "5 warps a block past 160 keys": [("attention_tf32.cuh", "constexpr int TILED_WARPS = 10;",
                                       "constexpr int TILED_WARPS = 5;")],
    "one TF32 pass": ONE_PASS,
    "big cut, not rounded": [("common.cuh", SPLIT, SPLITS["big_cut"])],
}


# where a block's time goes: the shipped routine with clock64 stamps written
# by lane 0 of each warp at its phase boundaries (up to 160 keys)
STAMP = "__device__ long long stamps[132 * 16 * 16];\n" \
        "#define STAMP(k) if (lane == 0 && blockIdx.x < 132) stamps[(blockIdx.x * 16 + warp) * 16 + (k)] = clock64()\n"
PHASES = [
    ("attention_tf32.cuh", "constexpr bool HEAD_GRID = true;", "constexpr bool HEAD_GRID = true;\n" + STAMP),
    ("attention_tf32.cuh", "  float s[NJ][4];\n", "  float s[NJ][4];\n  STAMP(0);\n"),
    ("attention_tf32.cuh", "    cp_async_wait_group<1>();\n    __syncthreads();\n",
     "    cp_async_wait_group<1>();\n    __syncthreads();\n    STAMP(1);\n"),
    ("attention_tf32.cuh", "Ks, ld, nj, dh,\n               lane);\n", "Ks, ld, nj, dh,\n               lane);\n        STAMP(2 + 4 * i);\n"),
    ("attention_tf32.cuh", "          s[j][3] = div_rn(s[j][3], sum_hi, rs_hi);\n        }\n      }\n",
     "          s[j][3] = div_rn(s[j][3], sum_hi, rs_hi);\n        }\n      }\n      STAMP(3 + 4 * i);\n"),
    ("attention_tf32.cuh", "        cp_async_wait_group<0>();\n        __syncthreads();\n      }\n",
     "        cp_async_wait_group<0>();\n        __syncthreads();\n      }\n      STAMP(4 + 4 * i);\n"),
    ("attention_tf32.cuh", "        store_group(obase, D, r_lo, S, o, m, dh, t);\n      }\n",
     "        store_group(obase, D, r_lo, S, o, m, dh, t);\n      }\n      STAMP(5 + 4 * i);\n"),
    ("attention_f32.cu", "// Any S; dh a multiple of 4",
     'extern "C" int rt_read_stamps(void* dst) {\n'
     "  return (int)cudaMemcpyFromSymbol(dst, rohm::attn_tf32::stamps, sizeof(rohm::attn_tf32::stamps));\n}\n\n"
     "// Any S; dh a multiple of 4"),
]


def phases(seed: int) -> None:
    """Print, per warp of a block, the median over the blocks of `attention_f32` at 32 x 144 of the SM
    cycles (clock64, from the block's start) at which it reached each phase boundary: K landed, then per
    round of row tiles the scores, the softmax, V landed (first round) and P.V with its stores."""
    import ctypes

    import numpy as np

    lib = build_libraries({"phases": PHASES}, ("attention_f32.cu",), ("rt_attention_f32",))["phases"]
    lib.rt_read_stamps.argtypes, lib.rt_read_stamps.restype = [ctypes.c_void_p], ctypes.c_int
    label, call, *_ = workload(seed)[0]
    shipped = _build.library
    _build.library = lambda: lib
    try:
        print(f"{label} with stamps: {card_ms(call):.4f} ms on the card (cold L2)", flush=True)
        call()
        torch.cuda.synchronize()
    finally:
        _build.library = shipped
    buf = np.zeros(132 * 16 * 16, dtype=np.int64)
    if lib.rt_read_stamps(buf.ctypes.data):
        raise RuntimeError("rt_read_stamps failed")
    blocks = SHAPES[0][1] * H
    st = buf.reshape(132, 16, 16)[:blocks].astype(np.float64)
    rel = st - st[:, :1, :1]  # cycles since warp 0's start, per block (clock64 counts per SM)
    names = ("K landed", "scores", "softmax", "V landed", "P.V", "scores", "softmax", "", "P.V")
    tiles = -(-SHAPES[0][2] // 16)
    for w in range(5):
        rounds = 1 + (w + 5 < tiles)
        cols = [k for k in range(1, 2 + 4 * rounds) if names[k - 1]]
        print(f"warp {w}: " + ", ".join(f"{names[k - 1]} {np.median(rel[:, w, k]):.0f}" for k in cols))


def _ptxas(log) -> list:
    """'kernel<TILED>: registers, spill bytes' of the f32 attention forward kernels in an nvcc log."""
    lines, out = log.read_text().splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and ("attention_f32_kernel" in line or "attention_train_fwd_kernelILb" in line):
            kernel = ("attention_f32" if "attention_f32" in line else "attention_train_fwd") + (
                "<tiled>" if "ILb1E" in line else "")
            props = " ".join(lines[i + 1:i + 4])
            regs = props.split("Used ")[1].split(" registers")[0] if "Used " in props else "?"
            spill = props.split("bytes spill stores")[0].split(",")[-1].strip() if "spill stores" in props else "?"
            out.append(f"{kernel} {regs} registers, {spill} bytes spilled")
    return out


def workload(seed: int) -> list:
    """(label, call, qkv, S, mask) for each of SHAPES."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dh = D // H
    bound = (6.0 / (D + 3 * D)) ** 0.5  # xavier_uniform of the [3D, D] in_proj weight
    w = (2 * torch.rand(3 * D, D, generator=g, device="cuda") - 1) * bound
    out = []
    for label, b, s, train in SHAPES:
        qkv = torch.randn(b * s, D, generator=g, device="cuda") @ w.t()
        if train:
            mask = (torch.rand(b, H, s, s, generator=g, device="cuda") >= 0.1).to(torch.int8)
            out.append((label, lambda qkv=qkv, s=s, mask=mask: lt.attention_train_fwd(qkv, mask, s, H, IK), qkv, s,
                        mask))
        else:
            qkv[:, :D] *= dh ** -0.5
            out.append((label, lambda qkv=qkv, s=s: l32.attention_f32(qkv, s, H), qkv, s, None))
    return out


def measure(work: list) -> dict:
    """label -> (card ms, worst error / gate) with whichever library `_build.library` returns."""
    res = {}
    for label, call, qkv, s, mask in work:
        got = call()
        if mask is None:
            ref, gate = l32.attention_f32_plain(qkv, s, H), 1e-5 * qkv[:, 2 * D:].abs().max().item()
        else:
            ref = lt.attention_train_fwd_plain(qkv, mask, s, H, IK)
            gate = 1e-5 * IK * qkv[:, 2 * D:].abs().max().item()
        res[label] = (card_ms(call), (got - ref).abs().max().item() / gate)
    return res


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", nargs="*", choices=sorted(VARIANTS), help="these variants (default: all)")
    parser.add_argument("--phases", action="store_true", help="also the shipped routine's phases, by clock64")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the variants are measured on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 products
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    names = args.only or list(VARIANTS)
    libs = {"shipped": _build.library(),
            **build_libraries({n: VARIANTS[n] for n in names}, ("attention_f32.cu", "attention_train.cu"),
                              ("rt_attention_f32", "rt_attention_train_fwd"))}
    for name in libs:  # each kernel's registers and spills, from ptxas
        d = _build.BUILD_ROOT / (_build.source_hash() if name == "shipped" else "variants/" + name.replace(" ", "_")
                                 .replace(",", "").replace(".", ""))
        print(f"{name}: " + "; ".join(_ptxas(d / "build.log")), flush=True)
    work = workload(args.seed)
    shipped = _build.library
    runs = {}
    try:
        for name, lib in libs.items():
            _build.library = lambda lib=lib: lib
            runs[name] = measure(work)
    finally:
        _build.library = shipped
    from chip_smoke import sdpa_inputs, sdpa_library  # the yardstick chip_smoke.py times

    library = {}
    for label, _, qkv, s, _ in work:
        fn, _, backend = sdpa_library(*sdpa_inputs(qkv, s, torch.float32))
        library[label] = (card_ms(fn), backend)
    if args.phases:
        phases(args.seed)
    print(f"{card}; ms on the card (cold L2), and the worst error as a fraction of the gate", flush=True)
    for label, *_ in work:
        print(f"{label}:")
        for name, r in runs.items():
            print(f"  {name:28s} {r[label][0]:.4f} ms   {r[label][1]:.4f} of the gate")
        print(f"  {library[label][1]:28s} {library[label][0]:.4f} ms")
    return runs


if __name__ == "__main__":
    main()
