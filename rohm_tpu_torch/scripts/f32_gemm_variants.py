"""Variants of the f32 GEMM main loops against the shipped ones, on one card.

    python -m rohm_tpu_torch.scripts.f32_gemm_variants [--seed 0] [--only NAME ...]

Builds the shipped kernel library, then each variant: a copy of
`rohm_tpu_torch/ops/csrc/` with one design choice edited, compiled with the
library's own nvcc flags into a library of its own under
`rohm_tpu_torch/_build/variants/`. Variants of `gemm_f32`'s wgmma loop
(csrc/f32_wgmma.cuh; its shape is set in csrc/gemm_f32.cu): the tiles
(128 x 128 on a persistent grid for N above 1024, 128 x 64 one per block
up to it, shipped; either throughout, with or without the persistent
grid), the ring's depth, where W is split (route (a), shipped: once per
weight, outside the product; route (b): in shared memory, each landed
stage), and the mma.sync loop that `gemm_f32` ran before it
(csrc/f32_gemm.cuh on the raw weight). Variants
of `gemm_train`'s f32 mma.sync loop (csrc/f32_gemm.cuh): the tile, the
ring's depth, how an operand is split into TF32 halves, the partial sums,
the split-K plan. Each library is then measured in a process of its own
(a variant that faults costs only its own line), on the same inputs from
the seed: the four products of an f32 inference
layer (`gemm_f32` at 32 x 144 and at 64 x 145 tokens, D = 512, F = 1024,
weights at a Linear layer's scale) and the 12 layouts of an f32 training
layer (`gemm_train`, 64 x 145 rows, no epilogue). For each it prints the
time on the card alone with a cold L2 (`card_ms`) beside the bound of the
four inference products (three TF32 passes at 165 TFLOP/s) and the worst
error as a fraction of `chip_smoke.py`'s gates (1e-5 max|ref| + 1e-6;
2e-5 sum|a||b|), and `torch.matmul` at the same shapes with TF32 off and
on (one pass: the one-pass yardstick, which the port never calls). A
microbenchmark first measures what `mma.sync` m16n8k8 tf32 issues alone
(8 independent accumulators a warp, 3 products each step) and with 16
operand splits per 24 products, by `cvt.rna` and by integer rounding. The
card's name and power limit head the output. It runs only on a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from rohm_tpu_torch.ops import _build
from rohm_tpu_torch.ops import transformer_layer as l32
from rohm_tpu_torch.ops import transformer_layer_train as lt
from rohm_tpu_torch.scripts.ab_train_kernels import card_ms

D, F, H = 512, 1024, 4
ROWS_INF, ROWS_TRAIN = (32 * 144, 64 * 145), 64 * 145
PEAK_F32 = 495e12 / 3  # three TF32 passes on an H100 SXM

# the shipped split, and its alternatives
SPLIT = """  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__fsub_rn(x, __uint_as_float(big)));"""
SPLITS = {
    "cvt_rna": """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(__fsub_rn(x, __uint_as_float(big))));""",
    "veltkamp": """  const float c = __fmul_rn(x, 8193.0f);  // 2^13 + 1
  const float hi = __fsub_rn(c, __fsub_rn(c, x));
  big = __float_as_uint(hi);
  small = __float_as_uint(__fsub_rn(x, hi));""",
    "big_cut": """  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(__fsub_rn(x, __uint_as_float(big)));""",
}
SHIPPED_TILE = "TB_M = 64, TB_N = 64, TB_K = 32, STAGES = 3;"


def _tile(m: int, n: int, stages: int) -> list:
    return [("f32_gemm.cuh", SHIPPED_TILE, f"TB_M = {m}, TB_N = {n}, TB_K = 32, STAGES = {stages};")]


SHIPPED_SHAPE = "constexpr int NARROW_BN = 64, WIDE_ABOVE = 1024, STAGES = 3;\nconstexpr bool WIDE_PERSIST = true;"


def _wgmma(narrow_bn: int = 64, wide_above: int = 1024, stages: int = 3, wide_persist: bool = True) -> list:
    return [("gemm_f32.cu", SHIPPED_SHAPE,
             f"constexpr int NARROW_BN = {narrow_bn}, WIDE_ABOVE = {wide_above}, STAGES = {stages};\n"
             f"constexpr bool WIDE_PERSIST = {str(wide_persist).lower()};")]


SPLIT_B = [("gemm_f32.cu", "f32g::launch<128, STAGES, WIDE_PERSIST, false>", "f32g::launch<128, STAGES, WIDE_PERSIST, true>"),
           ("gemm_f32.cu", "f32g::launch<NARROW_BN, STAGES, false, false>", "f32g::launch<NARROW_BN, STAGES, false, true>")]
MMA_SYNC = [("gemm_f32.cu", '#include "f32_wgmma.cuh"', '#include "f32_gemm.cuh"'),
            ("gemm_f32.cu", "f32g::launch<128, STAGES, WIDE_PERSIST, false>(A, W2, M, N, K, epi, s)",
             "f32g::launch<false, true>(A, W2, M, N, K, 1, K, epi, s)"),
            ("gemm_f32.cu", "f32g::launch<NARROW_BN, STAGES, false, false>(A, W2, M, N, K, epi, s)",
             "f32g::launch<false, true>(A, W2, M, N, K, 1, K, epi, s)")]
NO_WIDE = 1 << 30  # every product on the narrow tiles

# name -> [(file, text, replacement)]
VARIANTS = {
    "wgmma 128x128 persistent throughout": _wgmma(wide_above=0),
    "wgmma 128x128 one tile per block throughout": _wgmma(wide_above=0, wide_persist=False),
    "wgmma 128x64 throughout": _wgmma(wide_above=NO_WIDE),
    "wgmma 128x64 persistent throughout": [*_wgmma(wide_above=0), (
        "gemm_f32.cu", "f32g::launch<128, STAGES, WIDE_PERSIST, false>", "f32g::launch<64, STAGES, WIDE_PERSIST, false>")],
    "wgmma 2 stages": _wgmma(stages=2),  # 4 do not fit beside the persistent grid's staging tile
    "wgmma route (b): W split in smem": SPLIT_B,
    "mma.sync loop (before wgmma)": MMA_SYNC,
    "tile 128x64, 4 stages": _tile(128, 64, 4),
    "tile 128x128, 4 stages": _tile(128, 128, 4),
    "tile 64x128, 4 stages": _tile(64, 128, 4),
    "64x64, 2 stages": _tile(64, 64, 2),
    "64x64, 4 stages": _tile(64, 64, 4),
    "split by cvt.rna twice": [("common.cuh", SPLIT, SPLITS["cvt_rna"])],
    "split by Veltkamp (FP)": [("common.cuh", SPLIT, SPLITS["veltkamp"])],
    "big cut, not rounded": [("common.cuh", SPLIT, SPLITS["big_cut"])],
    "no partial sums": [("f32_gemm.cuh", "mma_tf32(part[i][j],", "mma_tf32(acc[i][j],")],
    "one TF32 pass": [("f32_gemm.cuh", "          mma_tf32(part[i][j], as[i], bb[0], bb[1]);\n"
                                       "          mma_tf32(part[i][j], ab[i], bs[0], bs[1]);\n", "")],
}
# the variants whose gemm_f32 reads the weight as it is stored, not its halves
RAW_WEIGHT = {"wgmma route (b): W split in smem", "mma.sync loop (before wgmma)"}

PEAK_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
               "{%8, %9}, {%0, %1, %2, %3};"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// MODE 0: products only; 1: 16 splits by cvt.rna per 24 products; 2: by integer rounding
template <int MODE>
__global__ void __launch_bounds__(256, 2) peak(float* out, int iters, float seed) {
  float acc[8][4] = {};
  float v[16];
  const float x = seed + threadIdx.x;
  uint32_t a[4], b0 = __float_as_uint(2 * x), b1 = __float_as_uint(3 * x);
  for (int i = 0; i < 16; ++i) v[i] = x + i;
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(x + i);
  for (int it = 0; it < iters; ++it) {
    if (MODE != 0) {
      uint32_t hi = 0, lo = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float y = v[i] * 1.0001f;
        uint32_t r, r2;
        if (MODE == 1) {
          asm volatile("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(y));
          asm volatile("cvt.rna.tf32.f32 %0, %1;" : "=r"(r2) : "f"(y - __uint_as_float(r)));
        } else {
          r = (__float_as_uint(y) + 0x1000u) & 0xffffe000u;
          r2 = (__float_as_uint(y - __uint_as_float(r)) + 0x1000u) & 0xffffe000u;
        }
        v[i] = __uint_as_float(r);
        hi ^= r;
        lo ^= r2;
      }
      a[0] ^= hi & 0x10000u;
      b0 ^= lo & 0x10000u;
    }
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_tf32(acc[j], a, b0, b1);
  }
  float s = 0;
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) s += acc[j][e];
  if (s == 12345.f) out[0] = s;
}
// TFLOP/s of TF32 products, the second of two timed launches of 132 x 4 blocks
extern "C" float rt_mma_tf32_peak(int mode, int iters) {
  float* out;
  cudaMalloc(&out, 4);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    if (mode == 0) peak<0><<<132 * 4, 256>>>(out, iters, 1.0f);
    if (mode == 1) peak<1><<<132 * 4, 256>>>(out, iters, 1.0f);
    if (mode == 2) peak<2><<<132 * 4, 256>>>(out, iters, 1.0f);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
  }
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  cudaFree(out);
  return (float)(2.0 * 16 * 8 * 8 * 24.0 * iters * 132 * 4 * 8 / (ms * 1e-3) / 1e12);
}
"""


def _nvcc(args: list, what: str) -> None:
    proc = subprocess.run([_build._nvcc(), *args], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {what}:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")


def _load(path: Path, entries: tuple) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name in entries:
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    return lib


ENTRIES = ("rt_gemm_f32", "rt_split_tf32", "rt_gemm_train")
MODULE = "rohm_tpu_torch.scripts.f32_gemm_variants"
SPLIT_K_4 = "split-K for four blocks per SM"  # the shipped library, the weight gradients split for 4 blocks per SM


def variant_dir(name: str) -> Path:
    return _build.BUILD_ROOT / "variants" / name.replace(" ", "_").replace(",", "").replace(".", "")


def build_libraries(edits: dict, sources: tuple, entries: tuple) -> dict:
    """name -> loaded library of `sources` (and errors.cu) compiled from a
    copy of csrc/ with that name's edits [(file, text, replacement)], whose
    C `entries` the wrappers call; all nvcc processes run at once."""
    jobs = []
    for name, edit in edits.items():
        d = variant_dir(name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        for fname, text, repl in edit:
            path = d / fname
            src = path.read_text()
            if text not in src:
                raise RuntimeError(f"variant {name!r}: {fname} no longer holds the text it edits")
            path.write_text(src.replace(text, repl))
        objs = [d / f"{src}.o" for src in (*sources, "errors.cu")]
        procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", str(o), str(d / o.stem)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for o in objs]
        jobs.append((name, d, objs, procs))
    libs = {}
    for name, d, objs, procs in jobs:
        outs = [p.communicate()[0] for p in procs]
        (d / "build.log").write_text("\n".join(outs))
        failed = [out for p, out in zip(procs, outs) if p.returncode]
        if failed:
            raise RuntimeError(f"variant {name!r} failed to build:\n" + failed[0][-3000:])
        _nvcc(["-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(d / "lib.so"),
               *(str(o) for o in objs)], name)
        libs[name] = _load(d / "lib.so", entries)
    return libs


def build_variants(names: list) -> dict:
    """name -> loaded library of the GEMM variant."""
    return build_libraries({name: VARIANTS[name] for name in names}, ("gemm_f32.cu", "gemm_train.cu"), ENTRIES)


def mma_peak() -> dict:
    d = _build.BUILD_ROOT / "variants"
    d.mkdir(parents=True, exist_ok=True)
    (d / "mma_peak.cu").write_text(PEAK_SRC)
    _nvcc([*_build.NVCC_FLAGS, "-shared", "-o", str(d / "mma_peak.so"), str(d / "mma_peak.cu")], "mma_peak")
    lib = ctypes.CDLL(str(d / "mma_peak.so"))
    lib.rt_mma_tf32_peak.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.rt_mma_tf32_peak.restype = ctypes.c_float
    return {label: lib.rt_mma_tf32_peak(mode, 20000)
            for mode, label in enumerate(("products alone", "with cvt.rna splits", "with integer splits"))}


def workload(seed: int) -> tuple:
    """The four inference products (name, a, w, bias, mode) at each of
    ROWS_INF, {rows: [...]}, and the 12 training layouts (name, gemm_train
    kwargs)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    def linear(n, k):  # a Linear weight [out, in] at its init scale
        return (2 * torch.rand(n, k, generator=g, device="cuda") - 1) * k ** -0.5

    weights = {name: (linear(n, k), 0.1 * randn(n))
               for name, k, n in (("qkv", D, 3 * D), ("out", D, D), ("ff1", D, F), ("ff2", F, D))}
    inference = {rows: [(name, randn(rows, w.shape[1]), w, bias, mode)
                        for (name, (w, bias)), mode in zip(weights.items(), ("qkv", "bias", "gelu", "bias"))]
                 for rows in ROWS_INF}
    r = ROWS_TRAIN
    x, attn, y1, gld = randn(r, D), randn(r, D), randn(r, D), randn(r, F)
    df, dh1, do, dqkv = randn(r, D), randn(r, F), randn(r, D), randn(r, 3 * D)
    wq, wo, w1, w2 = linear(3 * D, D), linear(D, D), linear(F, D), linear(D, F)
    training = [("qkv", dict(a=x, b=wq, b_t=True)), ("out", dict(a=attn, b=wo, b_t=True)),
                ("ff1", dict(a=y1, b=w1, b_t=True)), ("ff2", dict(a=gld, b=w2, b_t=True)),
                ("dW2", dict(a=df, b=gld, a_t=True)), ("dh1", dict(a=df, b=w2)),
                ("dW1", dict(a=dh1, b=y1, a_t=True)), ("dy1", dict(a=dh1, b=w1)),
                ("dWo", dict(a=do, b=attn, a_t=True)), ("dattn", dict(a=do, b=wo)),
                ("dWqkv", dict(a=dqkv, b=x, a_t=True)), ("dx", dict(a=dqkv, b=wq))]
    return inference, training


def inference_bound_ms(products: list) -> float:
    """The least time of the four products at the 3xTF32 peak."""
    return sum(2.0 * a.shape[0] * a.shape[1] * w.shape[0] for _, a, w, _, _ in products) / PEAK_F32 * 1e3


def measure(inference: dict, training: list) -> dict:
    """Card time and worst error / gate of the four products at each row
    count and of the 12 training products with whichever library
    `_build.library` returns."""
    scale = (D // H) ** -0.5
    res = {"train_ms": 0.0, "train_gate": 0.0}
    for rows, products in inference.items():
        res[f"inf_ms {rows}"], res[f"inf_gate {rows}"] = 0.0, 0.0
        for name, a, w, bias, mode in products:
            got, ref = l32.gemm_f32(a, w, bias, mode, scale, D), l32.gemm_f32_plain(a, w, bias, mode, scale, D)
            res[f"inf_gate {rows}"] = max(res[f"inf_gate {rows}"], (got - ref).abs().max().item()
                                          / (1e-5 * ref.abs().max().item() + 1e-6))
            res[f"{name} {rows}"] = card_ms(lambda: l32.gemm_f32(a, w, bias, mode, scale, D))
            res[f"inf_ms {rows}"] += res[f"{name} {rows}"]
    for _, kw in training:
        got, ref = lt.gemm_train(**kw), lt.gemm_train_plain(**kw)
        absprod = lt.gemm_train_plain(kw["a"].abs(), kw["b"].abs(), kw.get("a_t", False), kw.get("b_t", False))
        res["train_gate"] = max(res["train_gate"], ((got - ref).abs() / (2e-5 * absprod + 1e-7)).max().item())
        res["train_ms"] += card_ms(lambda: lt.gemm_train(**kw))
    return res


def build_report(libs: dict) -> None:
    """Each library's registers and spills, from its build log (ptxas -v)."""
    for name in libs:
        log_path = (_build.BUILD_ROOT / _build.source_hash() if name == "shipped" else variant_dir(name)) / "build.log"
        if not log_path.exists():
            continue
        text = log_path.read_text().splitlines()
        # ptxas names each function, then prints its registers, on the next lines
        for i, line in enumerate(text):
            if "Compiling entry function" in line and "f32g" in line and "gemm_kernel" in line:
                usage = next((t.strip() for t in text[i + 1:i + 5] if "registers" in t), "")
                spill = next((t.strip() for t in text[i + 1:i + 5] if "spill" in t), "")
                args = re.search(r"gemm_kernelI(\w{0,48})", line)
                print(f"  {name} [{args.group(1) if args else ''}]: {usage} {spill}".rstrip(), flush=True)
        serial = [t.strip() for t in text if "serialized" in t]
        if serial:
            print(f"  {name}: {serial[0]}", flush=True)


def measure_one(name: str, seed: int) -> dict:
    """`measure` with one library (built already), in this process."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 products
    if name not in ("shipped", SPLIT_K_4):
        lib = _load(variant_dir(name) / "lib.so", ENTRIES)
        _build.library = lambda: lib
    if name == SPLIT_K_4:
        shipped_plan = lt.plan_splits
        lt.plan_splits = lambda m, n, k, tile, sms: shipped_plan(m, n, k, tile, 2 * sms)
    if name in RAW_WEIGHT:
        l32.split_tf32 = lambda w: w
    return measure(*workload(seed))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", nargs="*", choices=sorted(VARIANTS), help="these variants (default: all)")
    parser.add_argument("--measure", help=argparse.SUPPRESS)  # one built library, in a process of its own
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the variants are measured on the card")
    if args.measure:
        print("RESULT " + json.dumps(measure_one(args.measure, args.seed)), flush=True)
        return {}
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 products
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for label, tflops in mma_peak().items():
        print(f"mma.sync m16n8k8 tf32, {label}: {tflops:.1f} TFLOP/s", flush=True)
    _build.library()
    names = args.only if args.only is not None else list(VARIANTS)
    libs = {"shipped": _build.library(), **build_variants(names)}
    print("registers of the f32g::gemm_kernel instances (ptxas):", flush=True)
    build_report(libs)
    # each library in a process of its own, so that a variant that faults
    # costs its own line and not the others'
    runs = {}
    for name in [*libs, SPLIT_K_4]:
        proc = subprocess.run([sys.executable, "-m", MODULE, "--measure", name, "--seed", str(args.seed)],
                              capture_output=True, text=True, timeout=900)
        line = next((t for t in proc.stdout.splitlines() if t.startswith("RESULT ")), None)
        if proc.returncode or line is None:
            print(f"{name}: failed (exit {proc.returncode}): {(proc.stdout + proc.stderr)[-1500:]}", flush=True)
            continue
        runs[name] = json.loads(line[len("RESULT "):])
        print(f"{name}: measured", flush=True)
    inference, training = workload(args.seed)
    matmul = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        matmul[tf32] = {rows: sum(card_ms(lambda: torch.matmul(a, w.t())) for _, a, w, _, _ in products)
                        for rows, products in inference.items()}
    torch.backends.cuda.matmul.allow_tf32 = False

    def op(t, trans):
        return t.t() if trans else t

    matmul_train = sum(card_ms(lambda: torch.matmul(op(kw["a"], kw.get("a_t", False)), op(kw["b"], kw.get("b_t", False))))
                       for _, kw in training)
    bounds = {rows: inference_bound_ms(products) for rows, products in inference.items()}
    print(f"{card}; ms on the card (cold L2) of the four f32 inference products at "
          + " and ".join(f"{rows} rows (bound {b:.4f} ms)" for rows, b in bounds.items())
          + " / the 12 f32 training products, and the worst error as a fraction of gemm_f32's / gemm_train's gate",
          flush=True)
    for name, r in runs.items():
        inf = "  ".join(f"{r[f'inf_ms {rows}']:.4f} ({100 * bounds[rows] / r[f'inf_ms {rows}']:.1f} % of bound)"
                        for rows in inference)
        gates = " ".join(f"{r[f'inf_gate {rows}']:.3f}" for rows in inference)
        print(f"{name:34s} {inf} / {r['train_ms']:.4f} ms   {gates} / {r['train_gate']:.3f}")
        print(" " * 35 + "; ".join(f"{rows}: " + ", ".join(f"{p} {r[f'{p} {rows}']:.4f}" for p, *_ in inference[rows])
                                   for rows in inference))
    for tf32, label in ((False, "torch.matmul (TF32 off)"), (True, "torch.matmul (TF32 on, one pass)")):
        inf = "  ".join(f"{matmul[tf32][rows]:.4f}" for rows in inference)
        print(f"{label:34s} {inf}" + (f" / {matmul_train:.4f} ms" if not tf32 else " ms"))
    return runs


if __name__ == "__main__":
    main()
