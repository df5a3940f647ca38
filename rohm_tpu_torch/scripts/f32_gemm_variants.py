"""Variants of the f32 GEMM main loop (csrc/f32_gemm.cuh) against the shipped one, on one card.

    python -m rohm_tpu_torch.scripts.f32_gemm_variants [--seed 0] [--only NAME ...]

Builds the shipped kernel library, then each variant: a copy of
`rohm_tpu_torch/ops/csrc/` with one design choice edited (the tile, the
ring's depth, how an operand is split into TF32 halves, the partial sums,
the split-K plan), compiled with the library's own nvcc flags into a
library of its own under `rohm_tpu_torch/_build/variants/`. The wrappers
then launch each library in turn in this one process, on the same inputs:
the four products of an f32 inference layer (`gemm_f32`, 32 x 144 tokens,
D = 512, F = 1024, weights at a Linear layer's scale) and the 12 layouts
of an f32 training layer (`gemm_train`, 64 x 145 rows, no epilogue). For
each it prints the time on the card alone with a cold L2 (`card_ms`) and
the worst error as a fraction of `chip_smoke.py`'s gates (1e-5 max|ref| +
1e-6; 2e-5 sum|a||b|). A microbenchmark first measures what `mma.sync`
m16n8k8 tf32 issues alone (8 independent accumulators a warp, 3 products
each step) and with 16 operand splits per 24 products, by `cvt.rna` and by
integer rounding. The card's name and power limit head the output. It
runs only on a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from pathlib import Path

import torch

from rohm_tpu_torch.ops import _build
from rohm_tpu_torch.ops import transformer_layer as l32
from rohm_tpu_torch.ops import transformer_layer_train as lt
from rohm_tpu_torch.scripts.ab_train_kernels import card_ms

D, F, H = 512, 1024, 4
ROWS_INF, ROWS_TRAIN = 32 * 144, 64 * 145

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


# name -> [(file, text, replacement)]
VARIANTS = {
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


def build_libraries(edits: dict, sources: tuple, entries: tuple) -> dict:
    """name -> loaded library of `sources` (and errors.cu) compiled from a
    copy of csrc/ with that name's edits [(file, text, replacement)], whose
    C `entries` the wrappers call; all nvcc processes run at once."""
    root = _build.BUILD_ROOT / "variants"
    jobs = []
    for name, edit in edits.items():
        d = root / name.replace(" ", "_").replace(",", "").replace(".", "")
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
        if any(p.returncode for p in procs):
            raise RuntimeError(f"variant {name!r} failed to build:\n" + "\n".join(outs)[-3000:])
        _nvcc(["-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(d / "lib.so"),
               *(str(o) for o in objs)], name)
        libs[name] = _load(d / "lib.so", entries)
    return libs


def build_variants(names: list) -> dict:
    """name -> loaded library of the GEMM variant."""
    return build_libraries({name: VARIANTS[name] for name in names}, ("gemm_f32.cu", "gemm_train.cu"),
                           ("rt_gemm_f32", "rt_gemm_train"))


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
    """The four inference products (name, a, w, bias, mode) and the 12
    training layouts (name, gemm_train kwargs)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    def linear(n, k):  # a Linear weight [out, in] at its init scale
        return (2 * torch.rand(n, k, generator=g, device="cuda") - 1) * k ** -0.5

    inference = [(name, randn(ROWS_INF, k), linear(n, k), 0.1 * randn(n), mode)
                 for name, k, n, mode in (("qkv", D, 3 * D, "qkv"), ("out", D, D, "bias"),
                                          ("ff1", D, F, "gelu"), ("ff2", F, D, "bias"))]
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


def measure(inference: list, training: list) -> dict:
    """Card time and worst error / gate of the four and of the 12 products
    with whichever library `_build.library` returns."""
    scale = (D // H) ** -0.5
    res = {"inf_ms": 0.0, "inf_gate": 0.0, "train_ms": 0.0, "train_gate": 0.0}
    for _, a, w, bias, mode in inference:
        got, ref = l32.gemm_f32(a, w, bias, mode, scale, D), l32.gemm_f32_plain(a, w, bias, mode, scale, D)
        res["inf_gate"] = max(res["inf_gate"], (got - ref).abs().max().item() / (1e-5 * ref.abs().max().item() + 1e-6))
        res["inf_ms"] += card_ms(lambda: l32.gemm_f32(a, w, bias, mode, scale, D))
    for _, kw in training:
        got, ref = lt.gemm_train(**kw), lt.gemm_train_plain(**kw)
        absprod = lt.gemm_train_plain(kw["a"].abs(), kw["b"].abs(), kw.get("a_t", False), kw.get("b_t", False))
        res["train_gate"] = max(res["train_gate"], ((got - ref).abs() / (2e-5 * absprod + 1e-7)).max().item())
        res["train_ms"] += card_ms(lambda: lt.gemm_train(**kw))
    return res


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", nargs="*", choices=sorted(VARIANTS), help="these variants (default: all)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the variants are measured on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 products
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for label, tflops in mma_peak().items():
        print(f"mma.sync m16n8k8 tf32, {label}: {tflops:.1f} TFLOP/s", flush=True)
    _build.library()
    libs = {"shipped": _build.library(), **build_variants(args.only or list(VARIANTS))}
    inference, training = workload(args.seed)
    shipped_library, shipped_plan = _build.library, lt.plan_splits
    runs = {}
    try:
        for name, lib in [*libs.items(), ("split-K for four blocks per SM", libs["shipped"])]:
            _build.library = lambda lib=lib: lib
            if name.startswith("split-K"):  # the weight gradients split for 4 blocks per SM, not 2
                lt.plan_splits = lambda m, n, k, tile, sms: shipped_plan(m, n, k, tile, 2 * sms)
            runs[name] = measure(inference, training)
            lt.plan_splits = shipped_plan
    finally:
        _build.library, lt.plan_splits = shipped_library, shipped_plan
    matmul_inf = sum(card_ms(lambda: torch.matmul(a, w.t())) for _, a, w, _, _ in inference)

    def op(t, trans):
        return t.t() if trans else t

    matmul_train = sum(card_ms(lambda: torch.matmul(op(kw["a"], kw.get("a_t", False)), op(kw["b"], kw.get("b_t", False))))
                       for _, kw in training)
    print(f"{card}; ms on the card (cold L2) of the four f32 inference products / the 12 f32 training products, "
          f"and the worst error as a fraction of gemm_f32's / gemm_train's gate", flush=True)
    for name, r in runs.items():
        print(f"{name:34s} {r['inf_ms']:.4f} / {r['train_ms']:.4f} ms   {r['inf_gate']:.3f} / {r['train_gate']:.3f}")
    print(f"{'torch.matmul (TF32 off)':34s} {matmul_inf:.4f} / {matmul_train:.4f} ms")
    return runs


if __name__ == "__main__":
    main()
