"""Variants of the f32 attention backward (csrc/attention_tf32.cuh) against the shipped one, on one card.

    python -m rohm_tpu_torch.scripts.attention_bwd_f32_variants [--seed 0] [--phases]

Builds the shipped kernel library, then each variant: a copy of
`rohm_tpu_torch/ops/csrc/` with one design choice of the two backward
kernels edited, compiled with the library's own nvcc flags into a library
of its own under `rohm_tpu_torch/_build/variants/`
(`f32_gemm_variants.build_libraries`):
- "two call sites": each kernel calls `scores` (and the key kernel
  `pv_group`) once per product, where the shipped kernels loop over one
  call site;
- "keep bits after the staging": in the key kernel and the query kernel's
  one-tile path each thread's mask bytes are loaded once the tile's staging
  copies are issued, where the shipped kernels load them before.
The wrappers then launch each library in turn in this one process, on the
same inputs: `attention_train_bwd` in the f32 mode at the training layer's
shape (64 sequences x 145 tokens, D = 512, H = 4, dropout 0.1), at S = 161
(57 sequences: two key tiles) and at S = 1024 (9 sequences), on qkv and dA
as a layer's products make them (N(0, 1) through xavier weights). For each
it prints the registers and spilled bytes of the two kernels (ptxas), the
time on the card alone with a cold L2 (`card_ms`), each kernel's device
time (torch.profiler) and the worst error of dq, dk and dv as a fraction of
`chip_smoke.py`'s gate (1e-5 of each one's max|ref|). With --phases it also
builds the shipped kernels with clock64 stamps at their phase boundaries
and prints where a block's cycles go at 64 x 145 (thread 0, mean over the
blocks). The card's name and power limit head the output. It runs only on
a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from rohm_tpu_torch.ops import _build
from rohm_tpu_torch.ops import transformer_layer_train as lt
from rohm_tpu_torch.scripts.ab_train_kernels import card_ms
from rohm_tpu_torch.scripts.f32_gemm_variants import build_libraries

D, H = 512, 4
IK = 1.0 / 0.9
SHAPES = ((64, 145), (57, 161), (9, 1024))  # (sequences, S)
F = "attention_tf32.cuh"

TWO_CALL_SITES = [
    (F, """#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      if (live) scores(s, pass ? q_lo : a_lo, pass ? q_hi : a_hi, r_lo < S, r_hi < S, pass ? Ks : Vs, ld, nj, dh, lane);
      if (pass) break;
      cp_async_wait_group<0>();
      __syncthreads();  // K has landed; every warp is done with V
      if (live) dp_to_smem(nj);
    }
    if (!live) return;
""", """    if (live) scores(s, a_lo, a_hi, r_lo < S, r_hi < S, Vs, ld, nj, dh, lane);
    cp_async_wait_group<0>();
    __syncthreads();
    if (!live) return;
    dp_to_smem(nj);
    scores(s, q_lo, q_hi, r_lo < S, r_hi < S, Ks, ld, nj, dh, lane);
"""),
    (F, """#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      const float* a = pass ? krow : vrow;
      if (live) scores(s, a, a + 8 * (size_t)stride, k_lo < S, k_hi < S, pass ? Qs : As, ld, nj, dh, lane);
      if (pass) break;
      if (live) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j >= nj) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) dps[slot(j, e, lane)] = __fmul_rn(s[j][e], keep_of(kb, j, e, inv_keep));
        }
      }
      cp_async_wait_group<0>();
      __syncthreads();  // Q has landed
    }
    if (!live) continue;  // no keys for this warp (it still met every barrier)
""", """    if (live) {
      scores(s, vrow, vrow + 8 * (size_t)stride, k_lo < S, k_hi < S, As, ld, nj, dh, lane);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j >= nj) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) dps[slot(j, e, lane)] = __fmul_rn(s[j][e], keep_of(kb, j, e, inv_keep));
      }
    }
    cp_async_wait_group<0>();
    __syncthreads();
    if (!live) continue;
    scores(s, krow, krow + 8 * (size_t)stride, k_lo < S, k_hi < S, Qs, ld, nj, dh, lane);
"""),
    (F, """#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      if (pass) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = j < nj ? dps[slot(j, e, lane)] : 0.0f;
        }
      }
      float* out = obase + (pass ? D : 2 * D);
      for (int m = 0; m < groups; ++m) {
        float o[4][4] = {};
        if (TILED && q0) load_group(o, out, stride, k_lo, S, m, dh, t);
        pv_group(o, s, pass ? Qs : As, ld, m, nj, lane);
        store_group(out, stride, k_lo, S, o, m, dh, t);
      }
    }
""", """    for (int m = 0; m < groups; ++m) {
      float o[4][4] = {};
      if (TILED && q0) load_group(o, obase + 2 * D, stride, k_lo, S, m, dh, t);
      pv_group(o, s, As, ld, m, nj, lane);
      store_group(obase + 2 * D, stride, k_lo, S, o, m, dh, t);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = j < nj ? dps[slot(j, e, lane)] : 0.0f;
    }
    for (int m = 0; m < groups; ++m) {
      float o[4][4] = {};
      if (TILED && q0) load_group(o, obase + D, stride, k_lo, S, m, dh, t);
      pv_group(o, s, Qs, ld, m, nj, lane);
      store_group(obase + D, stride, k_lo, S, o, m, dh, t);
    }
"""),
]

KEEP_AFTER_STAGING = [
    (F, "    if (live) keep_bytes(0);\n", ""),
    (F, "    if (live) keep_bits(kb, kbytes);\n",
     "    if (live) {\n      keep_bytes(0);\n      keep_bits(kb, kbytes);\n    }\n"),
    (F, """    if (live) {
      int8_t kbytes[NJ][4];
      load_keep(kbytes, mslab, S,
                [&](int j, int e) { return make_int2(q0 + 8 * j + 2 * t + (e & 1), e < 2 ? k_lo : k_hi); });
      keep_bits(kb, kbytes);
    }
""", ""),
    (F, "    if (i < 8 * nj) St[i] = make_float4(mx, sum, __frcp_rn(sum), d);\n",
     """    if (i < 8 * nj) St[i] = make_float4(mx, sum, __frcp_rn(sum), d);
    if (live) {
      int8_t kbytes[NJ][4];
      load_keep(kbytes, mslab, S,
                [&](int j, int e) { return make_int2(q0 + 8 * j + 2 * t + (e & 1), e < 2 ? k_lo : k_hi); });
      keep_bits(kb, kbytes);
    }
"""),
]

VARIANTS = {"two call sites": TWO_CALL_SITES, "keep bits after the staging": KEEP_AFTER_STAGING}

# where a block's time goes: thread 0's clock64 at the phase boundaries of
# each kernel's one-tile path, per block (query kernel 0-5, key kernel 8-12)
STAMP = ("__device__ long long stamps[1024][16];\n"
         "#define STAMP(k) do { const int b_ = blockIdx.x + gridDim.x * blockIdx.y; "
         "if (threadIdx.x == 0 && b_ < 1024) stamps[b_][k] = clock64(); } while (0)\n")
PHASES = [
    (F, "constexpr int BWD_WARPS = 5;\n", STAMP + "constexpr int BWD_WARPS = 5;\n"),
    (F, "    const bool live = 16 * warp < nrows;\n", "    STAMP(0);\n    const bool live = 16 * warp < nrows;\n"),
    (F, "    if (live) keep_bits(kb, kbytes);\n    cp_async_wait_group<1>();\n    __syncthreads();\n",
     "    if (live) keep_bits(kb, kbytes);\n    STAMP(1);\n    cp_async_wait_group<1>();\n    __syncthreads();\n"
     "    STAMP(2);\n"),
    (F, "    if (!live) return;\n    row_softmax", "    STAMP(3);\n    if (!live) return;\n    row_softmax"),
    (F, "    for (int m = 0; m < groups; ++m) {\n      float o[4][4] = {};\n"
        "      pv_group(o, s, Ks, ld, m, nj, lane);\n",
     "    STAMP(4);\n    for (int m = 0; m < groups; ++m) {\n      float o[4][4] = {};\n"
     "      pv_group(o, s, Ks, ld, m, nj, lane);\n"),
    (F, "      store_group(obase, stride, r_lo, S, o, m, dh, t);\n    }\n  } else {",
     "      store_group(obase, stride, r_lo, S, o, m, dh, t);\n    }\n    STAMP(5);\n  } else {"),
    (F, "    if (TILED) __syncthreads();  // the previous tile is done with\n",
     "    if (TILED) __syncthreads();  // the previous tile is done with\n    STAMP(8);\n"),
    (F, "    cp_async_wait_group<1>();\n    __syncthreads();  // dA and the stats have landed\n",
     "    STAMP(9);\n    cp_async_wait_group<1>();\n    __syncthreads();  // dA and the stats have landed\n"),
    (F, "    if (!live) continue;  // no keys for this warp (it still met every barrier)\n",
     "    STAMP(10);\n    if (!live) continue;  // no keys for this warp (it still met every barrier)\n"),
    (F, "    // dv += pd^T.dA, then dk += ds^T.Q", "    STAMP(11);\n    // dv += pd^T.dA, then dk += ds^T.Q"),
    (F, "        store_group(out, stride, k_lo, S, o, m, dh, t);\n      }\n    }\n",
     "        store_group(out, stride, k_lo, S, o, m, dh, t);\n      }\n    }\n    STAMP(12);\n"),
    ("attention_train.cu", "// qkv and dA bf16 (bf16 mode) or f32;",
     'extern "C" int rt_read_stamps(void* dst) {\n'
     "  return (int)cudaMemcpyFromSymbol(dst, rohm::attn_tf32::stamps, sizeof(rohm::attn_tf32::stamps));\n}\n\n"
     "// qkv and dA bf16 (bf16 mode) or f32;"),
]
QUERY_PHASES = ("issue the loads and copies, pack the keep bits", "V lands", "dpd, dp to smem, s (scores x 2)",
                "softmax, D, ds", "dq (pv_group x 4, stores)")
KEY_PHASES = ("keep bits, issue the copies, the stats", "dA lands; dpd^T, dp^T, s^T (scores x 2)",
              "p^T, ds^T, pd^T", "dv, dk (pv_group x 8, stores)")


def workload(seed: int) -> list:
    """(label, call, qkv, da, mask, S) for each of SHAPES."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def xavier(n, k):
        return (2 * torch.rand(n, k, generator=g, device="cuda") - 1) * (6.0 / (n + k)) ** 0.5

    w_in, w_out = xavier(3 * D, D), xavier(D, D)
    out = []
    for b, s in SHAPES:
        qkv = torch.randn(b * s, D, generator=g, device="cuda") @ w_in.t()
        da = torch.randn(b * s, D, generator=g, device="cuda") @ w_out
        mask = (torch.rand(b, H, s, s, generator=g, device="cuda") >= 0.1).to(torch.int8)
        out.append((f"{b}x{s}", lambda qkv=qkv, da=da, mask=mask, s=s: lt.attention_train_bwd(qkv, da, mask, s, H, IK),
                    qkv, da, mask, s))
    return out


def measure(work: list) -> dict:
    """label -> (card ms, {kernel: device us}, worst error / gate) with whichever library `_build.library`
    returns."""
    res = {}
    for label, call, qkv, da, mask, s in work:
        got, ref = call(), lt.attention_train_bwd_plain(qkv, da, mask, s, H, IK)
        err = max(((got[:, i * D:(i + 1) * D] - ref[:, i * D:(i + 1) * D]).abs().max()
                   / (1e-5 * ref[:, i * D:(i + 1) * D].abs().max())).item() for i in range(3))
        ms = card_ms(call)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        us = {("query" if "query_kernel" in e.key else "key"): e.self_device_time_total / 10
              for e in prof.key_averages() if "attention_train_bwd" in e.key}
        res[label] = (ms, us, err)
    return res


def _ptxas(log) -> list:
    """'kernel<tiled>: registers, spill bytes' of the f32 backward kernels in an nvcc log."""
    lines, out = log.read_text().splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and ("bwd_query_kernel" in line or "bwd_key_kernel" in line):
            kernel = ("query" if "bwd_query_kernel" in line else "key") + ("<tiled>" if "ILb1E" in line else "")
            props = " ".join(lines[i + 1:i + 4])
            regs = props.split("Used ")[1].split(" registers")[0] if "Used " in props else "?"
            spill = props.split("bytes spill stores")[0].split(",")[-1].strip() if "spill stores" in props else "?"
            out.append(f"{kernel} {regs} registers, {spill} bytes spilled")
    return out


def phases(work: list) -> None:
    """Print where a block's SM cycles go in each kernel at the first shape (thread 0, mean over blocks)."""
    import numpy as np

    lib = build_libraries({"phases": PHASES}, ("attention_train.cu",), ("rt_attention_train_bwd",))["phases"]
    lib.rt_read_stamps.argtypes, lib.rt_read_stamps.restype = [ctypes.c_void_p], ctypes.c_int
    label, call, *_ = work[0]
    shipped = _build.library
    _build.library = lambda: lib
    try:
        print(f"{label} with stamps: {card_ms(call):.4f} ms on the card (cold L2)", flush=True)
        call()
        torch.cuda.synchronize()
    finally:
        _build.library = shipped
    buf = np.zeros((1024, 16), dtype=np.int64)
    if lib.rt_read_stamps(buf.ctypes.data):
        raise RuntimeError("rt_read_stamps failed")
    b, s = SHAPES[0]
    st = buf[:b * H * -(-s // 80)].astype(np.float64)
    for name, cols, labels in (("query kernel", range(0, 6), QUERY_PHASES), ("key kernel", range(8, 13), KEY_PHASES)):
        cols = list(cols)
        total = (st[:, cols[-1]] - st[:, cols[0]]).mean()
        print(f"{name}: {total:.0f} SM cycles a block (thread 0, mean over {len(st)} blocks)")
        for lab, c0, c1 in zip(labels, cols, cols[1:]):
            d = (st[:, c1] - st[:, c0]).mean()
            print(f"  {lab:48s} {d:8.0f}  {d / total:.3f}")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--phases", action="store_true", help="also the shipped kernels' phases, by clock64")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the variants are measured on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's f32 products
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = {"shipped": _build.library(),
            **build_libraries(VARIANTS, ("attention_train.cu",), ("rt_attention_train_bwd",))}
    for name in libs:  # each kernel's registers and spills, from ptxas
        d = _build.BUILD_ROOT / (_build.source_hash() if name == "shipped" else "variants/" + name.replace(" ", "_"))
        print(f"{name}: " + "; ".join(_ptxas(d / "build.log")), flush=True)
    work = workload(args.seed)
    shipped = _build.library
    runs = {}
    try:
        for name in (*libs, *reversed(libs)):  # in turns: shipped, variants, variants, shipped
            _build.library = lambda lib=libs[name]: lib
            runs.setdefault(name, []).append(measure(work))
    finally:
        _build.library = shipped
    if args.phases:
        phases(work)
    print(f"{card}; ms on the card (cold L2, two turns), each kernel's device us (profiler, second turn), the "
          "worst error as a fraction of the gate", flush=True)
    for label, *_ in work:
        print(f"{label}:")
        for name, (first, second) in runs.items():
            us = ", ".join(f"{k} {v:.1f}" for k, v in second[label][1].items())
            print(f"  {name:28s} {first[label][0]:.4f} / {second[label][0]:.4f} ms   {us}   "
                  f"{max(first[label][2], second[label][2]):.4f} of the gate")
    return runs


if __name__ == "__main__":
    main()
