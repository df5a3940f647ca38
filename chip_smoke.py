"""Smoke run of the PyTorch port on one CUDA GPU: build, check, drive.

    python3 chip_smoke.py [--seed 0]

Phases (each failure ends the run with a non-zero exit code):
  1. device: the card's name and power limit; no CUDA device is an error.
  2. build: nvcc builds rohm_tpu_torch/ops/csrc into rohm_tpu_torch/_build/,
     one nvcc process per source, all at once.
  3. kernels: every CUDA kernel of the PoseNet inference layers, and each
     whole layer (bf16, int8, int8qa, f32), against its plain PyTorch
     version on the card, at the inference path's shapes (32 clips x 144
     tokens, D=512, H=4, F=1024): max/mean abs error within the stated
     tolerance, median CUDA-event times of the kernel, the plain version
     and one library call for the same function, and the bound (the least
     time the card could take: bytes over the memory rate or operations
     over the peak rate of their type). gemm_int8 (K-major weights) is
     also held to its plain version bit for bit (the gelu mode's tanhf
     excepted, its differing outputs and ulps logged) and timed beside
     torch._int_mm on the same weights and gemm_bf16 on the same shapes.
     quant_rows_int8 and the codes residual_layernorm writes with `quant`
     are held to quant_rows_int8_plain exactly (the latter of the
     kernel's own output), on the layer's inputs and on zero, tie and
     end-max rows; colsum (phase 4) runs twice, bit for bit the same.
  4. train kernels: every CUDA kernel of the training layer (K6 forward,
     K7 backward) at the training shapes (64 clips x 145 tokens, D=512,
     H=4, F=1024, dropout 0.1 with shared masks), in bf16 and f32 mode,
     against its plain version on the operands the chain hands it (in bf16
     mode the products take bf16 operands: the weights cast once, the
     activations by round_bf16 or the bf16 copy that the kernel making
     them writes, which must equal its f32 result rounded), timed the
     same three ways and on the card alone (a CUDA graph of 10 calls,
     replayed); the f32-mode attention kernels must fall outside the bf16
     gates. Then the whole layer's forward output, dx and its 12
     parameter gradients, kernels against the plain chain, and its forward
     and backward ms.
  4b. long sequences: every attention kernel at S = 145, 161, 167, 177,
     209 and 1024 (2 sequences at full width) against its plain version,
     K5 bit-identical to the K3 chain at each, attention_int8 also at 192
     and 193 (the limit of its one block per (sequence, head)); then each
     kernel's time on the card alone at S = 145, 161 and 1024 on ~9280
     rows.
  5. slice: the full-width AMASS inference pipeline (TrajNet + TrajControl
     mid_dim 512, PoseNet 512d x 8 layers, synthetic SMPL-X body, cosine
     100/1000-step schedules, skating guidance, 2 iterations, lower-body
     mask) on batches of 32 clips x 144 frames built with the port's own FK
     and encoder, through RohmPipeline.run_batch with fused_posenet "int8"
     and "bf16", one batch each. Weights are random from --seed. Checks shapes, finiteness,
     the kernels' launch counts, and the fused PoseNet of every mode (bf16,
     int8, int8qa, f32) against the plain f32 PoseNet on one step; then
     each piece of a batch timed alone and the device's busy share.
  6. train: `rohm_tpu_torch.cli.train_posenet.main` with the shipped
     posenet_train_stage1.yaml at full width (batch 64, 145-frame clips,
     512d x 8 layers) on a synthetic AMASS tree and a real-size synthetic
     SMPL-X file: 20 steps with --fused_train=bfloat16 (one in-training
     eval of the 1000-step chain, one checkpoint), 4 with float32, 4 with
     "". Checks finite losses, moved parameters and the launch counts the
     chain implies; then per mode the ms per optimizer step, its breakdown
     (encoder forward, encoder backward, losses through SMPL-X, optimizer),
     the device's busy share and the peak device memory.
  7. cli: `rohm_tpu_torch.cli.test_amass_full.main` at full width with the
     shipped amass_occ_leg_noise_3.yaml, on a synthetic AMASS test tree
     (3 x 11 sequences of 149 frames) and the real-size synthetic SMPL-X
     file, one batch of 32 clips with fused_posenet "f32" and one with
     False (the CLI's default: the plain PoseNet, no kernel), both loading
     the checkpoints phases 6 and 6b trained, and one each with "int8qa"
     and "int8", then `eval_amass_full.main` on each pickle. Checks the
     launch counts (none for False), the pickle's keys, shapes and
     finiteness, False's metrics within phase 7f's budgets of f32's and
     its result arrays within PLAIN_ARRAY_ATOL of f32's; prints each
     mode's batch time.
  7b. video: `rohm_tpu_torch.cli.test_prox_egobody.main` at full width with
     the shipped prox_rgb.yaml and egobody_rgb.yaml on synthetic PROX (2862
     frames: 20 windows, one batch of 20) and EgoBody (717 frames: 5
     windows, padded to 8) trees written by the port's writers, PROX with
     fused_posenet "bf16", EgoBody with "int8": 2 iterations, TrajControl,
     100 + 1000 cosine steps with early stop (980 PoseNet forwards), 2-D +
     skating guidance. PoseNet loads through the torch state_dict route (a
     torch.save of phase 6's checkpoint beside its stats, bit-identical on
     the card to the .npz route), TrajNet and TrajControl from phase 6b.
     Before each run, its fused PoseNet step is held to the f32 module at
     the rows the run gives the kernels (20 and 8 windows x 143 frames),
     within phase 5's envelopes. Checks the launch counts, the pickles' keys, shapes and finiteness,
     and `eval_prox_egobody.main` (finite metrics, stitched windows) on
     each; then one guided step (both terms, forward and backward through
     SMPL-X) timed alone and the device's busy share over 5.
  7c. single-net: `rohm_tpu_torch.cli.preprocessing_amass.main` on the card
     over a raw AMASS tree (both npz layouts, 60 and 120 fps, an SSM
     sequence, a file for each rule that drops one; 960 frames each), its
     25 joints held against the CPU's FK; `test_trajnet.main` (mid_dim
     512, 100 steps, one batch of phase 7's 33 clips) on phase 6b's vanilla
     checkpoint and with --trajcontrol on its TrajControl one; then
     `test_posenet.main --fused_posenet=True --cond_fn_with_grad=True
     --early_stop=True --save_results=True` on phase 6's PoseNet (one batch
     of 32 clips x 144 frames, 980 steps through K1's chain, the last 31
     guided), after its fused step is held to the f32 module at those rows
     within phase 5's f32 envelope. Checks the launch counts (none for
     TrajNet), the results, the pickle's keys, shapes and finiteness, and
     times each CLI's chain per batch; then `forward_vertices` at 10475
     vertices against the CPU, timed on 32 x 144 frames and on one.
  7d. data-parallel and bf16: `test_amass_full.main --data_parallel=True
     --fused_posenet=int8` through the CLI's own start-up (one card: a
     mesh of one rank on NCCL), bit for bit phase 7's single-process int8
     run with the same launch counts; two gloo ranks on cuda:0 (spawned
     processes, 16 clips each) for one guided RohmPipeline(mesh=) batch of
     phase 5's slice in int8qa, within phase 5's int8qa envelope of the
     single-process batch, and for one --fused_train=bfloat16 optimizer
     step on 64 clips, its gradients and parameters against the
     single-process step's; then train_posenet and train_trajnet with
     --model_dtype=bfloat16 (plain path, 4 steps each on phase 6's small
     tree), their ms per step beside phase 6's and 6b's float32 ones.
  7e. serve: the resident server, as a process of its own on the card
     (`ensure_server` on a socket in the run's scratch directory): phase
     7's int8 `test_amass_full` argv served twice, cold and then warm (the
     warm run must print the memo's warm hit), one --data_parallel=True
     request, each pickle bit for bit phase 7's in-process int8 run; one
     `eval_amass_full` request (phase 7's metrics); then phase 7b's PROX
     `test_prox_egobody` (bf16) and `eval_prox_egobody` on its pickle,
     phase 7c's `test_posenet` and vanilla `test_trajnet`, each result bit
     for bit its in-process run's, each client time beside the
     in-process one; a bad
     request answered with a traceback, the daemon alive; `stop`, and the
     daemon's process gone. The daemon's per-request log lines (seconds,
     kernel launches as each path implies, peak device memory) are
     printed; served launches come from that log, not from the kernels'
     JSON. Then the client's wall time cold, warm, for phase 7's
     in-process run and for one `python -m
     rohm_tpu_torch.cli.test_amass_full` process with the same argv.
  7f. trained: the JAX-trained fixture of tests/torch_trained/ (TrajNet,
     TrajControl mid_dim 64, PoseNet 64d x 8 layers, dh 16, contacts
     saturated; read with numpy and the port's load_pretrained) through
     `test_amass_full.run` with the flagship amass_occ_0.1_noise_3.yaml
     (--infill_traj, mask full, guided, 2 x (100 + 1000) steps) on its
     tree, one batch of 8 clips of 81 frames in each --fused_posenet mode
     (False, the CLI's default: no kernel launched; f32, bf16, int8,
     int8qa), then `eval_amass_full.main`: the launch counts each mode
     implies, each kernel mode's metrics within rel 2e-2 (MPJPEs) or 8e-2
     (the rest) of False's; then the plain pipeline on the fixture's batch
     with its replayed noise, its metrics within rel 1e-2 of the JAX
     package's (meta.json). Each mode's metrics and batch time are printed.
  8. bench: the int8 measurement path at full width. The whole-stack
     kernel (K5) on x [32, 144, 512] and an 8-layer `mega` prep of a
     random PoseNet(): bit-identical to the 8-layer K3 chain (whose
     LayerNorms write the next product's codes), within
     the int8 envelope of its plain version, timed beside the K3 chain and a
     CUDA graph of it. Then `rohm_tpu_torch.bench.run` (PoseNet 512d x 8,
     batch 32 x 143, 1000 cosine steps, one warm-up and 3 timed chains) on
     the per-layer int8 prep and on the `mega` prep with the same seeds:
     final samples bit-identical, steps/s and the device's busy share over
     20 steps of each. Then the two probes: the GEMM skeleton (K8) at 4-32
     sequences and the layer's seven ablations (K9), each call checked
     against its plain version once, then `main()` of
     `rohm_tpu_torch.scripts.bench_int8_gemm_rows` and `bench_int8_layer`.
     Launch counts as each run implies.
The second-to-last stdout line is the kernels' JSON (launches: the main
paths' runs of phases 5-8, 7b, 7c, 7d and 7f included (every rank's); phase
7e's served runs launch in the daemon's process, and their launches are in
its log lines, printed by phase 7e, not here; card_ms and library_card_ms: the time on the
card alone with a cold L2); the last line is {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import argparse
import functools
import json
import pickle
import re
import shutil
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as tnf

from rohm_tpu_torch.body.model import SMPLX_PARENTS, forward_joints, synthetic_model
from rohm_tpu_torch.diffusion.schedule import make_schedule
from rohm_tpu_torch.models import PoseNet, TrajNet
from rohm_tpu_torch.models.blocks import TransformerEncoderLayer
from rohm_tpu_torch.ops import _build, kernel_common as kc
from rohm_tpu_torch.ops import transformer_layer as l32
from rohm_tpu_torch.ops import transformer_layer_bf16 as l16
from rohm_tpu_torch.ops import transformer_layer_int8 as l8
from rohm_tpu_torch.ops import transformer_layer_train as lt
from rohm_tpu_torch.pipeline import RohmPipeline, amass_eval_pose_mask, traj_to_pose_bridge
from rohm_tpu_torch.reprs.encode import get_repr
from rohm_tpu_torch.reprs.schema import REPR_DIM_DICT, REPR_LIST, TRAJ_ABS_INDEX
from rohm_tpu_torch.scripts import bench_int8_gemm_rows as k8
from rohm_tpu_torch.scripts.ab_train_kernels import card_ms
from rohm_tpu_torch.scripts import bench_int8_layer as k9

B, S, D, H, F, LAYERS = 32, 144, 512, 4, 1024, 8
CLIP_LEN = 145  # frames per clip -> 144 repr frames (TrajNet) -> 143 (PoseNet)
N_INT8, N_BF16 = 1, 1  # batches through run_batch per mode
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
    # the training layer: K6 (_fwd_kernel :162) and K7 (_bwd_kernel :181,
    # which also recomputes the forward's products)
    "gemm_train bf16": (lt.gemm_train, "launches_bf16", "rohm_tpu_torch/ops/csrc/gemm_train.cu",
                        "rohm_tpu/ops/transformer_layer_train.py:181"),
    "gemm_train f32": (lt.gemm_train, "launches_f32", "rohm_tpu_torch/ops/csrc/gemm_train.cu",
                       "rohm_tpu/ops/transformer_layer_train.py:181"),
    "attention_train_fwd": (lt.attention_train_fwd, "launches", "rohm_tpu_torch/ops/csrc/attention_train.cu",
                            "rohm_tpu/ops/transformer_layer_train.py:162"),
    "attention_train_bwd": (lt.attention_train_bwd, "launches", "rohm_tpu_torch/ops/csrc/attention_train.cu",
                            "rohm_tpu/ops/transformer_layer_train.py:181"),
    "layernorm_train_fwd": (lt.layernorm_train_fwd, "launches", "rohm_tpu_torch/ops/csrc/layernorm_train.cu",
                            "rohm_tpu/ops/transformer_layer_train.py:162"),
    "layernorm_train_bwd": (lt.layernorm_train_bwd, "launches", "rohm_tpu_torch/ops/csrc/layernorm_train.cu",
                            "rohm_tpu/ops/transformer_layer_train.py:181"),
    "colsum": (lt.colsum, "launches", "rohm_tpu_torch/ops/csrc/colsum.cu",
               "rohm_tpu/ops/transformer_layer_train.py:181"),
    # the bf16 mode's casts of activation operands: K6/K7's c() (:103)
    "round_bf16": (lt.round_bf16, "launches", "rohm_tpu_torch/ops/csrc/gemm_train.cu",
                   "rohm_tpu/ops/transformer_layer_train.py:103"),
    # the int8 measurement path: K5, the whole stack in one launch; the K8
    # skeleton and the K9 variants, each a chain of the K3 kernels (one
    # count per call on the card), with the two modes K9 adds to them
    "encoder_stack_int8": (l8.fused_encoder_stack_int8, "launches",
                           "rohm_tpu_torch/ops/csrc/encoder_stack_int8.cu",
                           "rohm_tpu/ops/transformer_layer_int8.py:151"),
    "gemm_skeleton": (k8.gemm_skeleton, "launches", "rohm_tpu_torch/scripts/bench_int8_gemm_rows.py",
                      "scripts/bench_int8_gemm_rows.py:45"),
    "int8_layer_variant": (k9.int8_layer_variant, "launches", "rohm_tpu_torch/scripts/bench_int8_layer.py",
                           "scripts/bench_int8_layer.py:28"),
    "quant_rows_int8 fixed-scale": (l8.quant_rows_int8, "fixed_launches",
                                    "rohm_tpu_torch/ops/csrc/quant_rows_int8.cu",
                                    "scripts/bench_int8_layer.py:28"),
    "attention_bf16 no-softmax": (kc.attention_bf16, "no_softmax_launches",
                                  "rohm_tpu_torch/ops/csrc/attention_bf16.cu",
                                  "scripts/bench_int8_layer.py:28"),
}
BF16_ULP = 2.0 ** -7  # bf16 spacing relative to |x| is at most 2^-7
# the LayerNorm kernels' yardstick: one call that adds the residual and
# normalises, writing y alone; the kernels also write their bf16 copy, or
# norm and rstd, so no PyTorch call computes the same function
LN_YARDSTICK = "add + layer_norm (writes y only), not the same function"
# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): the bound
# of a kernel is the larger of its operations over the peak of their type
# and its bytes (each input read once, each output written once) over HBM.
# f32: an f32-accurate product takes three TF32 passes on the tensor cores
# (3xTF32, 495 / 3 TFLOP/s), faster than the FMA units' 67 TFLOP/s, so that
# is the least time the card could take for f32 operations
PEAK_OPS = {"bf16": 989e12, "f32": 495e12 / 3, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
# the training slice: batch 64 of 145-frame clips -> 144 repr frames + the
# timestep token = 145 tokens
TB, TS = 64, 145


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


def gpu_name_and_limit() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def device_phase() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py measures the GPU and has no CPU fallback")
    smi = gpu_name_and_limit()
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
        if any(w in line.lower() for w in ("registers", "spill", "error", "function properties")):
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


def ulp_diff(got: torch.Tensor, ref: torch.Tensor) -> tuple[int, int]:
    """(outputs that differ, the most ulps between two of them) of two f32
    or bf16 tensors, by the distance of their bit patterns on one ordered
    integer line."""
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32

    def ordered(t):
        i = t.contiguous().view(bits).to(torch.int64)
        return torch.where(i < 0, (torch.iinfo(bits).min - i), i)  # negative floats count down from -0

    d = (ordered(got) - ordered(ref)).abs()
    return int((d > 0).sum().item()), int(d.max().item())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def new_stats() -> dict:
    return {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0,
                "bound_ms": 0.0, "library_ms": None, "card_ms": None, "library_card_ms": None} for k in KERNELS}


def _time(name: str, kernel_fn, plain_fn, stats: dict, kernel: str, ops: float, moved: int,
          kind: str | None, library=None, tag: str = "kernels", rows: tuple = ()) -> None:
    """Median times of the kernel (CUDA events around each call, which count
    the host's launch cost, and on the card alone with a cold L2: card_ms),
    of its plain version, and, where one PyTorch call computes the same
    function, of that call (`library`: (fn, base, label), timed the same
    two ways; with `base`, the time of fn less that of base, as for a
    backward after its forward); the bound from `ops` operations of type
    `kind` (or `ops` a dict type -> operations, `kind` None) and `moved`
    bytes. Each adds to the kernel's per-layer sums, and to those of the TPU
    kernels named in `rows`."""
    ms, plain_ms, on_card = median_ms(kernel_fn), median_ms(plain_fn), card_ms(kernel_fn)
    lib_ms = lib_card = None
    if library is not None:
        lib_fn, lib_base, label = library
        lib_ms, lib_card = median_ms(lib_fn), card_ms(lib_fn)
        if lib_base is not None:
            lib_ms, lib_card = lib_ms - median_ms(lib_base), lib_card - card_ms(lib_base)
    if isinstance(ops, dict):
        ops_ms = sum(n / PEAK_OPS[k] for k, n in ops.items()) * 1e3
    else:
        ops_ms = ops / PEAK_OPS[kind] * 1e3 if kind else 0.0
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    lib = f"{lib_ms:.4f} ms (on the card {lib_card:.4f}; {label})" if lib_ms is not None else "none"
    log(f"[{tag}] {name}: kernel {ms:.4f} ms, on the card {on_card:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {lib}, bound {max(ops_ms, bytes_ms):.4f} ms ({'operations' if ops_ms > bytes_ms else 'bytes'}) "
        f"(median of 20)")
    for key in (kernel, *rows):
        st = stats.setdefault(key, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "ops_ms": 0.0,
                                    "bytes_ms": 0.0, "bound_ms": 0.0, "library_ms": None, "card_ms": None,
                                    "library_card_ms": None, "launches": 0})
        st["ms"] += ms
        st["card_ms"] = (st.get("card_ms") or 0.0) + on_card
        st["plain_ms"] += plain_ms
        st["ops_ms"] += ops_ms
        st["bytes_ms"] += bytes_ms
        st["bound_ms"] += max(ops_ms, bytes_ms)
        st["launches"] = st.get("launches", 0) + 1
        if lib_ms is not None:
            st["library_ms"] = (st["library_ms"] or 0.0) + lib_ms
            st["library_card_ms"] = (st.get("library_card_ms") or 0.0) + lib_card


def lib(fn, label: str = "torch", base=None) -> tuple:
    """A library yardstick for _time."""
    return fn, base, label


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")


def sdpa_library(q, k, v, grad=None) -> tuple:
    """scaled_dot_product_attention on q, k, v [B, H, S, dh] (with `grad`,
    its backward: fn the forward and backward, base the forward), pinned
    with torch.nn.attention.sdpa_kernel to the fastest backend that runs
    these shapes on the card alone, so the yardstick does not move with
    PyTorch's choice per call. Returns _time's `library`."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if grad is not None:
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))

    def make(backend):
        def fwd():
            with sdpa_kernel(backend):
                return tnf.scaled_dot_product_attention(q, k, v)

        def both():
            with torch.enable_grad():
                return torch.autograd.grad(fwd(), (q, k, v), grad)

        return (both, fwd) if grad is not None else (fwd, None)

    best = None
    for name in SDPA_BACKENDS:
        fn, base = make(getattr(SDPBackend, name))
        try:
            fn()
            torch.cuda.synchronize()
        except RuntimeError:  # this backend does not run these shapes or dtype
            continue
        t = card_ms(fn) - (card_ms(base) if base is not None else 0.0)
        if best is None or t < best[0]:
            best = (t, fn, base, name)
    if best is None:
        raise RuntimeError("no scaled_dot_product_attention backend runs these shapes")
    _, fn, base, name = best
    return fn, base, f"SDPA {name.lower()}{' backward' if grad is not None else ''}"


def sdpa_inputs(qkv: torch.Tensor, seq_len: int, dtype) -> list:
    """q, k, v [B, H, S, dh] copies of a fused QKV buffer, for the library
    call (scaled_dot_product_attention) timed beside an attention kernel."""
    rows, d3 = qkv.shape
    d = d3 // 3
    return [t.reshape(rows // seq_len, seq_len, H, d // H).transpose(1, 2).contiguous().to(dtype)
            for t in qkv.split(d, dim=-1)]


def kernel_phase(seed: int) -> dict:
    """Each kernel at every shape one layer gives it. stats[kernel]["ms"] is
    the summed median time of the kernel's launches in one layer."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    r = B * S

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    stats = new_stats()
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
            # f32 sums in another order (wgmma tiles vs cuBLAS): relative
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
              lambda: l16.gemm_bf16_plain(a, w, bias, mode), stats, "gemm_bf16",
              2 * a.shape[0] * a.shape[1] * w.shape[1], nbytes(a, w, bias, got), "bf16",
              lib(lambda: torch.matmul(a, w), "torch.matmul"))

    # attention_bf16 on a QKV buffer of the layer's scale
    qkv = l16.gemm_bf16(x2, p16[0], p16[1], "qkv")
    got, ref = kc.attention_bf16(qkv, S, H), kc.attention_bf16_plain(qkv, S, H)
    vmax = qkv[:, 2 * D:].float().abs().max().item()
    # each prob may flip one bf16 rounding (<= 2^-8 p), moving the output by
    # <= 2^-8 max|v| in all (sum p = 1), plus the output's own bf16 rounding
    _check("attention_bf16 [32 seq x 4 heads, S=144, dh=128]", got, ref, 2.0 ** -6 * vmax,
           "2^-6 max|v|: one bf16 flip per prob + output rounding", stats, "attention_bf16")
    q16, k16, v16 = sdpa_inputs(qkv, S, torch.bfloat16)
    _time("attention_bf16", lambda: kc.attention_bf16(qkv, S, H),
          lambda: kc.attention_bf16_plain(qkv, S, H), stats, "attention_bf16",
          4 * r * S * D, nbytes(qkv, got), "bf16", sdpa_library(q16, k16, v16))

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
              lambda: kc.residual_layernorm_plain(a, bb, s_, b_, of, ob), stats, "residual_layernorm",
              0, nbytes(a, bb, s_, b_, *got), None,
              lib(lambda: tnf.layer_norm(a + bb, (D,), s_, b_, kc.LN_EPS), LN_YARDSTICK))
    # the int8 chain's two LayerNorms, each writing the codes of its output
    # (y f32, the next layer's input bf16): the output keeps the gates
    # above, the codes and scales are quant_rows_int8_plain of the kernel's
    # own output exactly. Timed apart (not in the per-layer sums above)
    for name, a, bb, s_, b_, of, ob in (
        ("residual_layernorm LN1 + codes (bf16+f32 -> f32, int8)", x2, res, p8[6], p8[7], True, False),
        ("residual_layernorm LN2 + codes (f32+f32 -> bf16, int8)", y32, res, p8[14], p8[15], False, True),
    ):
        got = kc.residual_layernorm(a, bb, s_, b_, of, ob, quant=True)
        ref = kc.residual_layernorm_plain(a, bb, s_, b_, of, ob)
        out, out_ref = (got[0], ref[0]) if of else (got[1], ref[1])
        if of:
            _check(name + " f32", out, out_ref, 1e-5 * out_ref.abs().max().item(),
                   "f32 mean/var reduction order, 1e-5 of max|ref|", stats, "residual_layernorm")
        else:
            _check(name + " bf16", out, out_ref, BF16_ULP * out_ref.float().abs() + 1e-5, "one bf16 ulp", stats,
                   "residual_layernorm")
        (q, sc), (q_ref, sc_ref) = got[2], l8.quant_rows_int8_plain(out)
        _check(name + " codes", q, q_ref, 0.0, "exact: quant_rows_int8_plain of the kernel's own output", stats,
               "residual_layernorm")
        _check(name + " scales", sc, sc_ref, 0.0, "exact", stats, "residual_layernorm")
        _time(name, lambda: kc.residual_layernorm(a, bb, s_, b_, of, ob, quant=True),
              lambda: kc.residual_layernorm_plain(a, bb, s_, b_, of, ob, quant=True), stats,
              "residual_layernorm + codes", 0, nbytes(a, bb, s_, b_, *got[:2], *got[2]), None)

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
              stats, "quant_rows_int8", 0, nbytes(a, q, sc), None)
    # an all-zero row (amax clamps to 1e-12), a row of ties (x * 127/amax on
    # .5 steps), a row whose max sits in its last element, in both types
    odd = randn(4, F)
    odd[0] = 0.0
    odd[1] = torch.arange(F, device=dev).remainder(5) * 0.5 - 1.0
    odd[2, -1] = 100.0
    for a in (odd, odd.to(torch.bfloat16), odd[:, :D].to(torch.bfloat16)):
        (q, sc), (q_ref, sc_ref) = l8.quant_rows_int8(a), l8.quant_rows_int8_plain(a)
        name = f"quant_rows_int8 zero, tie and end-max rows {str(a.dtype)[6:]} [4,{a.shape[1]}]"
        _check(name + " codes", q, q_ref, 0.0, "exact", stats, "quant_rows_int8")
        _check(name + " scales", sc, sc_ref, 0.0, "exact", stats, "quant_rows_int8")

    # gemm_int8: int32 sums exactly (unit scales, zero bias), then the four
    # products of one int8 layer with their epilogues; the weights K-major
    # (prepare_layer_int8), as the kernel and cuBLASLt's int8 path take them
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
        # and exactly: the plain version's f32 product of int8 values is
        # exact and its epilogue takes the same rounded f32 steps, so only
        # tanhf (the gelu mode) may move an output
        differ, ulps = ulp_diff(got, ref)
        log(f"[kernels] {name}: {differ} of {got.numel()} outputs differ from the plain version, by at most "
            f"{ulps} ulp (exact required{' but for tanhf' if mode == 'gelu' else ''})")
        if differ and mode != "gelu":
            raise AssertionError(f"{name} is not bit-identical to its plain version")
        _time(name, lambda: l8.gemm_int8(a, s_a, w, s_w, bias, mode),
              lambda: l8.gemm_int8_plain(a, s_a, w, s_w, bias, mode), stats, "gemm_int8",
              2 * a.shape[0] * a.shape[1] * w.shape[1], nbytes(a, s_a, w, s_w, bias, got), "int8",
              lib(lambda: torch._int_mm(a, w), "torch._int_mm, K-major weight"))
    st, st16 = stats["gemm_int8"], stats["gemm_bf16"]
    log(f"[kernels] gemm_int8's four products on the card {st['card_ms']:.4f} ms; torch._int_mm on the K-major "
        f"weights {st['library_card_ms']:.4f} (int32 sums only); gemm_bf16 on the same shapes "
        f"{st16['card_ms']:.4f}; bound {st['bound_ms']:.4f} ms")

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
          lambda: l8.attention_int8_plain(qkv8, S, H), stats, "attention_int8",
          4 * r * S * D, nbytes(qkv8, got), "int8")

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
        # 3xTF32 sums against cuBLAS's f32 (TF32 off): the dropped terms
        # (<= ~3 2^-21 |a||b| per product) and the sum order, ~sqrt(K) *
        # 2^-24 of the row's magnitude; gelu's erff against the A-S
        # polynomial adds <= 1.5e-7 * |x| / 2
        gate = 1e-5 * ref.abs().max().item() + 1e-6
        _check(name, got, ref, gate, "f32 accumulation order, 1e-5 of max|ref|", stats, "gemm_f32")
        log(f"[kernels] {name}: worst error {(got - ref).abs().max().item() / gate:.4f} of its gate")
        _time(name, lambda: l32.gemm_f32(a, w, bias, mode, scale, D),
              lambda: l32.gemm_f32_plain(a, w, bias, mode, scale, D), stats, "gemm_f32",
              2 * a.shape[0] * a.shape[1] * w.shape[0], nbytes(a, w, bias, got), "f32",
              lib(lambda: torch.matmul(a, w.t()), "torch.matmul"))

    qkv32 = l32.gemm_f32(x32, sa.in_proj_weight.detach(), sa.in_proj_bias.detach(), "qkv", scale, D)
    got, ref = l32.attention_f32(qkv32, S, H), l32.attention_f32_plain(qkv32, S, H)
    # f32 both sides: 3xTF32 products (their dropped terms and the tensor
    # cores' rounding of their sums), scores, exp and P.V sums in another
    # order
    gate = 1e-5 * qkv32[:, 2 * D:].abs().max().item()
    _check("attention_f32 [32 seq x 4 heads, S=144, dh=128]", got, ref, gate, "f32 sum order, 1e-5 of max|v|",
           stats, "attention_f32")
    log(f"[kernels] attention_f32 [32 seq x 4 heads, S=144, dh=128]: worst error "
        f"{(got - ref).abs().max().item() / gate:.4f} of its gate")
    q32, k32, v32 = sdpa_inputs(qkv32, S, torch.float32)
    _time("attention_f32", lambda: l32.attention_f32(qkv32, S, H),
          lambda: l32.attention_f32_plain(qkv32, S, H), stats, "attention_f32",
          4 * r * S * D, nbytes(qkv32, got), "f32", sdpa_library(q32, k32, v32))

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
              lambda: kc.residual_layernorm_plain(*ln_args), stats, "residual_layernorm two-pass",
              0, nbytes(a, bb, s_, b_, got), None,
              lib(lambda: tnf.layer_norm(a + bb, (D,), s_, b_, kc.LN_EPS), LN_YARDSTICK))
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
# phase 4: the training layer's kernels against their plain versions
# ---------------------------------------------------------------------------


def bf16_copy_check(name: str, copy: torch.Tensor, f32: torch.Tensor) -> None:
    """A kernel's bf16 copy of its own f32 output: round_bf16's result, bit
    for bit."""
    same = torch.equal(copy, lt.round_bf16_plain(f32))
    log(f"[train kernels] {name} {'equals' if same else 'DIFFERS from'} round_bf16_plain of its f32 output")
    if not same:
        raise AssertionError(f"{name} is not its f32 output rounded to bf16")


def _op(t: torch.Tensor, trans: bool) -> torch.Tensor:
    return t.t() if trans else t


def _check_gemm_train(name: str, kw: dict, bf16: bool, stats: dict, kernel: str, row: str) -> None:
    """One product of the chain on the operands the chain hands it (bf16
    in the bf16 mode), kernel against plain, then timed. Both sum exact
    products of the same values in f32 in another order: per element <=
    ~sqrt(K) 2^-24 of sum |a||b| (K <= 9280: < 6e-6), so the gate is 2e-5
    of sum |a||b|, times the epilogue's gain (inv_keep 1.11 x gelu' <=
    1.13), plus 2^-22 of |out| and of an added tensor (their own f32
    roundings), plus one bf16 ulp of |out| for a bf16 output (its rounding
    may flip). A bf16 copy beside the f32 result is that result rounded,
    bit for bit."""
    got, ref = lt.gemm_train(bf16=bf16, **kw), lt.gemm_train_plain(bf16=bf16, **kw)
    a_t, b_t = kw.get("a_t", False), kw.get("b_t", False)
    absprod = lt.gemm_train_plain(kw["a"].abs(), kw["b"].abs(), a_t, b_t, bf16)
    gain = 1.3 if (kw.get("mask") is not None or kw.get("gelu")) else 1.0
    added = kw["add"].abs() if kw.get("add") is not None else 0.0
    la, lb = _op(kw["a"], a_t), _op(kw["b"], b_t)
    m, k, n = la.shape[0], la.shape[1], lb.shape[1]
    label = f"gemm_train {'bf16' if bf16 else 'f32'} {name} [{m}x{k}]x[{k}x{n}]"
    if kw.get("gelu") == 1:
        outs = [(got[0], ref[0], "", gain), (got[1], ref[1], " (pre-gelu h1)", 1.0)]
    elif kw.get("out") == "both":
        outs = [(got[0], ref[0], "", gain)]
        if bf16:
            if not torch.equal(got[1], got[0].to(torch.bfloat16)):
                raise AssertionError(f"{label}: the bf16 copy is not the f32 result rounded")
            log(f"[train kernels] {label}: bf16 copy equals the f32 result rounded, bit for bit")
    else:
        outs = [(got, ref, "", gain)]
    for g_, r_, suffix, gn in outs:
        mag = r_.float().abs()
        tol = 2e-5 * gn * absprod + 2.0 ** -22 * (mag + added) + 1e-7
        if r_.dtype == torch.bfloat16:
            tol = tol + BF16_ULP * mag
        _check(label + suffix, g_, r_, tol, "f32 sum order: 2e-5 sum|a||b| x epilogue gain + output roundings",
               stats, kernel)
        if not bf16:
            log(f"[train kernels] {label}{suffix}: worst error {((g_ - r_).abs() / tol).max().item():.4f} "
                f"of its gate")
    outputs = got if isinstance(got, tuple) else (got,)
    moved = nbytes(kw["a"], kw["b"], kw.get("bias"), kw.get("mask"), kw.get("add"), *outputs,
                   kw.get("aux") if kw.get("gelu") == 2 else None)
    _time(label, lambda: lt.gemm_train(bf16=bf16, **kw), lambda: lt.gemm_train_plain(bf16=bf16, **kw),
          stats, kernel, 2 * m * n * k, moved, "bf16" if bf16 else "f32",
          lib(lambda: torch.matmul(la, lb), "torch.matmul"), tag="train kernels", rows=(row,))


def attention_fwd_gate(qkv: torch.Tensor, mask: torch.Tensor, inv_keep: float, seq_len: int = TS) -> torch.Tensor:
    """Per output element of attention_train_fwd in the bf16 mode against
    its plain version: 2^-14 inv_keep max|v| for the f32 sums of the
    second product and the softmax in another order, plus one bf16 flip
    (the actual step between the two roundings) times |v| of every pd that
    the scores' sums could push across a rounding boundary. A score sums
    dh exact products of bf16 values in f32; on the tensor cores each of
    the dh - 1 additions may be off by up to 2 ulp (their f32 accumulation
    is not round-to-nearest), so |ds| <= 2^-16 scale sum|q||k| for dh <=
    128, and p moves by at most twice the row's largest such bound
    (its own score and the row's normaliser), plus 2^-20 for expf and the
    division."""
    rows, d3 = qkv.shape
    d = d3 // 3
    dh = d // H
    q, k, v = (t.reshape(rows // seq_len, seq_len, H, dh).transpose(1, 2).to(torch.bfloat16).float()
               for t in qkv.split(d, dim=-1))
    scale = dh ** -0.5
    pd = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1) * (mask.float() * inv_keep)
    ds = 2.0 ** -16 * scale * (q.abs() @ k.abs().transpose(-1, -2))
    rel = 2.0 * ds.amax(dim=-1, keepdim=True) + 2.0 ** -20
    flip = (pd * (1.0 + rel)).to(torch.bfloat16).float() - (pd * (1.0 - rel)).to(torch.bfloat16).float()
    return 2.0 ** -14 * inv_keep * v.abs().max() + (flip @ v.abs()).transpose(1, 2).reshape(rows, d)


def check_bwd(name: str, got, qkv, da, mask, seq_len: int, inv_keep: float, bf16: bool, stats: dict) -> list:
    """attention_train_bwd's dq, dk and dv against its plain version in
    f32: 2^-10 (bf16 mode) or 1e-5 (f32 mode) of each one's max|ref|.
    Returns (part, slice, tol, ref) for each part."""
    d = qkv.shape[1] // 3
    ref = lt.attention_train_bwd_plain(qkv, da, mask, seq_len, H, inv_keep, bf16)
    ref = ref[0] if bf16 else ref
    parts = []
    for i, part in enumerate(("dq", "dk", "dv")):
        blk = slice(i * d, (i + 1) * d)
        tol = (2.0 ** -10 if bf16 else 1e-5) * ref[:, blk].abs().max().item()
        log(f"[kernels] {name} {part}: worst error {(got[:, blk] - ref[:, blk]).abs().max().item() / tol:.4f} "
            "of its gate")
        _check(f"{name} {part}", got[:, blk], ref[:, blk], tol, f"{'2^-10' if bf16 else '1e-5'} of max|ref|",
               stats, "attention_train_bwd")
        parts.append((part, blk, tol, ref[:, blk]))
    return parts


def train_kernel_phase(seed: int, stats: dict) -> None:
    """Each training kernel at every shape one layer's forward and backward
    give it (B=64, S=145: R=9280 rows), dropout 0.1 with the same masks on
    both sides, in bf16 and f32 mode, against its plain version; then the
    whole layer through the autograd Function, kernels against the plain
    chain. Adds the per-layer sums to stats (the mode-independent
    LayerNorm and column-sum kernels, and attention's JSON time, from the
    bf16 pass; attention's f32-mode times are logged)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    r = TB * TS

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    torch.manual_seed(seed)  # the layer's weights from the seed alone, whatever ran before
    layer = TransformerEncoderLayer(D, H, F).to(dev)
    with torch.no_grad():  # random biases and LayerNorm parameters, so every term is seen
        for prm in layer.parameters():
            if prm.dim() == 1:
                prm.add_(0.1 * randn(prm.shape[0]))
    params = tuple(t.detach() for t in lt.layer_params(layer))
    _, bqkv, _, bo, g1, be1, _, b1, _, b2, g2, be2 = params
    p = 0.1
    ik = 1.0 / (1.0 - p)
    masks = lt.gen_dropout_masks(g, TB, TS, D, F, H, p)
    fm = lt.flat_masks(masks, r)
    mp, mo, mh, mf = fm
    x, dy = randn(r, D), randn(r, D)
    P = lt.PLAIN
    for bf16 in (True, False):
        mode = "bf16" if bf16 else "f32"
        # attention serves both modes: its JSON entry takes the bf16 pass's
        # times, the f32 pass's go to an entry of their own
        attn_fwd = "attention_train_fwd" if bf16 else "attention_train_fwd (f32 mode)"
        attn_bwd = "attention_train_bwd" if bf16 else "attention_train_bwd (f32 mode)"
        # the plain chain's intermediates are every kernel's inputs, as the
        # chain hands them over (bf16 operands in the bf16 mode)
        kp = lt.cast_weight_mats(params) if bf16 else params
        wq, wo_, w1_, w2_ = (kp[i] for i in lt.WEIGHT_MATS)
        c = P.cast if bf16 else (lambda t: t)
        _, saved = lt.layer_train_fwd(x, kp, fm, TS, H, ik, bf16, P)
        xc, qkv, attn, y1c, norm1, rstd1, h1, gld, norm2, rstd2 = saved
        od = P.gemm(attn, wo_, b_t=True, bf16=bf16, bias=bo, mask=mo, inv_keep=ik)
        y1 = P.ln_fwd(x, od, g1, be1)[0]
        ffd = P.gemm(gld, w2_, b_t=True, bf16=bf16, bias=b2, mask=mf, inv_keep=ik)
        dr2, df = P.ln_bwd(dy, norm2, rstd2, g2, mf, ik)
        dfc = c(df)
        dh1, dh1c = P.gemm(dfc, w2_, bf16=bf16, mask=mh, inv_keep=ik, gelu=2, aux=h1, out="both")
        dy1 = P.gemm(dh1c, w1_, bf16=bf16, add=dr2)
        dr1, do = P.ln_bwd(dy1, norm1, rstd1, g1, mo, ik)
        doc = c(do)
        dattn = P.gemm(doc, wo_, bf16=bf16, out="operand")
        dqkv = P.attn_bwd(qkv, dattn, mp, TS, H, ik, bf16)
        dqkv, dqkvc = dqkv if bf16 else (dqkv, dqkv)
        for name, kw in (
            ("qkv", dict(a=xc, b=wq, b_t=True, bias=bqkv, out="operand")),
            ("out+dropout", dict(a=attn, b=wo_, b_t=True, bias=bo, mask=mo, inv_keep=ik)),
            ("ff1+gelu+dropout", dict(a=y1c, b=w1_, b_t=True, bias=b1, mask=mh, inv_keep=ik, gelu=1,
                                      out="operand")),
            ("ff2+dropout", dict(a=gld, b=w2_, b_t=True, bias=b2, mask=mf, inv_keep=ik)),
            ("dW2", dict(a=dfc, b=gld, a_t=True)),
            ("dh1 (dropout, gelu')", dict(a=dfc, b=w2_, mask=mh, inv_keep=ik, gelu=2, aux=h1, out="both")),
            ("dW1", dict(a=dh1c, b=y1c, a_t=True)),
            ("dy1 (+dr2)", dict(a=dh1c, b=w1_, add=dr2)),
            ("dWo", dict(a=doc, b=attn, a_t=True)),
            ("dattn", dict(a=doc, b=wo_, out="operand")),
            ("dWqkv", dict(a=dqkvc, b=xc, a_t=True)),
            ("dx (+dr1)", dict(a=dqkvc, b=wq, add=dr1)),
        ):
            row = f"K6 {mode}" if kw.get("b_t") else f"K7 {mode}"  # the forward products take W^T
            _check_gemm_train(name, kw, bf16, stats, f"gemm_train {mode}", row)

        # attention forward, on qkv as the chain hands it over (bf16 in the
        # bf16 mode): kernel and plain round the probs at the same points
        # and sum in f32 in other orders. f32 mode: 3xTF32 on the tensor
        # cores, 1e-5 inv_keep max|v|. bf16 mode: the tensor cores'
        # sums of the scores may push a pd across a bf16 rounding boundary
        # (attention_fwd_gate); the f32-mode kernel must fall outside.
        vmax = qkv[:, 2 * D:].abs().max().item()
        got = lt.attention_train_fwd(qkv, mp, TS, H, ik, bf16)
        ref = lt.attention_train_fwd_plain(qkv, mp, TS, H, ik, bf16)
        flat = 2.0 ** -14 * ik * vmax
        if bf16:
            fwd_tol = attention_fwd_gate(qkv, mp, ik)
            over = int(((got - ref).abs() > flat).sum().item())
            log(f"[train kernels] attention_train_fwd bf16: {over} of {got.numel()} outputs off the plain "
                f"version by more than 2^-14 inv_keep max|v| = {flat:.3e}; the per-element gate is "
                f"{fwd_tol.min().item():.3e} to {fwd_tol.max().item():.3e}")
        else:
            fwd_tol = 1e-5 * ik * vmax
        _check(f"attention_train_fwd {mode} [64 seq x 4 heads, S=145, dh=128]", got, ref, fwd_tol,
               "per element: 2^-14 inv_keep max|v| + one bf16 flip of each pd the score sums could move"
               if bf16 else "1e-5 inv_keep max|v|: 3xTF32 products, expf and f32 sum order", stats,
               "attention_train_fwd")
        log(f"[train kernels] attention_train_fwd {mode} [64 seq x 4 heads, S=145, dh=128]: worst error "
            f"{((got - ref).abs() / fwd_tol).max().item():.4f} of its gate")
        ref_fwd = ref
        dt = torch.bfloat16 if bf16 else torch.float32
        qs, ks, vs = sdpa_inputs(qkv, TS, dt)
        _time(f"attention_train_fwd {mode}", lambda: lt.attention_train_fwd(qkv, mp, TS, H, ik, bf16),
              lambda: lt.attention_train_fwd_plain(qkv, mp, TS, H, ik, bf16), stats, attn_fwd,
              4 * r * TS * D, nbytes(qkv, mp, got), mode,
              sdpa_library(qs, ks, vs), tag="train kernels", rows=(f"K6 {mode}",))
        # attention backward, per block of dq, dk, dv (check_bwd; the bf16
        # gate the f32-mode kernel misses); its bf16 copy (the chain's
        # operand of dWqkv and dx) is its f32 result rounded, bit for bit
        got = lt.attention_train_bwd(qkv, dattn, mp, TS, H, ik, bf16)
        got, got16 = got if bf16 else (got, None)
        if bf16:
            if not torch.equal(got16, got.to(torch.bfloat16)):
                raise AssertionError("attention_train_bwd: the bf16 copy of dqkv is not its f32 result rounded")
            log("[train kernels] attention_train_bwd bf16: the bf16 copy of dqkv equals its f32 result rounded")
        parts = check_bwd(f"attention_train_bwd {mode}", got, qkv, dattn, mp, TS, ik, bf16, stats)
        if bf16:
            # the bf16 gates must tell the modes apart: the f32-mode kernels
            # (no bf16 rounding of q, k, v, the probs, dA, pd or ds) held to
            # them against the bf16 plain versions must fall outside
            f32_fwd = lt.attention_train_fwd(qkv.float(), mp, TS, H, ik, False)
            f32_bwd = lt.attention_train_bwd(qkv.float(), dattn.float(), mp, TS, H, ik, False)
            inside = []
            for part, g_, r_, tol in (("fwd", f32_fwd, ref_fwd, fwd_tol),
                                      *((p_, f32_bwd[:, b_], r_, t_) for p_, b_, t_, r_ in parts)):
                err = (g_ - r_).abs()
                outside = int((err > tol).sum().item())
                log(f"[train kernels] attention_train f32-mode kernel {part} against the bf16 plain version: "
                    f"max_abs_err {err.max().item():.3e}, {outside} elements outside the bf16 gate")
                if not outside:
                    inside.append(part)
            if inside:
                raise AssertionError(f"attention_train bf16 gates pass the f32-mode kernel on {inside}: "
                                     "they cannot tell the modes apart")
        sdpa_grad = torch.randn_like(qs)
        _time(f"attention_train_bwd {mode}", lambda: lt.attention_train_bwd(qkv, dattn, mp, TS, H, ik, bf16),
              lambda: lt.attention_train_bwd_plain(qkv, dattn, mp, TS, H, ik, bf16), stats, attn_bwd,
              10 * r * TS * D, nbytes(qkv, dattn, mp, got, got16), mode,
              sdpa_library(qs, ks, vs, sdpa_grad), tag="train kernels", rows=(f"K7 {mode}",))

        # the whole layer through the autograd Function: y, dx and the 12
        # parameter gradients, kernels against the plain chain. f32: sum
        # order through the chain (measured <= 1.6e-6 of each max); bf16:
        # flips of bf16 roundings of f32 operands propagate (measured
        # <= 1.8e-3, on d in_proj_weight)
        tol = 4e-3 if bf16 else 1e-4
        outs = []
        for kernels in (lt.KERNELS, lt.PLAIN):
            layer.zero_grad()
            xx = x.reshape(TB, TS, D).clone().requires_grad_()
            y = lt.fused_train_layer(layer, xx, masks, H, p, "bfloat16" if bf16 else "float32", kernels)
            (y * dy.reshape(TB, TS, D)).sum().backward()
            outs.append([y.detach(), xx.grad] + [t.grad.clone() for t in lt.layer_params(layer)])
        names = ["y", "dx", "d in_proj_weight", "d in_proj_bias", "d out_proj.weight", "d out_proj.bias",
                 "d norm1.weight", "d norm1.bias", "d linear1.weight", "d linear1.bias",
                 "d linear2.weight", "d linear2.bias", "d norm2.weight", "d norm2.bias"]
        for nm, got, ref in zip(names, *outs):
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            log(f"[train kernels] layer {mode} {nm}: max_abs_err {err:.3e} of max|ref| {scale:.3e} "
                f"(tolerance {tol} of max|ref|)")
            if err > tol * scale:
                raise AssertionError(f"training layer {mode}: {nm} disagrees with the plain chain")
        layer.zero_grad()

        def fwd_chain(k=lt.KERNELS):
            return lt.layer_train_fwd(x, kp, fm, TS, H, ik, bf16, k)

        def bwd_chain(k=lt.KERNELS):
            return lt.layer_train_bwd(dy, saved, kp, fm, TS, H, ik, bf16, k)

        fwd, fwd_plain, fwd_card = median_ms(fwd_chain), median_ms(lambda: fwd_chain(P)), card_ms(fwd_chain)
        bwd, bwd_plain, bwd_card = median_ms(bwd_chain), median_ms(lambda: bwd_chain(P)), card_ms(bwd_chain)
        log(f"[train kernels] layer {mode}: forward {fwd:.4f} ms (on the card alone {fwd_card:.4f}, plain "
            f"{fwd_plain:.4f}), backward {bwd:.4f} ms (on the card alone {bwd_card:.4f}, plain {bwd_plain:.4f}) "
            f"per layer (median of 20)")
        stats[f"train layer {mode}"] = {"fwd_ms": fwd, "fwd_card_ms": fwd_card, "fwd_plain_ms": fwd_plain,
                                        "bwd_ms": bwd, "bwd_card_ms": bwd_card, "bwd_plain_ms": bwd_plain}
        if not bf16:
            continue

        # round_bf16 on the two activations the chain casts (x, attn; the
        # LayerNorm kernels hand over y1, df and do in bf16): exact (the
        # same round-to-nearest-even as torch's cast)
        for name, a in (("x", x), ("attn", ref_fwd)):
            got = lt.round_bf16(a)
            _check(f"round_bf16 {name} [{a.shape[0]}x{a.shape[1]}]", got, lt.round_bf16_plain(a), 0.0,
                   "exact: round to nearest even", stats, "round_bf16")
            _time(f"round_bf16 {name}", lambda: lt.round_bf16(a), lambda: lt.round_bf16_plain(a), stats,
                  "round_bf16", 0, nbytes(a, got), None, lib(lambda: a.to(torch.bfloat16), ".to(bfloat16)"),
                  tag="train kernels", rows=("K6 bf16",))

        # LayerNorm forward (LN1, LN2) and backward (LN2, LN1), and the six
        # column sums: f32 kernels, checked once. In the bf16 mode LN1's
        # forward and both backwards also write a bf16 copy of what the
        # next products take (y1; df, do), which must be their f32 output
        # rounded, bit for bit; the K6/K7 f32 rows time them without it
        for name, a, b, gm, bt, copy in (("LN1", x, od, g1, be1, True), ("LN2", y1, ffd, g2, be2, False)):
            got = lt.layernorm_train_fwd(a, b, gm, bt, out_bf16=copy)
            ref = lt.layernorm_train_fwd_plain(a, b, gm, bt, out_bf16=copy)
            for part, g_, r_ in zip(("y", "norm", "rstd"), got, ref):
                _check(f"layernorm_train_fwd {name} {part}", g_, r_, 1e-5 * r_.abs().max().item(),
                       "f32 mean/var reduction order, 1e-5 of max|ref|", stats, "layernorm_train_fwd")
            if copy:
                bf16_copy_check(f"layernorm_train_fwd {name}: y's bf16 copy", got[3], got[0])
            # the bf16 mode's call for the kernel's entry and K6 bf16, the
            # f32 mode's (no copy) for K6 f32
            runs = [(True, "layernorm_train_fwd", ("K6 bf16",)), (False, "K6 f32", ())] if copy else \
                [(False, "layernorm_train_fwd", ("K6 bf16", "K6 f32"))]
            for with_copy, kernel, rows in runs:
                _time(f"layernorm_train_fwd {name}{' with its bf16 copy' if with_copy else ''}",
                      lambda c_=with_copy: lt.layernorm_train_fwd(a, b, gm, bt, out_bf16=c_),
                      lambda c_=with_copy: lt.layernorm_train_fwd_plain(a, b, gm, bt, out_bf16=c_), stats, kernel,
                      0, nbytes(a, b, gm, bt, *got[:3 + with_copy]), None,
                      lib(lambda: tnf.layer_norm(a + b, (D,), gm, bt, kc.LN_EPS), LN_YARDSTICK), tag="train kernels",
                      rows=rows)
        for name, d_, nrm, rs, gm, mk, a, b in (("LN2", dy, norm2, rstd2, g2, mf, y1, ffd),
                                                ("LN1", dy1, norm1, rstd1, g1, mo, x, od)):
            got = lt.layernorm_train_bwd(d_, nrm, rs, gm, mk, ik, out_bf16=True)
            ref = lt.layernorm_train_bwd_plain(d_, nrm, rs, gm, mk, ik)
            for part, g_, r_ in zip(("dr", "dr*mask"), got, ref):
                _check(f"layernorm_train_bwd {name} {part}", g_, r_, 1e-5 * r_.abs().max().item(),
                       "f32 row-mean order, 1e-5 of max|ref|", stats, "layernorm_train_bwd")
            bf16_copy_check(f"layernorm_train_bwd {name}: dr*mask's bf16 copy", got[2], got[1])
            rin = (a + b).requires_grad_()
            gml, btl = gm.clone().requires_grad_(), torch.zeros_like(gm).requires_grad_()

            def ln_fwd(rin=rin, gml=gml, btl=btl):
                return tnf.layer_norm(rin, (D,), gml, btl, kc.LN_EPS)

            def ln_fwd_bwd(rin=rin, gml=gml, btl=btl, d_=d_, ln_fwd=ln_fwd):
                with torch.enable_grad():
                    return torch.autograd.grad(ln_fwd(), (rin, gml, btl), d_)

            for with_copy, kernel, rows in ((True, "layernorm_train_bwd", ("K7 bf16",)), (False, "K7 f32", ())):
                _time(f"layernorm_train_bwd {name}{' with its bf16 copy' if with_copy else ''}",
                      lambda c_=with_copy: lt.layernorm_train_bwd(d_, nrm, rs, gm, mk, ik, out_bf16=c_),
                      lambda c_=with_copy: lt.layernorm_train_bwd_plain(d_, nrm, rs, gm, mk, ik, out_bf16=c_),
                      stats, kernel, 0, nbytes(d_, nrm, rs, gm, mk, *got[:2 + with_copy]), None,
                      lib(ln_fwd_bwd, "layer_norm backward", base=ln_fwd), tag="train kernels", rows=rows)
        for name, a, b in (("dg2, dbe2", dy, norm2), ("db2", df, None), ("db1", dh1, None),
                           ("dg1, dbe1", dy1, norm1), ("dbo", do, None), ("dbqkv", dqkv, None)):
            sums = check_colsum(name, a, b, stats)
            _time(f"colsum {name}", lambda: lt.colsum(a, b), lambda: lt.colsum_plain(a, b), stats, "colsum",
                  0, nbytes(a, b, *sums), None,
                  lib(lambda: torch.einsum("rn,rn->n", a, b), "einsum") if b is not None
                  else lib(lambda: a.sum(0), "sum"), tag="train kernels", rows=("K7 bf16", "K7 f32"))
        # rows off every multiple the kernel steps by (8 blocks, 64 rows, 4 loads in flight)
        extra = torch.randn(37, D, generator=torch.Generator(device=dev).manual_seed(seed + 37), device=dev)
        check_colsum("dg1, dbe1, 37 rows more", torch.cat([dy1, extra]), torch.cat([norm1, extra]), stats)
    for row in ("K6 bf16", "K7 bf16", "K6 f32", "K7 f32"):
        st = stats[row]
        by = "operations" if st["ops_ms"] > st["bytes_ms"] else "bytes"
        log(f"[train kernels] {row}, its kernels one by one at one layer's shapes: {st['launches']} launches, "
            f"kernels {st['ms']:.4f} ms (on the card {st['card_ms']:.4f}), plain {st['plain_ms']:.4f} ms, "
            f"library {st['library_ms']:.4f} ms (on the card {st['library_card_ms']:.4f}), "
            f"bound {st['bound_ms']:.4f} ms ({by})")
    # a cold L2 keeps every time on the card at or above its bound: the
    # casts, the most memory-bound kernel, show it
    st = stats["round_bf16"]
    log(f"[train kernels] round_bf16 on the card {st['card_ms']:.4f} ms against its bound {st['bound_ms']:.4f} ms")
    if st["card_ms"] < st["bound_ms"]:
        raise AssertionError("round_bf16 beats its memory bound: card_ms does not see a cold L2")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 4b: every attention kernel at long sequences
# ---------------------------------------------------------------------------

# the shipped training length, one past each kernel's old single-tile limit
# at dh = 128 (160: attention_train forward bf16 and backward; 166:
# attention_f32 and the f32 training forward; 176: attention_bf16, K5 and
# attention_int8's key tiles; 208: the limit attention_int8's header once
# stated), and 1024; attention_int8 also at the limit of its one block per
# (sequence, head) and one past it
LONG_S = (145, 161, 167, 177, 209, 1024)
INT8_HEAD_S = (l8.ATTENTION_INT8_HEAD_KEYS, l8.ATTENTION_INT8_HEAD_KEYS + 1)
LONG_B = 2  # sequences per call


def check_colsum(name: str, a: torch.Tensor, b, stats: dict) -> tuple:
    """colsum against colsum_plain within 1e-5 of sum|terms|, and bit for bit
    the same in a second run (a fixed order of sums, no atomics). Returns
    the kernel's sums."""
    got, again, ref = lt.colsum(a, b), lt.colsum(a, b), lt.colsum_plain(a, b)
    got, again, ref = (got, again, ref) if b is not None else ((got,), (again,), (ref,))
    sums = ((a * b).abs().sum(0), a.abs().sum(0)) if b is not None else (a.abs().sum(0),)
    for g_, a_, r_, sm in zip(got, again, ref, sums):
        # ~9280 terms in another order: <= ~sqrt(R) 2^-24 of sum |a|
        _check(f"colsum {name} [{a.shape[0]}x{a.shape[1]}]", g_, r_, 1e-5 * sm + 1e-6,
               "f32 sum order, 1e-5 of sum|terms|", stats, "colsum")
        if not torch.equal(g_, a_):
            raise AssertionError(f"colsum {name}: two runs differ")
    log(f"[train kernels] colsum {name} [{a.shape[0]}x{a.shape[1]}]: two runs bit-identical")
    return got


def chain_attention_operands(params: tuple, fm: tuple, x, dy, seq_len: int, inv_keep: float, bf16: bool):
    """qkv and d(attn) as the plain training chain hands them to the
    attention backward (bf16 in the bf16 mode), for x and dy [R, D]."""
    seen = {}

    def attn_bwd(qkv, da, *args, **kw):
        seen["qkv"], seen["da"] = qkv, da
        return lt.attention_train_bwd_plain(qkv, da, *args, **kw)

    k = lt.PLAIN._replace(attn_bwd=attn_bwd)
    kp = lt.cast_weight_mats(params) if bf16 else params
    _, saved = lt.layer_train_fwd(x, kp, fm, seq_len, H, inv_keep, bf16, k)
    lt.layer_train_bwd(dy, saved, kp, fm, seq_len, H, inv_keep, bf16, k)
    return seen["qkv"], seen["da"]


def check_attention_int8(q16: torch.Tensor, s: int, shape: str, stats: dict) -> None:
    """attention_int8 on a bf16 QKV buffer of LONG_B sequences of s rows
    against its plain version, under phase 3's gate."""
    ref = l8.attention_int8_plain(q16, s, H)
    cmax = l8.attention_int8_codes(q16, s, H)[-1].expand(LONG_B, H, s, D // H).transpose(1, 2).reshape(-1, D)
    _check(f"attention_int8 {shape}", l8.attention_int8(q16, s, H), ref,
           cmax / 127.0 + BF16_ULP * ref.float().abs(), "one prob code (vmax/127 of the column) + one bf16 ulp",
           stats, "attention_int8")


def long_seq_phase(seed: int, stats: dict) -> None:
    """Each attention kernel of the port at every S of LONG_S, on LONG_B
    sequences at full width (D=512, H=4, dh=128), against its plain version
    under the gates of phases 3, 4 and 8: the inference kernels on random
    QKV buffers, the training kernels on the operands the plain chain of a
    random layer hands them (dropout 0.1), as phase 4; K5 (8 layers of a
    random PoseNet) against 8 launches of the K3 chain, bit for bit; then
    attention_int8 at INT8_HEAD_S, both sides of the limit of its one block
    per (sequence, head)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev, dh, ik = "cuda", D // H, 1.0 / 0.9
    torch.manual_seed(seed)
    posenet = PoseNet().to(dev)
    # the K3 chain takes the per-layer prep, K5 the stacked one (both
    # K-major): the same codes and scales
    stacked = l8.prepare_posenet_int8(posenet, mega=True)["layers_stacked"]
    layers = l8.prepare_posenet_int8(posenet)["layers"]
    train_layer = TransformerEncoderLayer(D, H, F).to(dev)
    with torch.no_grad():  # random biases and LayerNorm parameters, as phase 4
        for prm in train_layer.parameters():
            if prm.dim() == 1:
                prm.add_(0.1 * torch.randn(prm.shape[0], generator=g, device=dev))
    params = tuple(t.detach() for t in lt.layer_params(train_layer))
    for s in LONG_S:
        r = LONG_B * s
        shape = f"[{LONG_B} seq x {H} heads, S={s}, dh={dh}]"
        # inference attention: Q pre-scaled by 1/sqrt(dh), as the layers' QKV products leave it
        qkv = torch.randn(r, 3 * D, generator=g, device=dev)
        qkv[:, :D] *= dh ** -0.5
        vmax = qkv[:, 2 * D:].abs().max().item()
        got, ref = l32.attention_f32(qkv, s, H), l32.attention_f32_plain(qkv, s, H)
        _check(f"attention_f32 {shape}", got, ref, 1e-5 * vmax, "f32 sum order, 1e-5 of max|v|", stats,
               "attention_f32")
        log(f"[long S] attention_f32 {shape}: worst error {(got - ref).abs().max().item() / (1e-5 * vmax):.4f} "
            "of its gate")
        q16 = qkv.to(torch.bfloat16)
        _check(f"attention_bf16 {shape}", kc.attention_bf16(q16, s, H), kc.attention_bf16_plain(q16, s, H),
               2.0 ** -6 * vmax, "2^-6 max|v|: one bf16 flip per prob + output rounding", stats, "attention_bf16")
        check_attention_int8(q16, s, shape, stats)
        x = torch.randn(LONG_B, s, D, generator=g, device=dev).to(torch.bfloat16)
        k3 = l8.fused_encoder_layers_int8(x, layers, H)
        same = torch.equal(l8.fused_encoder_stack_int8(x, stacked, H), k3)
        log(f"[long S] encoder_stack_int8 [{LONG_B}, {s}, {D}] x 8 layers against the 8-layer K3 chain: "
            f"{'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"the stack kernel is not bit-identical to the K3 chain at S={s}")

        # training attention
        fm = lt.flat_masks(lt.gen_dropout_masks(g, LONG_B, s, D, F, H, 0.1), r)
        mask = fm[0]
        xt, dy = torch.randn(r, D, generator=g, device=dev), torch.randn(r, D, generator=g, device=dev)
        for bf16 in (True, False):
            mode = "bf16" if bf16 else "f32"
            qq, dd = chain_attention_operands(params, fm, xt, dy, s, ik, bf16)
            got = lt.attention_train_fwd(qq, mask, s, H, ik, bf16)
            ref = lt.attention_train_fwd_plain(qq, mask, s, H, ik, bf16)
            vmax = qq[:, 2 * D:].float().abs().max().item()
            tol = attention_fwd_gate(qq, mask, ik, s) if bf16 else 1e-5 * ik * vmax
            _check(f"attention_train_fwd {mode} {shape}", got, ref, tol,
                   "per element: 2^-14 inv_keep max|v| + one bf16 flip of each pd the score sums could move"
                   if bf16 else "1e-5 inv_keep max|v|", stats, "attention_train_fwd")
            log(f"[long S] attention_train_fwd {mode} {shape}: worst error "
                f"{((got - ref).abs() / tol).max().item():.4f} of its gate")
            got = lt.attention_train_bwd(qq, dd, mask, s, H, ik, bf16)
            got, got16 = got if bf16 else (got, None)
            check_bwd(f"attention_train_bwd {mode} {shape}", got, qq, dd, mask, s, ik, bf16, stats)
            if bf16 and not torch.equal(got16, got.to(torch.bfloat16)):
                raise AssertionError(f"attention_train_bwd: the bf16 copy of dqkv is not its f32 result at S={s}")
    for s in INT8_HEAD_S:
        qkv = torch.randn(LONG_B * s, 3 * D, generator=g, device=dev)
        qkv[:, :D] *= dh ** -0.5
        check_attention_int8(qkv.to(torch.bfloat16), s, f"[{LONG_B} seq x {H} heads, S={s}, dh={dh}]", stats)
    torch.cuda.synchronize()


def long_seq_timing(seed: int) -> None:
    """Each attention kernel's time on the card alone (card_ms) at S = 145
    (one key tile), 161 (two tiles: the sweeps for the rows' max and sum)
    and 1024, on about the training batch's rows (9280: 64, 57 and 9
    sequences; random inputs), and per B S^2, the attention's work. Where
    the tiled path at 161 costs per B S^2 what the one-tile path costs at
    145, the one-tile path does not pay for itself. K5 (8 layers, a
    cooperative launch) by events on 4608 rows."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dh, ik = D // H, 1.0 / 0.9
    torch.manual_seed(seed)
    stacked = l8.prepare_posenet_int8(PoseNet().cuda(), mega=True)["layers_stacked"]
    for s in (145, 161, 1024):
        b = 9280 // s
        qkv = torch.randn(b * s, 3 * D, generator=g, device="cuda")
        qkv[:, :D] *= dh ** -0.5
        q16 = qkv.to(torch.bfloat16)
        da = torch.randn(b * s, D, generator=g, device="cuda")
        da16 = da.to(torch.bfloat16)
        mask = lt.gen_dropout_masks(g, b, s, D, F, H, 0.1)[0]
        for name, fn in (("attention_f32", lambda: l32.attention_f32(qkv, s, H)),
                         ("attention_bf16", lambda: kc.attention_bf16(q16, s, H)),
                         ("attention_int8", lambda: l8.attention_int8(q16, s, H)),
                         ("attention_train_fwd bf16", lambda: lt.attention_train_fwd(q16, mask, s, H, ik, True)),
                         ("attention_train_fwd f32", lambda: lt.attention_train_fwd(qkv, mask, s, H, ik, False)),
                         ("attention_train_bwd bf16", lambda: lt.attention_train_bwd(q16, da16, mask, s, H, ik, True)),
                         ("attention_train_bwd f32", lambda: lt.attention_train_bwd(qkv, da, mask, s, H, ik, False))):
            t = card_ms(fn, calls=3, reps=5)
            log(f"[long S timing] {name} [{b} seq x {H} heads, S={s}, dh={dh}]: on the card {t:.4f} ms, "
                f"{1e6 * t / (b * s * s):.4f} ns per B S^2")
        bk = 4608 // s
        x = torch.randn(bk, s, D, generator=g, device="cuda").to(torch.bfloat16)
        t = median_ms(lambda: l8.fused_encoder_stack_int8(x, stacked, H), reps=5)
        log(f"[long S timing] encoder_stack_int8 [{bk}, {s}, {D}] x 8 layers: by events {t:.4f} ms, "
            f"{1e6 * t / (bk * s * s):.4f} ns per B S^2")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 5: the slice
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


PER_LAYER_LAUNCHES = {  # fused_posenet mode -> kernel -> launches per layer
    "bf16": {"gemm_bf16": 4, "attention_bf16": 1, "residual_layernorm": 2},
    # the int8 chain quantizes the attention output and h1; the LayerNorms
    # write the codes of y and of the next layer's input
    "int8": {"quant_rows_int8": 2, "gemm_int8": 4, "attention_bf16": 1, "residual_layernorm": 2},
    "int8qa": {"quant_rows_int8": 2, "gemm_int8": 4, "attention_int8": 1, "residual_layernorm": 2},
    "f32": {"gemm_f32": 4, "attention_f32": 1, "residual_layernorm two-pass": 2},
}
# launches once per forward: the int8 chain quantizes the stack's input
PER_FORWARD_LAUNCHES = {"int8": {"quant_rows_int8": 1}, "int8qa": {"quant_rows_int8": 1}}


def forward_launches(mode: str, forwards: int = 1) -> dict:
    """Launches per kernel of `forwards` 8-layer PoseNet forwards in a
    fused_posenet mode (the int8 modes: 1 + 2 L quant_rows_int8 each)."""
    out = dict.fromkeys(KERNELS, 0)
    for name, k in PER_LAYER_LAUNCHES[mode].items():
        out[name] += k * LAYERS * forwards
    for name, k in PER_FORWARD_LAUNCHES.get(mode, {}).items():
        out[name] += k * forwards
    return out


def expected_launches(batches: dict) -> dict:
    """Launches per kernel for full batches in each fused_posenet mode:
    2 iterations x 1000 PoseNet forwards, each the chain of 8 layers."""
    out = dict.fromkeys(KERNELS, 0)
    for mode, n in batches.items():
        for name, k in forward_launches(mode, 2 * 1000 * n).items():
            out[name] += k
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
    for mode in ("bf16", "int8", "int8qa", "f32"):
        posenet_envelope("slice", pipes[mode], noisy_n, x_t, ref)

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


# fused PoseNet vs the f32 module, one step, mode -> (max, mean) |err|: the
# per-layer envelope of tests/test_ops.py on the mean; the max may grow over
# eight layers, so it is held at four times the per-layer one; the f32 path
# is f32 throughout, so only summation order (and erff against torch's erf)
# separates it
POSENET_ENVELOPES = {"bf16": (6e-2 * 4, 1e-2), "int8": (0.3 * 4, 5e-2),
                     "int8qa": (0.3 * 4, 5e-2), "f32": (2e-3, 1e-4)}


def posenet_envelope(tag: str, pipe: RohmPipeline, cond: torch.Tensor, x_t: torch.Tensor,
                     ref: torch.Tensor) -> None:
    """The pipeline's fused PoseNet step on (x_t, cond) at t=500 against
    `ref`, the f32 module's output on the same inputs, within its mode's
    envelope; the traj dims pass the condition through unchanged."""
    mode = pipe.fused_posenet
    atol, mean_tol = POSENET_ENVELOPES[mode]
    out = pipe._pose_model_fn(cond)(x_t, 500)
    err = (out - ref).abs()
    log(f"[{tag}] PoseNet {mode} kernels vs f32 module, {pipe.posenet.num_layers} layers, one step "
        f"at {list(x_t.shape)}: max {err.max().item():.3e} mean {err.mean().item():.3e}")
    if not (torch.isfinite(out).all() and err.mean().item() < mean_tol and err.max().item() < atol):
        raise AssertionError(f"PoseNet {mode} kernels stray from the f32 module")
    if not torch.equal(out[..., :22], cond[..., :22]):
        raise AssertionError("traj passthrough dims are not the condition's")


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
        device_busy(steps[mode], 20, f"{mode} PoseNet steps", "breakdown")


def device_busy(fn, n: int, what: str, tag: str) -> float:
    """Run fn n times under torch.profiler: log the device's busy share of
    the wall time under the profiler (which slows the host side of an eager
    step), the kernels' time per call and the largest kernels; returns the
    busy share."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # a record_function span (AdamW's "Optimizer.step#...") also shows on the
    # device's timeline, over the kernels it covers: counted once, as those
    kernels = sorted(
        ((e.key, e.self_device_time_total) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)),
        key=lambda kv: -kv[1],
    )
    busy = sum(us for _, us in kernels)
    log(f"[{tag}] {what} x{n} under the profiler: device busy {busy / wall_us:.3f} "
        f"of {wall_us / 1e3:.1f} ms wall, {busy / (n * 1e3):.2f} ms of kernels each")
    for name, us in kernels[:8]:
        log(f"[{tag}]   {us / busy:.3f}  {us / (n * 1e3):.4f} ms each  {name[:90]}")
    return busy / wall_us


# ---------------------------------------------------------------------------
# phase 6: PoseNet training through the CLI
# ---------------------------------------------------------------------------

TRAIN_STEPS = {"bfloat16": 20, "float32": 4, "": 4}  # --fused_train -> --num_steps
TRAIN_EVAL_AT = 10  # --log_interval of the bf16 run: one in-training eval
CLIPS_PER_TRAIN_SEQ = 8
# the training trees under the work directory: name, train and test sequences
# per dataset (phase 6 writes them, phase 6b trains on them too)
TRAIN_TREES = {"full": ("train_full", 12, 11), "small": ("train_small", 3, 1)}


def write_train_tree(root: Path, body, train_seqs: int, test_seqs: int, seed: int) -> None:
    """A synthetic AMASS tree for train_posenet: the 15 train datasets with
    `train_seqs` sequences of 8 clips each, and the 3 test datasets with
    `test_seqs` sequences of 4 clips (the test split drops a sequence's
    first and last frame, then keeps every second clip)."""
    from rohm_tpu_torch.cli.common import AMASS_TEST_DATASETS, AMASS_TRAIN_DATASETS
    from rohm_tpu_torch.data import write_synthetic_amass

    write_synthetic_amass(str(root), body, datasets={n: train_seqs for n in AMASS_TRAIN_DATASETS},
                          seq_len=CLIPS_PER_TRAIN_SEQ * CLIP_LEN, seed=seed)
    write_synthetic_amass(str(root), body, datasets={n: test_seqs for n in AMASS_TEST_DATASETS},
                          seq_len=4 * CLIP_LEN + 2, seed=seed + 1)


def expected_train_launches(mode: str, steps: int) -> dict:
    """Per optimizer step and layer, the chain runs 12 products, one
    attention forward and backward, two LayerNorms each way and six column
    sums, and in bf16 mode two casts of activation operands (x, attn: qkv,
    gld, dh1, dattn and dqkv come as bf16 from the products and the
    attention backward that make them, y1, df and do from the LayerNorm
    kernels); the plain path ("") launches no kernel."""
    out = dict.fromkeys(KERNELS, 0)
    if not mode:
        return out
    gemm = "gemm_train bf16" if mode == "bfloat16" else "gemm_train f32"
    per_layer = {gemm: 12, "attention_train_fwd": 1, "attention_train_bwd": 1,
                 "layernorm_train_fwd": 2, "layernorm_train_bwd": 2, "colsum": 6}
    if mode == "bfloat16":
        per_layer["round_bf16"] = 2
    for name, k in per_layer.items():
        out[name] = k * LAYERS * steps
    return out


def time_steps(step) -> tuple[float, int, int]:
    """ms per optimizer step (host clock around a synchronised step, median
    of 10 after 3 warm-up steps), the peak memory of the 10 steps, and what
    was allocated before them (the model, the optimizer, earlier phases)."""
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), torch.cuda.max_memory_allocated(), held


def train_timing(loop, mode: str) -> dict:
    """ms per optimizer step (host clock around a synchronised step, median
    of 10 after 3 warm-up steps), its pieces timed alone (median CUDA-event
    ms), the device's busy share over 5 steps and the peak memory of the
    steps. The steps keep training the run's model."""
    batch = next(loop.train_dataset.batches(TB, seed=123))
    sb = {"motion_repr_clean": loop._to_device(batch["motion_repr_clean"]),
          "cond": loop._to_device(loop._make_cond(batch, 0))}
    skating = torch.tensor(1.0, device="cuda")

    def step():
        loop.train_step(loop.state, sb, loop.generator, skating)

    step_ms, peak, held = time_steps(step)
    model = loop.state.model
    gen = torch.Generator(device="cuda").manual_seed(7)
    clean, cond = sb["motion_repr_clean"], sb["cond"]
    frames = clean.shape[1]
    t = torch.randint(0, 1000, (TB,), generator=gen, device="cuda")
    x_t = torch.randn(clean.shape, generator=gen, device="cuda")
    masks = lt.posenet_dropout_masks(gen, model, TB, frames)
    g_out = torch.randn(clean.shape, generator=gen, device="cuda")

    def forward():
        with torch.enable_grad():
            if mode:
                return lt.posenet_apply_train(model, x_t, cond, t, masks, mode)
            return model.forward_train(x_t, cond, t, masks)

    out_graph = forward()  # its graph is kept for the timed backward passes
    out0 = out_graph.detach()

    def losses():
        o = out0.clone().requires_grad_()
        with torch.enable_grad():
            loop.eval_loss_fn(o, clean)["loss"].backward()

    ms = {
        "draws (t, noise, dropout masks)": median_ms(
            lambda: (torch.randint(0, 1000, (TB,), generator=gen, device="cuda"),
                     torch.randn(clean.shape, generator=gen, device="cuda"),
                     lt.posenet_dropout_masks(gen, model, TB, frames))),
        "PoseNet forward (embeddings, 8 layers, head)": median_ms(forward),
        "PoseNet backward": median_ms(lambda: out_graph.backward(g_out, retain_graph=True)),
        "losses through SMPL-X, forward + backward": median_ms(losses),
        "optimizer (AdamW)": median_ms(loop.state.optimizer.step),
    }
    log(f"[train] --fused_train={mode!r}: {step_ms:.2f} ms per optimizer step (host clock, median of 10 "
        f"after 3 warm-up; batch {TB} x {frames} frames), peak memory of the steps "
        f"{peak / 2**30:.2f} GiB, {(peak - held) / 2**30:.2f} GiB above what was allocated before them")
    for name, v in ms.items():
        log(f"[train]   {name}: {v:.3f} ms (median of 20)")
    busy = device_busy(step, 5, f"--fused_train={mode!r} optimizer steps", "train")
    return {"step_ms": step_ms, "pieces_ms": ms, "busy": busy, "steps_peak_bytes": peak, "held_bytes": held}


def train_phase(seed: int, work: Path, body_path: Path) -> dict:
    """train_posenet.main in each --fused_train mode at full width; returns
    the launch counts of the runs, the bf16 run's checkpoint and the
    timings."""
    from types import SimpleNamespace

    from rohm_tpu_torch.cli import train_posenet
    from rohm_tpu_torch.cli.common import build_posenet
    from rohm_tpu_torch.train.checkpoint import latest_checkpoint

    body = synthetic_model(num_verts=10475, seed=seed, device="cuda")
    t0 = time.perf_counter()
    trees = {k: (work / name, train_seqs, test_seqs) for k, (name, train_seqs, test_seqs) in TRAIN_TREES.items()}
    for root, train_seqs, test_seqs in trees.values():
        write_train_tree(root, body, train_seqs, test_seqs, seed)
    log(f"[train] synthetic trees: 15 train datasets x 12 / 3 sequences of {CLIPS_PER_TRAIN_SEQ} clips "
        f"(1440 / 360 clips: 22 / 5 batches of {TB}), 3 test datasets x 11 / 1 sequences of 4 clips, "
        f"{time.perf_counter() - t0:.2f} s")
    init = [t.cuda() for t in build_posenet(SimpleNamespace(latent_dim=D), seed=seed).parameters()]
    launches = dict.fromkeys(KERNELS, 0)
    out = {}
    for mode, steps in TRAIN_STEPS.items():
        root = trees["full" if mode == "bfloat16" else "small"][0]
        log_interval = TRAIN_EVAL_AT if mode == "bfloat16" else 10**9
        save_dir = work / f"runs_{mode or 'plain'}"
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loop = train_posenet.main([
            "--config=cfg_files/train_cfg/posenet_train_stage1.yaml", f"--dataset_root={root}",
            f"--body_model_path={body_path}", f"--save_dir={save_dir}", f"--fused_train={mode}",
            f"--num_steps={steps}", f"--log_interval={log_interval}", "--save_interval=1000000000",
            f"--seed={seed}", "--device=0",
        ])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counts = read_launches()
        expected = expected_train_launches(mode, loop.step)
        log(f"[train] --fused_train={mode!r}: main() {seconds:.2f} s, {loop.step} steps, "
            f"peak memory {peak / 2**30:.2f} GiB; launches {counts}; expected {expected}")
        if loop.step != steps or counts != expected:
            raise AssertionError(f"the {mode!r} training run did not go through its kernels as the chain implies")
        for name in launches:
            launches[name] += counts[name]
        losses = {k: float(v) for k, v in loop.last_losses.items()}
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"non-finite losses in the {mode!r} run: {losses}")
        moved = [not torch.equal(a, b) for a, b in zip(init, loop.state.model.parameters())]
        if not all(moved):
            raise AssertionError(f"the {mode!r} run left {moved.count(False)} parameter tensors untouched")
        ckpt = latest_checkpoint(loop.logdir)
        run_log = "".join(p.read_text() for p in Path(loop.logdir).glob("run_*.log"))
        evals = run_log.count("[eval]  loss:")
        log(f"[train] --fused_train={mode!r}: last loss {losses['loss']:.4f}, checkpoint {Path(ckpt).name}, "
            f"in-training evals {evals}")
        if not ckpt.endswith(f"model{steps:09d}.npz") or evals != (1 if mode == "bfloat16" else 0):
            raise AssertionError(f"the {mode!r} run's checkpoint or eval is missing")
        out[mode] = {"main_s": seconds, "peak_bytes": peak, "losses": losses, "checkpoint": ckpt,
                     **train_timing(loop, mode)}
        del loop
        torch.cuda.empty_cache()
    return {"launches": launches, "runs": out, "checkpoint": out["bfloat16"]["checkpoint"]}


# ---------------------------------------------------------------------------
# phase 6b: TrajNet and TrajControl training through the CLI
# ---------------------------------------------------------------------------

# run -> (YAML, tree, --num_steps, --log_interval): 20 steps of the 22
# batches of the full tree with one in-training eval of the 100-step chain,
# then the TrajControl fine-tune from its checkpoint on the small tree's 5
TRAJ_TRAIN_RUNS = {
    "vanilla": ("trajnet_train_vanilla_stage1.yaml", "full", 20, 10),
    "trajcontrol": ("trajnet_ft_trajcontrol.yaml", "small", 4, 10**9),
}


def trajnet_train_timing(loop, run: str) -> dict:
    """As train_timing for a TrajNet run: ms per optimizer step and the
    peak memory of the steps (time_steps), the step's pieces timed alone
    (median CUDA-event ms) and the device's busy share over 5 steps. The
    steps keep training the run's model (its trainable parameters)."""
    sb = loop.step_batch(next(loop.train_dataset.batches(TB, seed=123)), 0)

    def step():
        loop.train_step(loop.state, sb, loop.generator)

    step_ms, peak, held = time_steps(step)
    model = loop.state.model
    gen = torch.Generator(device="cuda").manual_seed(7)
    clean, cond, cc = sb["motion_repr_clean"], sb["cond"], sb.get("control_cond")
    d = loop.traj_feat_dim
    t = torch.randint(0, 100, (TB,), generator=gen, device="cuda")
    x_t = torch.randn(clean[..., :d].shape, generator=gen, device="cuda")

    def forward():
        with torch.enable_grad():
            return model.forward_train(x_t, cond, t, control_cond=cc)

    out_graph = forward()  # its graph is kept for the timed backward passes
    out0 = out_graph.detach()
    g_out = torch.randn(out0.shape, generator=gen, device="cuda")

    def losses():
        o = out0.clone().requires_grad_()
        with torch.enable_grad():
            loop.eval_loss_fn(o, clean)["loss"].backward()

    ms = {
        "draws (t, noise)": median_ms(
            lambda: (torch.randint(0, 100, (TB,), generator=gen, device="cuda"),
                     torch.randn(clean[..., :d].shape, generator=gen, device="cuda"))),
        "U-Net forward": median_ms(forward),
        "U-Net backward": median_ms(lambda: out_graph.backward(g_out, retain_graph=True)),
        "trajnet_losses through SMPL-X, forward + backward": median_ms(losses),
        "optimizer (AdamW)": median_ms(loop.state.optimizer.step),
    }
    log(f"[trajtrain] {run}: {step_ms:.2f} ms per optimizer step (host clock, median of 10 after 3 warm-up; "
        f"batch {TB} x {clean.shape[1]} frames), peak memory of the steps {peak / 2**30:.2f} GiB, "
        f"{(peak - held) / 2**30:.2f} GiB above what was allocated before them")
    for name, v in ms.items():
        log(f"[trajtrain]   {name}: {v:.3f} ms (median of 20)")
    busy = device_busy(step, 5, f"TrajNet {run} optimizer steps", "trajtrain")
    return {"step_ms": step_ms, "pieces_ms": ms, "busy": busy, "steps_peak_bytes": peak, "held_bytes": held}


def trajnet_train_phase(seed: int, work: Path, body_path: Path) -> dict:
    """train_trajnet.main at full width (mid_dim 512, batch 64 x 145-frame
    clips, 100 cosine steps) on phase 6's trees: the vanilla stage-1 run,
    then the TrajControl fine-tune from its checkpoint. Checks finite
    losses, every vanilla tensor moved, the TrajControl backbone bit for
    bit its bootstrap and every branch tensor moved, the checkpoints and
    the eval, and no kernel launch; returns the launch counts (all 0), the
    two checkpoints and the timings."""
    from types import SimpleNamespace

    from rohm_tpu_torch.cli import train_trajnet
    from rohm_tpu_torch.cli.common import bootstrap_trajcontrol, build_trajnet, load_pretrained
    from rohm_tpu_torch.train.checkpoint import latest_checkpoint

    args = SimpleNamespace(mid_dim=512)
    out, ckpts = {}, {}
    for run, (yaml, tree, steps, log_interval) in TRAJ_TRAIN_RUNS.items():
        trajcontrol = run == "trajcontrol"
        extra = [f"--pretrained_backbone_path={ckpts['vanilla']}"] if trajcontrol else []
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loop = train_trajnet.main([
            f"--config=cfg_files/train_cfg/{yaml}", f"--dataset_root={work / TRAIN_TREES[tree][0]}",
            f"--body_model_path={body_path}", f"--save_dir={work / ('runs_' + run)}", f"--num_steps={steps}",
            f"--log_interval={log_interval}", "--save_interval=1000000000", f"--seed={seed}", "--device=0",
            *extra,
        ])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counts = read_launches()
        log(f"[trajtrain] {run}: main() {seconds:.2f} s, {loop.step} steps, peak memory {peak / 2**30:.2f} GiB; "
            f"launches {counts}")
        if loop.step != steps or any(counts.values()):
            raise AssertionError(f"the TrajNet {run} run took {loop.step} steps or launched a kernel: {counts}")
        losses = {k: float(v) for k, v in loop.last_losses.items()}
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"non-finite losses in the TrajNet {run} run: {losses}")
        init = build_trajnet(args, 13, trajcontrol, seed=seed).state_dict()
        if trajcontrol:  # the bootstrap: the vanilla checkpoint grafted onto the same init
            backbone = build_trajnet(args, 13, False, seed=seed)
            load_pretrained(backbone, ckpts["vanilla"])
            init = bootstrap_trajcontrol(init, backbone.state_dict())
        params = {n: p.detach().cpu() for n, p in loop.state.model.named_parameters()}
        frozen = [n for n in params if trajcontrol and not n.startswith("controlnet.")]
        moved = [n for n in params if not torch.equal(params[n], init[n])]
        if sorted(moved) != sorted(set(params) - set(frozen)):
            raise AssertionError(f"the TrajNet {run} run moved {len(moved)} of {len(params)} tensors; "
                                 f"{len(frozen)} are frozen and must keep their bootstrap value bit for bit")
        ckpts[run] = latest_checkpoint(loop.logdir)
        evals = "".join(p.read_text() for p in Path(loop.logdir).glob("run_*.log")).count("[eval]  loss:")
        log(f"[trajtrain] {run}: last loss {losses['loss']:.4f}, {len(moved)} tensors moved, {len(frozen)} frozen "
            f"bit for bit, checkpoint {Path(ckpts[run]).name}, in-training evals {evals}")
        if not ckpts[run].endswith(f"model{steps:09d}.npz") or evals != (0 if trajcontrol else 1):
            raise AssertionError(f"the TrajNet {run} run's checkpoint or eval is missing")
        out[run] = {"main_s": seconds, "peak_bytes": peak, "losses": losses, "checkpoint": ckpts[run],
                    **trajnet_train_timing(loop, run)}
        del loop
        torch.cuda.empty_cache()
    return {"launches": dict.fromkeys(KERNELS, 0), "runs": out, "checkpoints": ckpts}


# ---------------------------------------------------------------------------
# phase 7: the CLI
# ---------------------------------------------------------------------------

CLI_SEQS, CLI_SEQ_LEN = 11, 149  # per test dataset: 33 test clips of 145 frames
# the plain (False) CLI batch's result arrays against the f32 batch's, max
# |diff| by key prefix: joints in m, the repr; about 200x the gaps of the
# H100 runs (PERF.md §6), far below what a wrong plain path would give
PLAIN_ARRAY_ATOL = {"rec_ric_data": 1e-4, "motion_repr": 1e-3}


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


def cli_argv(work: Path, body_path: Path, mode: str, ckpts: dict, seed: int) -> list:
    """test_amass_full's flags for one batch of 32 clips at full width."""
    return [
        "--config=cfg_files/test_cfg/amass_occ_leg_noise_3.yaml", "--synthetic_data=True",
        f"--dataset_root={work / 'amass'}", f"--body_model_path={body_path}",
        "--batch_size=32", "--max_batches=1", "--load_noise=False", f"--fused_posenet={mode}",
        *[f"--model_path_{net}={path}" for net, path in ckpts.items()], f"--seed={seed}", "--device=0",
    ]


def cli_phase(seed: int, work: Path, body_path: Path, posenet_ckpt: str, traj_ckpts: dict) -> dict:
    """`test_amass_full.main` at full width on a synthetic AMASS test tree
    (3 datasets x 11 sequences of 149 frames: 33 clips) with a real-size
    synthetic SMPL-X file, one batch of 32 clips in each of "f32" and False
    (the CLI's default: the plain PoseNet, no kernel launched) on trained
    weights (PoseNet loaded from `posenet_ckpt`, the training phase's
    checkpoint, and its run directory's stats; TrajNet and TrajControl from
    `traj_ckpts`, phase 6b's), "int8qa" and "int8" (random weights), then
    `eval_amass_full.main` on each pickle; False's metrics within phase
    7f's budgets of f32's (fixture.mode_budget), its arrays within
    PLAIN_ARRAY_ATOL of f32's."""
    from rohm_tpu_torch.cli import eval_amass_full, test_amass_full
    from rohm_tpu_torch.cli.common import AMASS_TEST_DATASETS
    from rohm_tpu_torch.data import write_synthetic_amass

    t0 = time.perf_counter()
    write_synthetic_amass(str(work / "amass"), synthetic_model(num_verts=10475, seed=seed, device="cuda"),
                          datasets={n: CLI_SEQS for n in AMASS_TEST_DATASETS}, seq_len=CLI_SEQ_LEN, seed=seed)
    log(f"[cli] synthetic tree: {len(AMASS_TEST_DATASETS)} x {CLI_SEQS} sequences of {CLI_SEQ_LEN} "
        f"frames, {time.perf_counter() - t0:.2f} s")
    launches = dict.fromkeys(KERNELS, 0)
    out = {}
    trained = {"posenet": posenet_ckpt, "trajnet": traj_ckpts["vanilla"], "trajnet_control": traj_ckpts["trajcontrol"]}
    for mode, ckpts in (("f32", trained), (False, trained), ("int8qa", dict.fromkeys(trained, "")),
                        ("int8", dict.fromkeys(trained, ""))):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pkl, timing = test_amass_full.run(cli_argv(work, body_path, mode, ckpts, seed)
                                          + [f"--save_root={work / f'results_{mode}'}"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_launches()
        # False, the CLI's default: the plain PoseNet, none of our kernels
        expected = expected_launches({mode: 1}) if mode else dict.fromkeys(KERNELS, 0)
        log(f"[cli] fused_posenet={mode}: launches {counts}; expected {expected}")
        if counts != expected:
            raise AssertionError(f"the {mode} CLI run did not go through its kernels as the chain implies")
        for name in launches:
            launches[name] += counts[name]
        batch_s = timing["batch_dispatch"] + timing["device_wait_and_collect"]
        log(f"[cli] fused_posenet={mode}: one batch of 32 clips {batch_s:.2f} s "
            f"(batch_dispatch + device_wait_and_collect), main() {seconds:.2f} s in all; "
            + ", ".join(f"{net} {'from ' + Path(p).name if p else 'random'}" for net, p in ckpts.items()))

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
        out[mode] = {"batch_s": batch_s, "timing": timing, "metrics": metrics, "pickle": pkl, "counts": counts,
                     "seconds": seconds}
    fx = trained_fixture()
    rel = {k: abs(out[False]["metrics"][k] - v) / max(abs(v), 1e-9) for k, v in out["f32"]["metrics"].items()}
    arrays = result_gaps(load_result(out[False]["pickle"]), load_result(out["f32"]["pickle"]))
    log("[cli] fused_posenet=False against f32, metrics relative: " + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
        + "; pickle max |diff|: " + ", ".join(f"{k} {v:.3e}" for k, v in arrays.items()))
    gaps = fx.metric_gaps(out[False]["metrics"], out["f32"]["metrics"], fx.mode_budget)
    if gaps:
        raise AssertionError(f"the plain (False) CLI batch's metrics are off the f32 batch's budgets: {gaps}")
    off = {k: g for k, g in arrays.items()
           if g > next(v for prefix, v in PLAIN_ARRAY_ATOL.items() if k.startswith(prefix))}
    if off:
        raise AssertionError(f"the plain (False) CLI batch's arrays are off the f32 batch's "
                             f"({PLAIN_ARRAY_ATOL}): {off}")
    log(f"[cli] one batch of 32 clips x {CLIP_LEN - 1} frames, PoseNet {D}d x {LAYERS} (batch_dispatch + "
        f"device_wait_and_collect): " + ", ".join(f"{m} {r['batch_s']:.2f} s" for m, r in out.items())
        + f"; on {gpu_name_and_limit()}")
    return {"launches": launches, "runs": out}


# ---------------------------------------------------------------------------
# phase 7b: the video CLIs (PROX, EgoBody)
# ---------------------------------------------------------------------------

# dataset -> (YAML, frames, --fused_posenet, recording): PROX 2862 frames make
# 20 windows of 145 at stride 143, one full batch of the YAML's batch_size
# 20; EgoBody 717 make 5, padded to 8 by the bucket
VIDEO_RUNS = {
    "prox": ("prox_rgb.yaml", 2862, "bf16", "MPH11_00034_01"),
    "egobody": ("egobody_rgb.yaml", 717, "int8", "recording_20211004_S12_S20_01"),
}
VIDEO_STRIDE = CLIP_LEN - 2  # --window_size 2
VIDEO_POSE_FORWARDS = 1000 - 20  # early stop: 980 of the 1000 PoseNet steps


def video_windows(frames: int) -> int:
    return (frames - CLIP_LEN) // VIDEO_STRIDE + 1


def video_eval_argv(dataset: str, pkl: str, stitch_dir: Path) -> list:
    """eval_prox_egobody's flags for the pickle of one recording."""
    rec = VIDEO_RUNS[dataset][3]
    return [f"--dataset={dataset}", f"--saved_data_dir={Path(pkl).parent}", f"--recording_list={rec}",
            f"--stitch_save_dir={stitch_dir}"]


def guided_step_timing(work: Path, body_path: Path, stats_dir: str, seed: int) -> dict:
    """One guided step of the video chain alone: both 'prox' terms (2-D
    reprojection, skating), forward and backward through SMPL-X, on the
    PROX run's first batch of 20 windows (its dataset read back from the
    disk cache the CLI wrote); median CUDA-event ms and the device's busy
    share over 5 steps."""
    from rohm_tpu_torch.cli.common import resolve_body_model
    from rohm_tpu_torch.data import VideoClipDataset
    from rohm_tpu_torch.diffusion.sampler import _guidance_shift
    from rohm_tpu_torch.models.guidance import prox_guidance

    yaml, frames, _, rec = VIDEO_RUNS["prox"]
    root = work / "prox"
    body = resolve_body_model(str(body_path), "cuda")
    ds = VideoClipDataset(body_model=body, dataset="prox", init_root=str(root / "init"),
                          base_dir=str(root / "base"), recording_name=rec, use_scene_floor_height=True,
                          task="pose", overlap_len=2, clip_len=CLIP_LEN, logdir=stats_dir,
                          disk_cache_dir=str(root / "base" / "_repr_cache"), device="cuda")
    bp = next(ds.batches(20, pad_last="bucket"))
    t = {k: torch.as_tensor(v, device="cuda") for k, v in bp.items() if isinstance(v, np.ndarray)}
    mean, std = torch.as_tensor(ds.mean, device="cuda"), torch.as_tensor(ds.std, device="cuda")
    specs = prox_guidance(mean, std, body, t["transf_matrix"], torch.as_tensor(ds.cam_r, device="cuda").float(),
                          torch.as_tensor(ds.cam_t, device="cuda").float(), t["focal_length"],
                          t["camera_center"], t["keypoints_2d"])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pred_x0 = t["motion_repr_noisy"][:, : CLIP_LEN - 2] + 0.1 * torch.randn(
        (20, CLIP_LEN - 2, 294), generator=gen, device="cuda")
    var = torch.tensor(1e-4, device="cuda")

    def step():
        return _guidance_shift(specs, pred_x0, 50, var)

    shift = step()
    if not (shift is not None and torch.isfinite(shift).all() and shift.abs().max() > 0):
        raise AssertionError("the guided step's shift is empty or non-finite")
    ms = median_ms(step)
    log(f"[video] one guided step (2-D reprojection + skating, forward and backward through SMPL-X, "
        f"20 windows x {CLIP_LEN - 2} frames): {ms:.3f} ms (median of 20)")
    busy = device_busy(step, 5, "guided steps", "video")
    return {"guided_step_ms": ms, "busy": busy}


def video_phase(seed: int, work: Path, body_path: Path, posenet_ckpt: str, traj_ckpts: dict) -> dict:
    """`test_prox_egobody.main` at full width with the shipped video YAMLs on
    synthetic PROX and EgoBody trees written by the port's writers (the
    real-size synthetic SMPL-X file), PROX with fused_posenet "bf16" and
    EgoBody with "int8": 2 iterations, TrajControl, 100 + 1000 cosine steps
    with early stop, 2-D + skating guidance. PoseNet through the torch
    state_dict route (a `torch.save` of phase 6's trained PoseNet, beside
    its stats, named without an extension as the released weights are),
    held bit for bit to the `.npz` route on the card; TrajNet and
    TrajControl from phase 6b's `.npz`. Before each run, the run's fused
    PoseNet is held to the f32 module at the batch the CLI gives it (20
    and 8 windows of 143 frames). Then `eval_prox_egobody.main` on each
    pickle with --stitch_save_dir."""
    from types import SimpleNamespace

    from rohm_tpu_torch.cli import eval_prox_egobody, test_prox_egobody
    from rohm_tpu_torch.cli.common import build_posenet, load_pretrained
    from rohm_tpu_torch.data import write_synthetic_egobody, write_synthetic_prox
    from rohm_tpu_torch.data.clips import pad_tail_size
    from rohm_tpu_torch.reprs.stats import load_stats

    # the released-weights route: a torch state_dict next to the stats
    pt_path = str(Path(posenet_ckpt).with_suffix(""))
    routes = {}
    for route, path in (("npz", posenet_ckpt), ("pt", pt_path)):
        if route == "pt":
            torch.save(routes["npz"].state_dict(), pt_path)
        model = build_posenet(SimpleNamespace(latent_dim=D), seed=seed + 1).to("cuda")
        load_pretrained(model, path)
        routes[route] = model
    same = [torch.equal(a, b) for a, b in zip(routes["npz"].state_dict().values(),
                                               routes["pt"].state_dict().values())]
    log(f"[video] PoseNet through the .pt route ({Path(pt_path).name}) and the .npz route: "
        f"{same.count(True)} of {len(same)} tensors bit-identical on the card")
    if not all(same):
        raise AssertionError("the .pt and .npz routes load different PoseNet parameters")
    posenet = routes["pt"].eval()
    del routes

    body = synthetic_model(num_verts=10475, seed=seed, device="cuda")
    mean, std = (torch.as_tensor(a, device="cuda") for a in load_stats(str(Path(posenet_ckpt).parent)))
    ckpts = {"posenet": pt_path, "trajnet": traj_ckpts["vanilla"], "trajnet_control": traj_ckpts["trajcontrol"]}
    launches = dict.fromkeys(KERNELS, 0)
    out = {}
    for dataset, (yaml, frames, mode, rec) in VIDEO_RUNS.items():
        root = work / dataset
        writer = write_synthetic_prox if dataset == "prox" else write_synthetic_egobody
        t0 = time.perf_counter()
        writer(str(root / "init"), str(root / "base"), body, recording_name=rec, n_frames=frames, seed=seed)
        n = video_windows(frames)
        log(f"[video] synthetic {dataset} tree: {frames} frames, {n} windows, {time.perf_counter() - t0:.2f} s")
        # the run's kernels at the rows it gives them ({20, 8} x 143), which
        # no earlier phase checks; only PoseNet and the stats are used here
        pipe = RohmPipeline(trajnet=None, trajcontrol=None, posenet=posenet,
                            sched_traj=None, sched_pose=None, body_model=body, mean=mean, std=std,
                            fused_posenet=mode)
        gen = torch.Generator(device="cuda").manual_seed(seed + 7)
        x_t, cond = (torch.randn(pad_tail_size(n, 20, "bucket"), CLIP_LEN - 2, 294, device="cuda",
                                 generator=gen) for _ in range(2))
        with torch.no_grad():
            posenet_envelope("video", pipe, cond, x_t, posenet(x_t, cond, 500))
        del pipe
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        argv = [
            f"--config=cfg_files/test_cfg/{yaml}", f"--dataset_root={root / 'base'}",
            f"--init_root={root / 'init'}", f"--recording_name={rec}", f"--body_model_path={body_path}",
            f"--fused_posenet={mode}", *[f"--model_path_{net}={path}" for net, path in ckpts.items()],
            f"--seed={seed}", "--device=0",
        ]
        pkl, timing = test_prox_egobody.run(argv + [f"--save_root={work / ('video_results_' + dataset)}"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_launches()
        expected = forward_launches(mode, 2 * VIDEO_POSE_FORWARDS)  # one batch
        log(f"[video] {dataset} fused_posenet={mode}: launches {counts}; expected {expected}")
        if counts != expected:
            raise AssertionError(f"the {dataset} CLI run did not go through its kernels as the chain implies")
        for name in launches:
            launches[name] += counts[name]
        batch_s = timing["batch_dispatch"] + timing["device_wait_and_collect"]
        log(f"[video] {dataset} fused_posenet={mode}: one batch of {n} windows (padded to "
            f"{pad_tail_size(n, 20, 'bucket')}) {batch_s:.2f} s (batch_dispatch + device_wait_and_collect), "
            f"dataset_build {timing['dataset_build']:.2f} s, main() {seconds:.2f} s in all")

        with open(pkl, "rb") as f:
            saved = pickle.load(f)
        t_out = CLIP_LEN - 2
        want = {"trans_scene2cano_list": (n, 4, 4), "joints_input_scene_coord_list": (n, CLIP_LEN, 22, 3),
                "mask_joint_vis_list": (n, t_out, 22), "motion_repr_rec_list": (n, t_out, 294),
                "motion_repr_noisy_list": (n, t_out, 294)}
        want.update({k: (n, t_out, 22, 3) for k in (
            "rec_ric_data_noisy_list", "rec_ric_data_rec_list_from_abs_traj", "rec_ric_data_rec_list_from_smpl")})
        meta = {"repr_name_list", "repr_dim_dict", "recording_name", "frame_name_list", "scene_name",
                "color_cam", "window_stride"}
        if dataset == "egobody":
            want["joints_gt_scene_coord_list"] = (n, CLIP_LEN, 22, 3)
            meta.add("gender_gt")
        shapes = {k: tuple(v.shape) for k, v in saved.items() if isinstance(v, np.ndarray)}
        if shapes != want or set(saved) != set(want) | meta or len(saved["frame_name_list"]) != n:
            raise AssertionError(f"bad {dataset} pickle: keys {sorted(saved)}, shapes {shapes}")
        if not all(np.isfinite(saved[k]).all() for k in want):
            raise AssertionError(f"non-finite values in the {dataset} pickle")
        t0 = time.perf_counter()
        metrics = eval_prox_egobody.main(video_eval_argv(dataset, pkl, work / f"video_stitched_{dataset}"))
        eval_s = time.perf_counter() - t0
        stitched = np.load(work / f"video_stitched_{dataset}" / f"{rec}.npz")
        if not (all(np.isfinite(v) for v in metrics.values())
                and stitched["joints_rec"].shape == (VIDEO_STRIDE * (n - 1) + t_out, 22, 3)
                and np.isfinite(stitched["joints_rec"]).all()):
            raise AssertionError(f"non-finite {dataset} metrics or a bad stitched sequence: {metrics}")
        log(f"[video] {dataset} metrics {metrics}")
        out[dataset] = {"batch_s": batch_s, "timing": timing, "metrics": metrics, "windows": n, "argv": argv,
                        "pickle": pkl, "seconds": seconds, "counts": counts, "eval_s": eval_s}
    out["guided"] = guided_step_timing(work, body_path, str(Path(posenet_ckpt).parent), seed)
    return {"launches": launches, "runs": out}


# ---------------------------------------------------------------------------
# phase 7c: the single-net CLIs and the host tools
# ---------------------------------------------------------------------------

RAW_FRAMES = 960  # per raw AMASS sequence: 8 s at 120 fps, 16 s at 60
SINGLE_POSE_FORWARDS = 1000 - 20  # test_posenet --early_stop: 980 of the 1000 steps
VERTS_FRAMES = (B, S)  # forward_vertices timed on a batch of 32 x 144 frames
VERTS_CPU_FRAMES = 64  # of which the CPU recomputes the first 64


def timed_sampler(make, seconds: list):
    """`make` (make_posenet_sampler or make_trajnet_sampler) whose samplers
    append the host-clock seconds of each synchronised call to `seconds`:
    a CLI batch's reverse chain."""
    def make_timed(*args, **kwargs):
        sample = make(*args, **kwargs)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sample(*a, **kw)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            return out

        return timed

    return make_timed


def run_timed_cli(cli, sampler_name: str, argv: list) -> tuple:
    """cli.main(argv) with its sampler timed (timed_sampler); returns (the
    result, main()'s seconds, the seconds of each batch's chain)."""
    make = getattr(cli, sampler_name)
    chains = []
    setattr(cli, sampler_name, timed_sampler(make, chains))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = cli.main(argv)
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0, chains
    finally:
        setattr(cli, sampler_name, make)


def preprocessing_check(seed: int, work: Path, body_path: Path) -> dict:
    """preprocessing_amass.main on the card over a raw AMASS tree (both npz
    layouts, 60 and 120 fps, an SSM sequence, files each rule drops), its
    25 joints held against the same FK on the CPU."""
    from rohm_tpu_torch.body.model import load_smplx_npz
    from rohm_tpu_torch.cli import preprocessing_amass
    from rohm_tpu_torch.data import write_synthetic_amass_raw
    from rohm_tpu_torch.data.synthetic import RAW_AMASS_SEQUENCES

    kept = write_synthetic_amass_raw(str(work / "amass_raw"), n_frames=RAW_FRAMES, seed=seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = preprocessing_amass.main([f"--amass_root={work / 'amass_raw'}", f"--save_root={work / 'amass_pre'}",
                                  f"--body_model_path={body_path}", "--device=0"])
    seconds = time.perf_counter() - t0
    cpu_body = load_smplx_npz(str(body_path), "cpu")
    worst, frames = 0.0, 0
    for path in sorted((work / "amass_pre" / "pose_data_fps_30").rglob("*.npy")):
        joints = np.load(path)
        params = torch.from_numpy(np.load(str(path).replace("pose_data_fps_30", "smpl_data_fps_30"))).float()
        ref = forward_joints(cpu_body, params[:, 6:16], params[:, 0:3], params[:, 16:79], params[:, 3:6],
                             num_joints=25).numpy()
        if joints.shape != ref.shape or joints.shape[1:] != (25, 3):
            raise AssertionError(f"bad joints {joints.shape} in {path}")
        worst, frames = max(worst, float(np.abs(joints - ref).max())), frames + len(joints)
    total = sum(len(seqs) for seqs in RAW_AMASS_SEQUENCES.values())
    log(f"[single] preprocessing_amass: {n} of {total} raw sequences kept (expected {kept}), {frames} frames at "
        f"30 fps, main() {seconds:.2f} s; 25 joints vs the CPU FK: max |err| {worst:.3e} m "
        f"(tolerance 1e-4: f32 FK on two devices, summation order only)")
    if n != kept or not worst < 1e-4:
        raise AssertionError("preprocessing_amass kept the wrong sequences or its FK strays from the CPU's")
    return {"main_s": seconds, "max_abs_err": worst}


def vertices_check(seed: int, body_path: Path) -> dict:
    """forward_vertices on the card at 10475 vertices against the CPU (the
    first VERTS_CPU_FRAMES frames), then its median CUDA-event ms on a batch
    of 32 x 144 frames and on one frame (get_occlusion_mask's call)."""
    from rohm_tpu_torch.body import forward_vertices
    from rohm_tpu_torch.body.model import load_smplx_npz

    rng = np.random.default_rng(seed)
    params = synthetic_params(rng, *VERTS_FRAMES)
    args = [params[k] for k in ("betas", "global_orient", "body_pose", "transl")]
    body = load_smplx_npz(str(body_path), "cuda")
    dev_args = [torch.from_numpy(a).cuda() for a in args]
    with torch.no_grad():
        verts, joints = forward_vertices(body, *dev_args)
        cpu_verts, cpu_joints = forward_vertices(
            load_smplx_npz(str(body_path), "cpu"),
            *(torch.from_numpy(a[0, :VERTS_CPU_FRAMES].copy()) for a in args))
        err = max((verts[0, :VERTS_CPU_FRAMES].cpu() - cpu_verts).abs().max().item(),
                  (joints[0, :VERTS_CPU_FRAMES].cpu() - cpu_joints).abs().max().item())
        ms = median_ms(lambda: forward_vertices(body, *dev_args))
        one = [a[:1, :1] for a in dev_args]
        ms_one = median_ms(lambda: forward_vertices(body, *one))
    log(f"[single] forward_vertices at {body.num_verts} vertices, {VERTS_CPU_FRAMES} frames against the CPU: "
        f"max |err| {err:.3e} m (tolerance 1e-4: f32 on two devices); {list(verts.shape)}: {ms:.3f} ms, "
        f"one frame {ms_one:.3f} ms (median of 20)")
    if not (torch.isfinite(verts).all() and err < 1e-4):
        raise AssertionError("forward_vertices on the card strays from the CPU's")
    return {"ms": ms, "ms_one_frame": ms_one, "max_abs_err": err}


def single_net_phase(seed: int, work: Path, body_path: Path, posenet_ckpt: str, traj_ckpts: dict) -> dict:
    """The single-net test CLIs and the host tools at full width:
    `preprocessing_amass.main` (preprocessing_check), `test_trajnet.main`
    on phase 6b's vanilla checkpoint and with --trajcontrol on its
    TrajControl one (100 steps, one batch of phase 7's 33 clips; no kernel
    of ours), and `test_posenet.main --fused_posenet=True
    --cond_fn_with_grad=True --early_stop=True --save_results=True` on phase
    6's PoseNet (its run directory's stats; one batch of 32 clips x 144
    frames, 980 steps through K1's chain, the last 31 guided), after its
    fused step is held to the f32 module at those rows within phase 5's f32
    envelope; then forward_vertices (vertices_check)."""
    from types import SimpleNamespace

    from rohm_tpu_torch.cli import test_posenet, test_trajnet
    from rohm_tpu_torch.cli.common import build_posenet, load_pretrained
    from rohm_tpu_torch.reprs.stats import load_stats

    out = {"preprocessing": preprocessing_check(seed, work, body_path)}
    launches = dict.fromkeys(KERNELS, 0)
    common = [f"--dataset_root={work / 'amass'}", f"--body_model_path={body_path}", f"--seed={seed}", "--device=0"]
    for run, flags in (("vanilla", []), ("trajcontrol", ["--trajcontrol=True"])):
        reset_launches()
        res, seconds, chains = run_timed_cli(
            test_trajnet, "make_trajnet_sampler", [*common, f"--model_path={traj_ckpts[run]}", *flags])
        counts = read_launches()
        log(f"[single] test_trajnet {run}: one batch of {3 * CLI_SEQS} clips, chain {chains[0]:.2f} s, "
            f"main() {seconds:.2f} s; "
            f"{', '.join(f'{k} {v:.4g}' for k, v in res.items())}")
        if len(chains) != 1 or any(counts.values()) or len(res) != 15 or not all(np.isfinite(list(res.values()))):
            raise AssertionError(f"test_trajnet {run}: bad results {res} or a kernel launched: {counts}")
        out[f"trajnet_{run}"] = {"chain_s": chains[0], "main_s": seconds, "results": res,
                                 "argv": [*common, f"--model_path={traj_ckpts[run]}", *flags]}

    # the run's K1 chain at the rows it gives it (32 x 145 tokens)
    posenet = build_posenet(SimpleNamespace(latent_dim=D), seed=seed + 1).cuda()
    load_pretrained(posenet, posenet_ckpt)
    posenet.eval()
    mean, std = (torch.as_tensor(a, device="cuda") for a in load_stats(str(Path(posenet_ckpt).parent)))
    pipe = RohmPipeline(trajnet=None, trajcontrol=None, posenet=posenet, sched_traj=None, sched_pose=None,
                        body_model=None, mean=mean, std=std, fused_posenet="f32")
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    x_t, cond = (torch.randn(B, S, 294, device="cuda", generator=gen) for _ in range(2))
    with torch.no_grad():
        posenet_envelope("single", pipe, cond, x_t, posenet(x_t, cond, 500))
    del pipe, posenet

    reset_launches()
    save_root = work / "results_single"
    argv = [*common, f"--model_path={posenet_ckpt}", "--fused_posenet=True", "--cond_fn_with_grad=True",
            "--early_stop=True", "--save_results=True", "--max_batches=1"]
    mpjpe, seconds, chains = run_timed_cli(test_posenet, "make_posenet_sampler", argv + [f"--save_root={save_root}"])
    counts = read_launches()
    expected = forward_launches("f32", SINGLE_POSE_FORWARDS)
    log(f"[single] test_posenet fused f32, guided, early stop: launches {counts}; expected {expected}")
    if counts != expected:
        raise AssertionError("test_posenet did not go through K1's kernels as the chain implies")
    for name in launches:
        launches[name] += counts[name]
    pkl = save_root / f"test_posenet_mask_lower_grad_True_seed_{seed}.pkl"
    with open(pkl, "rb") as f:
        saved = pickle.load(f)
    want = {k: (B, S, 22, 3) for k in ("rec_ric_data_clean_list", "rec_ric_data_rec_list_from_smpl",
                                       "rec_ric_data_noisy_list")}
    want.update({k: (B, S, 294) for k in ("motion_repr_clean_list", "motion_repr_rec_list")})
    shapes = {k: tuple(v.shape) for k, v in saved.items() if isinstance(v, np.ndarray)}
    if shapes != want or set(saved) != set(want) | {"mask_scheme", "repr_name_list", "repr_dim_dict"}:
        raise AssertionError(f"bad test_posenet pickle: keys {sorted(saved)}, shapes {shapes}")
    if not (all(np.isfinite(saved[k]).all() for k in want) and np.isfinite(mpjpe)):
        raise AssertionError("non-finite test_posenet results")
    log(f"[single] test_posenet: one batch of {B} clips x {S} frames, chain {chains[0]:.2f} s "
        f"({SINGLE_POSE_FORWARDS} fused f32 steps, 31 guided), main() {seconds:.2f} s, "
        f"mpjpe_global {mpjpe * 1000:.1f} mm, pickle {pkl.name}")
    out["posenet"] = {"chain_s": chains[0], "main_s": seconds, "mpjpe_m": mpjpe, "argv": argv, "pickle": str(pkl),
                      "counts": counts}
    out["vertices"] = vertices_check(seed, body_path)
    return {"launches": launches, "runs": out}


# ---------------------------------------------------------------------------
# phase 7d: data parallelism and the bf16 compute dtype
# ---------------------------------------------------------------------------

DP_RANKS = 2  # the two-rank runs share cuda:0 (gloo: NCCL refuses two ranks on one card)
DP_LR = 1e-4  # posenet_train_stage1.yaml
DP_DEADLINE_S = 600  # each two-rank run of this script ends within this, or fails
STAGE1_WEIGHTS = {  # posenet_train_stage1.yaml's loss weights
    "weight_loss_rec_repr_full_body": 1.0, "weight_loss_repr_foot_contact_mse": 1.0,
    "weight_loss_joint_pos_global": 100.0, "weight_loss_joint_vel_global": 1000.0,
    "weight_loss_joint_smooth": 0.0, "weight_loss_foot_skating": 0.1,
}
# the bf16 training mode's gradient gate of the CPU parity tests
# (tests/test_torch_train_grads.py), as a fraction of each tensor's largest entry
DP_GRAD_GATE = 1e-2
# after one AdamW step, the parameters whose single-process gradient is above
# DP_SURE of its tensor's largest entry (10x the gradient gate, so the sign
# cannot flip) agree to DP_PARAM_GATE lr: AdamW's first step moves an entry by
# lr * g / (|g| + eps), about lr times the sign of g whatever its size
DP_SURE = 10 * DP_GRAD_GATE
DP_PARAM_GATE = 1e-3
BF16_STEPS = 4  # --num_steps of each --model_dtype=bfloat16 run


def dp_inputs(seed: int, batches: int) -> tuple:
    """Full-width models from `seed` (TrajNet, TrajControl mid_dim 512,
    PoseNet 512d x 8), the synthetic body, and `batches` batches of 32
    clips (clean and noisy reprs, normalized) with their stats; every rank
    builds the same."""
    dev = "cuda"
    torch.manual_seed(seed)
    models = (TrajNet(traj_feat_dim=13, cond_dim=13, mid_dim=512).to(dev),
              TrajNet(traj_feat_dim=13, cond_dim=13, mid_dim=512, trajcontrol=True).to(dev),
              PoseNet(latent_dim=D, ff_size=F, num_layers=LAYERS, num_heads=H).to(dev))
    body = synthetic_model(num_verts=10475, seed=seed, device=dev)
    rng = np.random.default_rng(seed)
    pairs = [make_batch(body, rng) for _ in range(batches)]
    mean, std = compute_stats(torch.cat([c for c, _ in pairs]).cpu().numpy())
    mean_t, std_t = torch.from_numpy(mean).to(dev), torch.from_numpy(std).to(dev)
    clean = torch.cat([(c - mean_t) / std_t for c, _ in pairs])
    noisy = torch.cat([(n - mean_t) / std_t for _, n in pairs])
    return models, body, mean_t, std_t, clean, noisy


def dp_pipeline_batch(mesh, seed: int) -> dict:
    """One guided batch of phase 5's slice (32 clips, 100 + 1000 steps, 2
    iterations) through RohmPipeline(mesh=) in int8qa, from a generator
    seeded the same on every rank; None: one process."""
    (trajnet, trajcontrol, posenet), body, mean, std, clean, noisy = dp_inputs(seed, 1)
    pipe = RohmPipeline(
        trajnet=trajnet, trajcontrol=trajcontrol, posenet=posenet,
        sched_traj=make_schedule("cosine", 100, device="cuda"), sched_pose=make_schedule("cosine", 1000, device="cuda"),
        body_model=body, mean=mean, std=std, repr_abs_only=True, traj_feat_dim=13, sample_iter=2,
        grad_type="amass", mask_scheme="lower", input_noise=True, iter2_cond_noisy_pose=True,
        iter2_cond_noisy_traj=True, fused_posenet="int8qa", mesh=mesh)
    abs_index = torch.as_tensor(TRAJ_ABS_INDEX, device="cuda").long()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pose, traj = pipe.run_batch(noisy[..., abs_index], clean, noisy, amass_eval_pose_mask("lower", B, S - 1),
                                np.ones((B, S), np.float32), torch.Generator(device="cuda").manual_seed(seed + 300))
    torch.cuda.synchronize()
    return {"pose": pose.cpu().numpy(), "traj": traj.cpu().numpy(), "seconds": time.perf_counter() - t0,
            "launches": read_launches()}


def dp_train_step(mesh, seed: int, ref_path: str | None = None) -> dict:
    """One PoseNet optimizer step with --fused_train=bfloat16 on 64 clips of
    144 frames (the stage-1 loss weights, skating on), t, noise and the
    dropout masks from a generator seeded the same on every rank; this
    rank's rows under a mesh. With `ref_path` (the single-process step's
    gradients and parameters, saved by torch.save) returns the largest
    differences from it; else saves them there."""
    from rohm_tpu_torch.parallel import shard_batch
    from rohm_tpu_torch.train.state import create_train_state
    from rohm_tpu_torch.train.steps import make_posenet_train_step

    (_, _, posenet), body, mean, std, clean, noisy = dp_inputs(seed, TB // B)
    step = make_posenet_train_step(posenet, make_schedule("cosine", 1000, device="cuda"), mean, std, body,
                                   STAGE1_WEIGHTS, "bfloat16", mesh)
    state = create_train_state(posenet, DP_LR, 0.0)
    batch = shard_batch({"motion_repr_clean": clean, "cond": noisy}, mesh)
    reset_launches()
    _, losses = step(state, batch, torch.Generator(device="cuda").manual_seed(seed + 400), torch.tensor(1.0, device="cuda"))
    torch.cuda.synchronize()
    out = {"launches": read_launches(), "loss": float(losses["loss"])}
    got = {n: (p.grad.detach(), p.detach()) for n, p in posenet.named_parameters()}
    if ref_path is None:
        return {**out, "state": {n: (g.cpu(), p.cpu()) for n, (g, p) in got.items()}}
    ref = torch.load(ref_path)
    grad_err = max(((g.cpu() - ref[n][0]).abs().max() / ref[n][0].abs().max()).item() for n, (g, _) in got.items())
    param_err, covered, total = 0.0, 0, 0
    for n, (_, p) in got.items():
        g_ref, p_ref = ref[n]
        sure = g_ref.abs() > DP_SURE * g_ref.abs().max()
        off = (p.cpu() - p_ref).abs() - 2**-22 * p_ref.abs()  # float32 rounding of the parameter allowed
        param_err = max(param_err, off[sure].max().item() / DP_LR if sure.any() else 0.0)
        covered, total = covered + int(sure.sum()), total + p_ref.numel()
    return {**out, "grad_err": grad_err, "param_err": param_err, "param_covered": covered / total}


def bf16_train_timing(seed: int, work: Path, body_path: Path) -> dict:
    """train_posenet and train_trajnet with --model_dtype=bfloat16 on the
    plain path (no kernel), BF16_STEPS steps at full width on phase 6's
    small tree, then the ms per optimizer step on a batch of 64 as phase 6
    and 6b time it (time_steps) and the device's busy share over 5."""
    from rohm_tpu_torch.cli import train_posenet, train_trajnet

    out = {}
    for net, cli, yaml in (("posenet", train_posenet, "posenet_train_stage1.yaml"),
                           ("trajnet", train_trajnet, "trajnet_train_vanilla_stage1.yaml")):
        reset_launches()
        loop = cli.main([
            f"--config=cfg_files/train_cfg/{yaml}", f"--dataset_root={work / TRAIN_TREES['small'][0]}",
            f"--body_model_path={body_path}", f"--save_dir={work / ('runs_bf16_' + net)}",
            f"--num_steps={BF16_STEPS}", "--log_interval=1000000000", "--save_interval=1000000000",
            f"--seed={seed}", "--device=0", "--model_dtype=bfloat16",
        ])
        counts = read_launches()
        losses = {k: float(v) for k, v in loop.last_losses.items()}
        if loop.model.dtype != torch.bfloat16 or loop.step != BF16_STEPS or any(counts.values()):
            raise AssertionError(f"the bf16 {net} run: dtype {loop.model.dtype}, {loop.step} steps, launches {counts}")
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"non-finite losses in the bf16 {net} run: {losses}")
        batch = next(loop.train_dataset.batches(TB, seed=123))
        if net == "posenet":
            sb = {"motion_repr_clean": loop._to_device(batch["motion_repr_clean"]),
                  "cond": loop._to_device(loop._make_cond(batch, 0))}
            skating = torch.tensor(1.0, device="cuda")

            def step():
                loop.train_step(loop.state, sb, loop.generator, skating)
        else:
            sb = loop.step_batch(batch, 0)

            def step():
                loop.train_step(loop.state, sb, loop.generator)

        step_ms, peak, _ = time_steps(step)
        busy = device_busy(step, 5, f"train_{net} --model_dtype=bfloat16 optimizer steps", "dp")
        out[net] = {"step_ms": step_ms, "busy": busy, "peak_bytes": peak, "loss": losses["loss"]}
        del loop
        torch.cuda.empty_cache()
    return out


def data_parallel_phase(seed: int, work: Path, body_path: Path, cli: dict, train: dict, trajtrain: dict) -> dict:
    """--data_parallel and --model_dtype=bfloat16 at full width:
    test_amass_full --data_parallel=True through the CLI's own start-up (a
    mesh of one rank on NCCL) against phase 7's int8 run; two gloo ranks on
    cuda:0 for one guided RohmPipeline(mesh=) batch in int8qa and one
    --fused_train=bfloat16 optimizer step, each against the single-process
    run; the bf16 train CLIs' ms per step beside phase 6's and 6b's f32
    ones. Returns the launches of the runs on the main path (every rank)."""
    import torch.distributed as dist

    from rohm_tpu_torch.cli import test_amass_full
    from rohm_tpu_torch.parallel import spawn

    launches = dict.fromkeys(KERNELS, 0)
    out = {}

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    # the CLI's own start-up: one card, so a mesh of one rank (NCCL)
    ckpts = dict.fromkeys(("posenet", "trajnet", "trajnet_control"), "")
    reset_launches()
    pkl, _ = test_amass_full.run(cli_argv(work, body_path, "int8", ckpts, seed)
                                 + [f"--save_root={work / 'results_dp'}", "--data_parallel=True"])
    counts = read_launches()
    add(counts)
    ref_pkl, ref_counts = cli["runs"]["int8"]["pickle"], cli["runs"]["int8"]["counts"]
    same = same_result(pkl, ref_pkl)
    log(f"[dp] test_amass_full --data_parallel=True --fused_posenet=int8 (a mesh of 1 rank, NCCL): pickle "
        f"{'bit-identical to' if same else 'DIFFERENT from'} phase 7's single-process int8 run; launches {counts}")
    if not same or counts != ref_counts or Path(pkl).name != Path(ref_pkl).name or dist.is_initialized():
        raise AssertionError("the one-rank data-parallel CLI run is not the single-process run")

    # two ranks on cuda:0: one guided pipeline batch in int8qa
    single = dp_pipeline_batch(None, seed)
    devices = [torch.device("cuda", 0)] * DP_RANKS
    t0 = time.perf_counter()
    ranks = spawn(dp_pipeline_batch, DP_RANKS, (seed,), devices=devices, backend="gloo", deadline_s=DP_DEADLINE_S)
    atol, mean_tol = POSENET_ENVELOPES["int8qa"]
    for r, res in enumerate(ranks):
        add(res["launches"])
        err = np.abs(res["pose"] - single["pose"])
        terr = np.abs(res["traj"] - single["traj"])
        log(f"[dp] RohmPipeline(mesh=) int8qa, rank {r} of {DP_RANKS} on cuda:0 (16 of 32 clips, guided, "
            f"2 x (100 + 1000) steps): pose vs the single-process batch max {err.max():.3e} mean {err.mean():.3e}, "
            f"traj max {terr.max():.3e} mean {terr.mean():.3e} (gate: phase 5's int8qa envelope, max {atol}, "
            f"mean {mean_tol}); {res['seconds']:.2f} s; launches {res['launches']}")
        if not (err.max() < atol and err.mean() < mean_tol and terr.max() < atol and terr.mean() < mean_tol):
            raise AssertionError("the two-rank pipeline batch strays from the single-process batch")
        if res["launches"] != expected_launches({"int8qa": 1}):
            raise AssertionError("a rank's pipeline batch did not go through its kernels as the chain implies")
    if not np.array_equal(ranks[0]["pose"], ranks[1]["pose"]):
        raise AssertionError("the ranks returned different global batches")
    out["pipeline"] = {"single_s": single["seconds"], "ranks_s": [r["seconds"] for r in ranks],
                       "spawn_s": time.perf_counter() - t0}

    # two ranks on cuda:0: one --fused_train=bfloat16 optimizer step
    ref = dp_train_step(None, seed)
    ref_path = work / "dp_train_ref.pt"
    torch.save(ref.pop("state"), ref_path)
    ranks = spawn(dp_train_step, DP_RANKS, (seed, str(ref_path)), devices=devices, backend="gloo",
                  deadline_s=DP_DEADLINE_S)
    for r, res in enumerate(ranks):
        add(res["launches"])
        log(f"[dp] --fused_train=bfloat16 optimizer step, rank {r} of {DP_RANKS} (32 of 64 clips): loss "
            f"{res['loss']:.6f} (single process {ref['loss']:.6f}); gradients within {res['grad_err']:.3e} of each "
            f"tensor's largest entry (gate {DP_GRAD_GATE}), parameters after AdamW within {res['param_err']:.3e} lr "
            f"(gate {DP_PARAM_GATE} lr) on the {res['param_covered']:.3f} of entries whose gradient is above "
            f"{DP_SURE} of its tensor's largest; launches {res['launches']}")
        if not (res["grad_err"] <= DP_GRAD_GATE and res["param_err"] <= DP_PARAM_GATE and res["param_covered"] > 0
                and abs(res["loss"] - ref["loss"]) <= 1e-3 * abs(ref["loss"])):
            raise AssertionError("the two-rank training step strays from the single-process step")
        if res["launches"] != expected_train_launches("bfloat16", 1):
            raise AssertionError("a rank's training step did not go through its kernels as the chain implies")
    out["train_step"] = {r: {k: res[k] for k in ("loss", "grad_err", "param_err", "param_covered")}
                         for r, res in enumerate(ranks)}

    # --model_dtype=bfloat16, the plain path
    out["bf16"] = bf16_train_timing(seed, work, body_path)
    f32 = {"posenet": train["runs"][""]["step_ms"], "trajnet": trajtrain["runs"]["vanilla"]["step_ms"]}
    for net, res in out["bf16"].items():
        log(f"[dp] train_{net} --model_dtype=bfloat16 (plain path): {res['step_ms']:.2f} ms per optimizer step "
            f"(batch {TB} x 144, host clock, median of 10), peak memory {res['peak_bytes'] / 2**30:.2f} GiB, "
            f"device busy {res['busy']:.3f}; float32 in this run (phase {'6' if net == 'posenet' else '6b'}): "
            f"{f32[net]:.2f} ms ({gpu_name_and_limit()})")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# phase 7e: the resident server
# ---------------------------------------------------------------------------

SERVE_LINE = re.compile(r"\[serve\] (\w+) finished in ([\d.]+)s ok=(\w+) launches=(\{.*\}) peak_bytes=(\w+)")
SERVE_START_S = 600  # the daemon's start-up (torch, the CUDA context, the kernel library) ends within this


def _served(run: str, cmd: str, argv: list, sock: str) -> tuple:
    """One request to the daemon: (its result, what it printed, client wall s)."""
    import contextlib
    import io

    from rohm_tpu_torch.serve import client as sclient

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = sclient.run_cli(cmd, argv, socket_path=sock, auto_start=False)
    seconds = time.perf_counter() - t0
    log(f"[serve] {run}: {cmd} served in {seconds:.2f} s (client wall clock)")
    return result, buf.getvalue(), seconds


def load_result(result) -> dict:
    """A result dict: a pickle's path loaded, a dict itself."""
    if isinstance(result, dict):
        return result
    with open(result, "rb") as f:
        return pickle.load(f)


def result_gaps(got: dict, ref: dict) -> dict:
    """Two results of one argv (pickles or returned metrics), entry by entry:
    the max |got - ref| of each float entry (0.0 when bit-identical, nan
    against nan included; inf where a nan stands against a number). Every
    other entry, and the key set, must be equal: it raises otherwise."""
    if sorted(got) != sorted(ref):
        raise AssertionError(f"results with different keys: {sorted(got)} != {sorted(ref)}")
    gaps = {}
    for k, r in ref.items():
        g = got[k]
        if isinstance(r, float) or (isinstance(r, np.ndarray) and r.dtype.kind == "f"):
            g, r = np.asarray(g, np.float64), np.asarray(r, np.float64)
            if g.shape != r.shape:
                raise AssertionError(f"{k}: shape {g.shape} != {r.shape}")
            diff = np.where(np.isnan(g) & np.isnan(r), 0.0, np.abs(g - r))
            gaps[k] = float(np.nan_to_num(diff, nan=np.inf).max(initial=0.0))
        elif not (np.array_equal(g, r) if isinstance(r, np.ndarray) else g == r):
            raise AssertionError(f"{k}: {g!r} != {r!r}")
    return gaps


def same_result(got, ref) -> bool:
    """Two results (pickle paths or dicts) bit for bit (result_gaps)."""
    return not any(result_gaps(load_result(got), load_result(ref)).values())


def hold_served(what: str, got: dict, ref: dict) -> None:
    """A served result bit for bit against the in-process one of the same argv."""
    gaps = {k: g for k, g in result_gaps(got, ref).items() if g}
    if gaps:
        raise AssertionError(f"the served {what} differs from its in-process run, max |diff| per entry: {gaps}")


def served_launches(counts: dict) -> dict:
    """An in-process run's launch counts as the daemon's log names them."""
    return {f"{fn.__name__}.{counter}": n for name, (fn, counter, _, _) in KERNELS.items() if (n := counts[name])}


def serve_other_clis(work: Path, sock: str, video: dict, single: dict) -> list:
    """The four other served CLIs, while the daemon is up, each held to its
    in-process run of the same argv bit for bit (hold_served): phase 7b's PROX
    `test_prox_egobody` (bf16) and `eval_prox_egobody` on the served
    pickle, phase 7c's `test_posenet` (K1's chain, guided, early stop) and
    vanilla `test_trajnet`. Returns (run, command, the launches the
    daemon's log must show for it) in request order."""
    smi = gpu_name_and_limit()
    prox, posenet, trajnet = video["prox"], single["runs"]["posenet"], single["runs"]["trajnet_vanilla"]

    pkl, _, prox_s = _served("prox", "test_prox_egobody", prox["argv"]
                             + [f"--save_root={work / 'video_results_serve'}"], sock)
    hold_served("test_prox_egobody", load_result(pkl), load_result(prox["pickle"]))
    log(f"[serve] prox: pickle bit-identical to phase 7b's in-process bf16 run; client {prox_s:.2f} s, in-process "
        f"main() {prox['seconds']:.2f} s ({smi})")

    metrics, _, eval_s = _served("prox_eval", "eval_prox_egobody",
                                 video_eval_argv("prox", pkl, work / "video_stitched_serve"), sock)
    hold_served("eval_prox_egobody", metrics, prox["metrics"])
    log(f"[serve] prox_eval: metrics bit-identical to phase 7b's; client {eval_s:.2f} s, in-process "
        f"{prox['eval_s']:.2f} s ({smi})")

    def posenet_result(save_root: Path, mpjpe: float) -> dict:
        return {**load_result(str(save_root / Path(posenet["pickle"]).name)), "mpjpe": mpjpe}

    mpjpe, _, posenet_s = _served("posenet", "test_posenet", posenet["argv"]
                                  + [f"--save_root={work / 'results_single_serve'}"], sock)
    hold_served("test_posenet", posenet_result(work / "results_single_serve", mpjpe),
                posenet_result(Path(posenet["pickle"]).parent, posenet["mpjpe_m"]))
    log(f"[serve] posenet: pickle and MPJPE bit-identical to phase 7c's in-process run; client {posenet_s:.2f} s, "
        f"in-process main() {posenet['main_s']:.2f} s ({smi})")

    res, _, trajnet_s = _served("trajnet", "test_trajnet", trajnet["argv"], sock)
    hold_served("test_trajnet", res, trajnet["results"])
    log(f"[serve] trajnet: the 15 results bit-identical to phase 7c's in-process vanilla run; client "
        f"{trajnet_s:.2f} s, in-process main() {trajnet['main_s']:.2f} s ({smi})")
    return [("prox", "test_prox_egobody", served_launches(prox["counts"])),
            ("prox_eval", "eval_prox_egobody", {}),
            ("posenet", "test_posenet", served_launches(posenet["counts"])),
            ("trajnet", "test_trajnet", {})]


def _stop_daemon(sock: str, pid: int) -> bool:
    """Stop the daemon and wait for its process to end (reaped: it is this
    process's child); kill it if it outlives 60 s. True iff `stop` ended it."""
    import os
    import signal

    from rohm_tpu_torch.serve import client as sclient

    stopped = sclient.stop_server(sock)
    for _ in range(600):
        try:
            if os.waitpid(pid, os.WNOHANG)[0] == pid:
                return stopped
        except ChildProcessError:  # already reaped
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                return stopped
        time.sleep(0.1)
    os.kill(pid, signal.SIGKILL)
    os.waitpid(pid, 0)
    return False


def serve_phase(seed: int, work: Path, body_path: Path, cli: dict, video: dict, single: dict) -> dict:
    """The resident server (rohm_tpu_torch/serve) at full width: a daemon on
    the card started by `ensure_server` as a process of its own; phase 7's
    int8 `test_amass_full` argv served twice (cold, then warm: the models,
    the pipeline and its prepared int8 weights resident), one
    --data_parallel=True request (a NCCL group of one, made and destroyed
    in the daemon) and one `eval_amass_full`, each pickle held bit for bit
    to phase 7's in-process int8 run, the metrics to its; the four other
    served CLIs, each held to its in-process run of phase 7b or 7c
    (serve_other_clis); a bad request answered with a traceback, the
    daemon alive after it; then `stop`, and the daemon's process gone. The
    daemon's per-request lines (seconds, kernel launches, peak device
    memory) come from its log: a served run's
    launches happen in the daemon, not in this process, so they are not in
    the kernels' JSON. Last, one `python -m rohm_tpu_torch.cli.test_amass_full`
    process with the same argv: the start-up that the daemon saves."""
    import sys

    from rohm_tpu_torch.serve import client as sclient

    ckpts = dict.fromkeys(("posenet", "trajnet", "trajnet_control"), "")
    argv = cli_argv(work, body_path, "int8", ckpts, seed)
    ref = cli["runs"]["int8"]
    sock, log_path = str((work / "srv.sock").resolve()), work / "server.log"
    t0 = time.perf_counter()
    sclient.ensure_server(sock, start_timeout=SERVE_START_S, idle_timeout=600.0, log_path=str(log_path),
                          device="cuda")
    start_s = time.perf_counter() - t0
    pid = int(Path(sock + ".owner").read_text())
    log(f"[serve] daemon pid {pid} up in {start_s:.2f} s: "
        + "; ".join(line for line in log_path.read_text().splitlines() if "device=" in line))
    out = {"start_s": start_s}
    try:
        for run, extra in (("cold", []), ("warm", []), ("data_parallel", ["--data_parallel=True"])):
            pkl, printed, seconds = _served(run, "test_amass_full", argv + extra
                                            + [f"--save_root={work / ('results_serve_' + run)}"], sock)
            hit = "[test_amass_full] warm hit: reusing resident models + pipeline" in printed
            log(f"[serve] {run}: " + "; ".join(line for line in printed.splitlines() if "timing (s)" in line))
            same = same_result(pkl, ref["pickle"])
            log(f"[serve] {run}: pickle {'bit-identical to' if same else 'DIFFERENT from'} phase 7's in-process "
                f"int8 run; warm hit {hit}")
            if hit != (run == "warm"):
                raise AssertionError(f"the {run} served run {'missed' if run == 'warm' else 'hit'} the warm memo")
            if not same:
                raise AssertionError(f"the {run} served run is not phase 7's in-process int8 run")
            out[run] = {"seconds": seconds, "pickle": pkl}
        metrics, _, seconds = _served("eval", "eval_amass_full", [f"--saved_data_path={out['cold']['pickle']}"], sock)
        if not same_result(metrics, ref["metrics"]):
            raise AssertionError(f"served eval_amass_full {metrics} differs from phase 7's {ref['metrics']}")
        out["eval_s"] = seconds
        others = serve_other_clis(work, sock, video, single)
        try:
            _served("bad", "eval_amass_full", [f"--saved_data_path={work / 'missing.pkl'}"], sock)
            raise AssertionError("a bad request did not fail")
        except RuntimeError as e:
            if "Traceback" not in str(e) or not sclient.server_alive(sock):
                raise AssertionError("a bad request did not come back as a traceback with the daemon alive") from e
        log("[serve] bad request: traceback returned, daemon alive")
    finally:
        stopped = _stop_daemon(sock, pid)
    if not stopped or sclient.daemon_process_exists(sock):
        raise AssertionError("the daemon did not end on stop")
    log(f"[serve] stop: daemon pid {pid} gone")

    # the daemon's lines: one per request, in order
    lines = [SERVE_LINE.search(line) for line in log_path.read_text().splitlines()]
    lines = [m.groups() for m in lines if m]
    want = served_launches(ref["counts"])
    requests = [("cold", "test_amass_full", want), ("warm", "test_amass_full", want),
                ("data_parallel", "test_amass_full", want), ("eval", "eval_amass_full", {}), *others,
                ("bad", "eval_amass_full", {})]
    smi = gpu_name_and_limit()
    for (cmd, secs, ok, launches, peak), (run, want_cmd, want_launches) in zip(lines, requests):
        launches = json.loads(launches)
        peak_gib = int(peak) / 2**30 if peak != "None" else float("nan")
        log(f"[serve] daemon: {run} {cmd} {float(secs):.3f} s ok={ok}, peak device memory {peak_gib:.2f} GiB, "
            f"launches {launches} ({smi})")
        if cmd != want_cmd or launches != want_launches:
            raise AssertionError(f"the daemon's {run} request ({cmd}) did not launch the kernels its path implies: "
                                 f"{launches} != {want_launches}")
    if [g[2] for g in lines] != ["True"] * (len(requests) - 1) + ["False"]:
        raise AssertionError(f"the daemon's request lines: {lines}")

    # the same argv as a process of its own
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "rohm_tpu_torch.cli.test_amass_full", *argv,
                           f"--save_root={work / 'results_subprocess'}"],
                          capture_output=True, text=True, timeout=900)
    out["subprocess_s"] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"python -m rohm_tpu_torch.cli.test_amass_full failed:\n{proc.stderr[-4000:]}")
    sub_pkl = work / "results_subprocess" / Path(ref["pickle"]).name
    same = same_result(str(sub_pkl), ref["pickle"])
    log(f"[serve] client wall clock for phase 7's int8 argv (one batch of 32 clips): served cold "
        f"{out['cold']['seconds']:.2f} s, warm {out['warm']['seconds']:.2f} s, --data_parallel=True "
        f"{out['data_parallel']['seconds']:.2f} s; phase 7's in-process main() {ref['seconds']:.2f} s; a "
        f"python -m subprocess {out['subprocess_s']:.2f} s (pickle {'bit-identical' if same else 'DIFFERENT'}); "
        f"daemon start-up {start_s:.2f} s ({smi})")
    if not same:
        raise AssertionError("the subprocess run is not phase 7's in-process int8 run")
    return out


# ---------------------------------------------------------------------------
# phase 7f: the trained fixture, every --fused_posenet mode
# ---------------------------------------------------------------------------

TRAINED_MODES = (False, "f32", "bf16", "int8", "int8qa")


@functools.cache
def trained_fixture():
    """tests/torch_trained/fixture.py, loaded by its path: a site-packages
    `tests` package would shadow the repo's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "trained_fixture", Path(__file__).resolve().parent / "tests" / "torch_trained" / "fixture.py")
    fx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fx)
    return fx


def trained_phase(work: Path) -> dict:
    """The JAX-trained fixture of tests/torch_trained/ (TrajNet and
    TrajControl mid_dim 64, PoseNet 64d x 8 layers, dh 16, contacts
    saturated) on the card: `test_amass_full.run` with the flagship config
    (amass_occ_0.1_noise_3.yaml: --infill_traj=True, mask full, guided) on
    the fixture's tree, one batch of its 8 clips of 81 frames, in each
    --fused_posenet mode (False, the CLI's default, launches no kernel),
    then `eval_amass_full.main` on each pickle; each kernel mode's metrics
    within the budgets of plain's. Then the plain pipeline on the fixture's
    flagship batch with its replayed noise (`run_batch(preset_noise=)`): the
    metrics within rel 1e-2 (or abs 1e-6) of the JAX package's in
    meta.json."""
    from rohm_tpu_torch.cli import eval_amass_full, test_amass_full

    fx = trained_fixture()
    card = gpu_name_and_limit()
    tree = work / "trained_amass"
    fx.write_tree(tree)
    launches = dict.fromkeys(KERNELS, 0)
    runs = {}
    for mode in TRAINED_MODES:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pkl, timing = test_amass_full.run(
            fx.cli_argv("flagship", tree, work / f"trained_{mode}") + ["--device=0", f"--fused_posenet={mode}"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_launches()
        expected = expected_launches({mode: 1}) if mode else dict.fromkeys(KERNELS, 0)
        log(f"[trained] --fused_posenet={mode}: launches {counts}; expected {expected}")
        if counts != expected:
            raise AssertionError(f"the trained {mode} CLI run did not launch the kernels its mode implies")
        for name in launches:
            launches[name] += counts[name]
        metrics = eval_amass_full.main(fx.eval_argv("flagship", pkl))
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"non-finite metrics in the trained {mode} run: {metrics}")
        batch_s = timing["batch_dispatch"] + timing["device_wait_and_collect"]
        runs[mode] = {"metrics": metrics, "batch_s": batch_s, "seconds": seconds}
        log(f"[trained] --fused_posenet={mode}: one batch of {fx.N_CLIPS} clips x {fx.CLIP_LEN - 1} frames "
            f"{batch_s:.2f} s (batch_dispatch + device_wait_and_collect), run() {seconds:.2f} s, on {card}; "
            f"metrics {json.dumps(metrics)}")
    plain = runs[False]["metrics"]
    for mode in TRAINED_MODES[1:]:
        gaps = fx.metric_gaps(runs[mode]["metrics"], plain, fx.mode_budget)
        rel = {k: abs(runs[mode]["metrics"][k] - v) / max(abs(v), 1e-9) for k, v in plain.items()}
        log(f"[trained] {mode} against plain, relative: " + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
        if gaps:
            raise AssertionError(f"trained {mode} metrics off the plain mode's budgets: {gaps}")

    # the plain path on the fixture's batch with its replayed noise, against
    # the JAX package's metrics (the legs config's are held on the CPU,
    # tests/test_torch_trained_parity_legs.py)
    name = "flagship"
    pipe = fx.port_pipeline(name, False, "cuda")
    b = fx.batch(name)
    noise = fx.preset_noise(fx.N_CLIPS)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pose, _ = pipe.run_batch(*(b[k] for k in fx.BATCH_INPUTS), torch.Generator(device="cuda").manual_seed(0),
                             preset_noise=noise)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if any(read_launches().values()):
        raise AssertionError("the plain pipeline launched a kernel")
    metrics = fx.port_metrics(pipe, pose, b, name)
    jax_metrics = fx.meta()["jax_metrics"][name]
    log(f"[trained] {name} plain run_batch(preset_noise=) {seconds:.2f} s; metrics against the JAX package's "
        "(port / JAX): " + ", ".join(f"{k} {metrics[k]:.6g} / {v:.6g}" for k, v in jax_metrics.items()))
    gaps = fx.metric_gaps(metrics, jax_metrics, fx.JAX_REL, fx.JAX_ABS)
    if gaps:
        raise AssertionError(f"trained {name} plain metrics off the JAX package's: {gaps}")
    runs["jax"] = {"metrics": metrics, "seconds": seconds}
    return {"launches": launches, "runs": runs}


# ---------------------------------------------------------------------------
# phase 8: the int8 measurement path (K5, the bench chain, K8, K9)
# ---------------------------------------------------------------------------

BENCH_CHAINS = 4  # rohm_tpu_torch.bench.run: one warm-up and 3 timed chains


def _envelope(name: str, got, ref, atol: float, mean_tol: float, why: str, stats: dict, kernel: str) -> None:
    """max and mean |got - ref| within a layer's envelope."""
    err = (got.float() - ref.float()).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    ok = max_err <= atol and mean_err <= mean_tol
    log(f"[bench] {name}: max_abs_err {max_err:.3e} mean_abs_err {mean_err:.3e} "
        f"({'ok' if ok else 'FAIL'}: max {atol}, mean {mean_tol}; {why})")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    stats[kernel]["max_abs_err"] = max(stats[kernel]["max_abs_err"], max_err)


def _check_launches(what: str, counts: dict, expected: dict) -> None:
    log(f"[bench] {what}: launches {counts}; expected {expected}")
    if counts != expected:
        raise AssertionError(f"{what} did not go through its kernels as the chain implies")


def probe_launches(calls: int, k8_groups: int = 0, k9_variants: tuple = ()) -> dict:
    """Launches of `calls` calls of the K8 skeleton at each of `k8_groups`
    sizes, or of each K9 variant (its switches) in `k9_variants`."""
    out = dict.fromkeys(KERNELS, 0)
    per_call = []
    if k8_groups:
        per_call += [{"gemm_skeleton": 1, "quant_rows_int8": 4, "gemm_int8": 4}] * k8_groups
    for kw in k9_variants:
        one = {"int8_layer_variant": 1, "gemm_int8": 4, "residual_layernorm": 2,
               "quant_rows_int8 fixed-scale" if kw.get("fixed_quant") else "quant_rows_int8": 4}
        if not kw.get("no_attn"):
            one["attention_bf16 no-softmax" if kw.get("no_softmax") else "attention_bf16"] = 1
        per_call.append(one)
    for one in per_call:
        for name, k in one.items():
            out[name] += k * calls
    return out


def no_softmax_gate(qkv: torch.Tensor, seq_len: int) -> torch.Tensor:
    """Per output element of attention_bf16(no_softmax=True): a prob
    bf16(score * 0.01) whose f32 score was summed in another order may
    flip one bf16 rounding (<= 2^-8 |p|), which moves the output by <=
    2^-8 sum_j |p_j| |v_j|; plus one bf16 ulp of the output's rounding."""
    rows, d3 = qkv.shape
    d = d3 // 3
    q, k, v = (t.reshape(rows // seq_len, seq_len, H, d // H).transpose(1, 2).float() for t in qkv.split(d, -1))
    p = ((q @ k.transpose(-1, -2)) * 0.01).to(torch.bfloat16).float().abs()
    pv = (p @ v.abs()).transpose(1, 2).reshape(rows, d)
    ref = kc.attention_bf16_plain(qkv, seq_len, H, no_softmax=True).float().abs()
    return 2.0 ** -8 * pv + BF16_ULP * ref + 1e-6


def bench_phase(seed: int, stats: dict) -> dict:
    from rohm_tpu_torch import bench

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    r = B * S
    launches = dict.fromkeys(KERNELS, 0)
    mega = functools.partial(l8.prepare_posenet_int8, mega=True)

    # K5: the whole stack in one launch, against 8 launches of the K3 chain
    # (bit for bit: the same device routines) and the plain stack
    torch.manual_seed(seed)
    posenet = PoseNet().to(dev)
    # the K3 chain on the per-layer prep, K5 on the stacked one (both
    # K-major) of the same PoseNet: the same codes
    stacked = mega(posenet)["layers_stacked"]
    layers = l8.prepare_posenet_int8(posenet)["layers"]
    x = torch.randn(B, S, D, generator=g, device=dev).to(torch.bfloat16)

    def k3_chain(xx):  # the LayerNorms write the next GEMM's codes
        return l8.fused_encoder_layers_int8(xx, layers, H)

    got, k3 = l8.fused_encoder_stack_int8(x, stacked, H), k3_chain(x)
    per_sm, sms, threads = l8.stack_grid(S, D // H)
    same = torch.equal(got, k3)
    log(f"[bench] encoder_stack_int8, one cooperative launch of {per_sm} x {sms} blocks of {threads} threads for "
        f"8 layers, against the 8-layer K3 chain (1 + 9 x 8 launches): {'bit-identical' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("the stack kernel is not bit-identical to the K3 chain")
    # a layer's kernels vs its plain chain flip a few int8 codes and bf16
    # roundings (phase 3); over 8 layers they propagate, so the gate is the
    # int8 layer's own envelope against flax (tests/test_ops.py)
    _envelope("encoder_stack_int8 [32,144,512] x 8 layers vs the plain stack", got,
              l8.fused_encoder_stack_int8_plain(x, stacked, H), 0.3, 5e-2,
              "the int8 layer's envelope, held over 8 layers", stats, "encoder_stack_int8")
    static = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k3_chain(static)  # warm-up before capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        graph_out = k3_chain(static)
    graph.replay()
    if not torch.equal(graph_out, k3):
        raise AssertionError("the CUDA graph of the K3 chain does not replay the chain")
    int8_ops = LAYERS * 2 * r * (D * 3 * D + D * D + 2 * D * F)
    _time("encoder_stack_int8 (8 layers)", lambda: l8.fused_encoder_stack_int8(x, stacked, H),
          lambda: l8.fused_encoder_stack_int8_plain(x, stacked, H), stats, "encoder_stack_int8",
          {"int8": int8_ops, "bf16": LAYERS * 4 * r * S * D}, nbytes(x, got, *stacked), None, tag="bench")
    chain_ms, graph_ms = median_ms(lambda: k3_chain(x)), median_ms(graph.replay)
    log(f"[bench] the same 8 layers as 73 launches of the K3 chain: {chain_ms:.4f} ms; as one CUDA graph of "
        f"that chain: {graph_ms:.4f} ms (median of 20)")
    del graph, graph_out
    # where the stack's time goes: the global timer at each grid barrier,
    # beside the K3 chain's kernels under the profiler
    stamps = torch.zeros(2 + 9 * LAYERS, dtype=torch.int64, device=dev)
    l8.fused_encoder_stack_int8(x, stacked, H, phase_ns=stamps)
    gaps = (stamps[1:] - stamps[:-1]).tolist()
    phases = {name: sum(gaps[1 + 9 * i + j] for i in range(LAYERS)) / 1e3 for j, name in enumerate(l8.STACK_PHASES)}
    log(f"[bench] encoder_stack_int8 phases, us summed over the 8 layers (one launch): quant x {gaps[0] / 1e3:.1f}, "
        + ", ".join(f"{name} {us:.1f}" for name, us in phases.items()) + f"; total {sum(gaps) / 1e3:.1f}")
    device_busy(lambda: k3_chain(x), 5, "the K3 chain, 8 layers", "bench")
    out = {"stack": {"blocks_per_sm": per_sm, "sms": sms, "threads": threads,
                     "ms": stats["encoder_stack_int8"]["ms"], "k3_chain_ms": chain_ms, "k3_graph_ms": graph_ms,
                     "phases_us": phases}}

    # the bench chain (rohm_tpu_torch.bench, the port of root bench.py) on
    # the per-layer prep, then on the mega prep with the same seeds
    results = {}
    for name, prepare, expected in (
        ("int8 per layer", l8.prepare_posenet_int8, forward_launches("int8", BENCH_CHAINS * bench.STEPS)),
        ("int8 mega", mega, {**dict.fromkeys(KERNELS, 0), "encoder_stack_int8": BENCH_CHAINS * bench.STEPS}),
    ):
        reset_launches()
        res = bench.run(device=dev, prepare=prepare, seed=seed)
        counts = read_launches()
        _check_launches(f"bench chain, {name}", counts, expected)
        for k in launches:
            launches[k] += counts[k]
        sample = res.pop("sample")
        if tuple(sample.shape) != (bench.BATCH, bench.T, 294) or not torch.isfinite(sample).all():
            raise AssertionError(f"bench chain {name}: bad final sample")
        results[name] = (res, sample)
        log(f"[bench] {name}: {json.dumps(res)}")
    same = torch.equal(results["int8 per layer"][1], results["int8 mega"][1])
    log(f"[bench] final samples of the two chains (generator seed 4): {'bit-identical' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("the mega chain's samples differ from the per-layer chain's")
    busy = {}
    for name, prepare in (("int8 per layer", l8.prepare_posenet_int8), ("int8 mega", mega)):
        torch.manual_seed(seed)
        sample20 = bench.make_chain(PoseNet(), prepare, bench.BATCH, bench.T, 20, dev)

        def chain20(sample20=sample20):
            return sample20(torch.Generator(device=dev).manual_seed(5))

        chain20()
        busy[name] = device_busy(chain20, 1, f"bench chain {name}, 20 steps", "bench")
    out["bench"] = {name: {**res, "busy": busy[name]} for name, (res, _) in results.items()}

    # K8: the GEMM skeleton at each size against its plain version, then the probe
    macs = D * 3 * D + D * D + 2 * D * F
    for group in k8.GROUPS:
        w, xg = k8.build(group, dev)
        got, ref = k8.gemm_skeleton(xg, w), k8.gemm_skeleton_plain(xg, w)
        _check(f"gemm_skeleton group {group} [{group * S} rows]", got, ref, BF16_ULP * ref.float().abs(),
               "int8 codes and int32 sums exact: equal, or one bf16 ulp", stats, "gemm_skeleton")
        _time(f"gemm_skeleton group {group}", lambda: k8.gemm_skeleton(xg, w),
              lambda: k8.gemm_skeleton_plain(xg, w), stats, "gemm_skeleton", 2 * group * S * macs,
              nbytes(xg, *w, got), "int8", tag="bench")
    qkv = torch.randn(r, 3 * D, generator=g, device=dev).to(torch.bfloat16)
    (q, sc), (q_ref, sc_ref) = l8.quant_rows_int8(qkv[:, :D]), l8.quant_rows_int8_plain(qkv[:, :D])
    _check("quant_rows_int8 of the q third of a QKV buffer, read in place (row stride 1536): codes", q, q_ref, 0.0,
           "exact", stats, "quant_rows_int8")
    _check("quant_rows_int8 of the q third, in place: scales", sc, sc_ref, 0.0, "exact", stats, "quant_rows_int8")
    reset_launches()
    out["k8"] = k8.main([])
    counts = read_launches()
    probe_calls = k8.ITERS + 2 + k8.GRAPH_CALLS  # warm-ups, the chain from Python, the captured chain
    _check_launches("scripts.bench_int8_gemm_rows.main()", counts, probe_launches(probe_calls, len(k8.GROUPS)))
    for k in launches:
        launches[k] += counts[k]

    # K9: each variant against its plain version, the two modes it adds,
    # then the probe
    prepared, x9 = k9.build(dev)
    r9 = k9.G * k9.S
    for name, kw in k9.VARIANTS:
        got = k9.int8_layer_variant(x9, prepared, **kw)
        ref = k9.int8_layer_variant_plain(x9, prepared, **kw)
        _envelope(f"int8_layer_variant {name} [8,144,512]", got, ref, 0.3, 5e-2,
                  "the int8 layer's gate (phase 3)", stats, "int8_layer_variant")
        ops = {"int8": 2 * r9 * macs, **({} if kw.get("no_attn") else {"bf16": 4 * r9 * S * D})}
        _time(f"int8_layer_variant {name}", lambda: k9.int8_layer_variant(x9, prepared, **kw),
              lambda: k9.int8_layer_variant_plain(x9, prepared, **kw), stats, "int8_layer_variant", ops,
              nbytes(x9, got, *prepared), None, tag="bench")
    x92 = x9.reshape(r9, D)
    qkv9 = l8.gemm_int8(*l8.quant_rows_int8(x92), *prepared[:3], "bf16")
    for name, a in (("x bf16 [1152,512]", x92), ("attn bf16 [1152,512]", qkv9[:, 2 * D:].contiguous()),
                    ("y f32 [1152,512]", torch.randn(r9, D, generator=g, device=dev)),
                    ("h1 f32 [1152,1024]", torch.randn(r9, F, generator=g, device=dev))):
        (q, sc), (q_ref, sc_ref) = l8.quant_rows_int8(a, k9.FIXED_SCALE), l8.quant_rows_int8_plain(a, k9.FIXED_SCALE)
        _check(f"quant_rows_int8 fixed-scale {name} codes", q, q_ref, 0.0, "exact: the same product and rint",
               stats, "quant_rows_int8 fixed-scale")
        _check(f"quant_rows_int8 fixed-scale {name} scales", sc, sc_ref, 0.0, "exact", stats,
               "quant_rows_int8 fixed-scale")
        _time(f"quant_rows_int8 fixed-scale {name}", lambda: l8.quant_rows_int8(a, k9.FIXED_SCALE),
              lambda: l8.quant_rows_int8_plain(a, k9.FIXED_SCALE), stats, "quant_rows_int8 fixed-scale", 0,
              nbytes(a, q, sc), None, tag="bench")
    got, ref = kc.attention_bf16(qkv9, S, H, True), kc.attention_bf16_plain(qkv9, S, H, True)
    _check("attention_bf16 no-softmax [8 seq x 4 heads, S=144, dh=128]", got, ref, no_softmax_gate(qkv9, S),
           "one bf16 flip per prob (2^-8 sum|p||v|) + one bf16 ulp of the output", stats,
           "attention_bf16 no-softmax")
    _time("attention_bf16 no-softmax", lambda: kc.attention_bf16(qkv9, S, H, True),
          lambda: kc.attention_bf16_plain(qkv9, S, H, True), stats, "attention_bf16 no-softmax",
          4 * r9 * S * D, nbytes(qkv9, got), "bf16", tag="bench")
    reset_launches()
    out["k9"] = k9.main([])
    counts = read_launches()
    _check_launches("scripts.bench_int8_layer.main()", counts,
                    probe_launches(k9.ITERS + 2 + k8.GRAPH_CALLS, k9_variants=tuple(kw for _, kw in k9.VARIANTS)))
    for k in launches:
        launches[k] += counts[k]
    torch.cuda.synchronize()
    out["launches"] = launches
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    t_start = time.perf_counter()
    device = device_phase()
    build_phase()
    stats = kernel_phase(args.seed)
    train_kernel_phase(args.seed, stats)
    long_seq_phase(args.seed, stats)
    long_seq_timing(args.seed)
    sl = slice_phase(args.seed, N_INT8, N_BF16)
    work = Path(".chipscratch") / "smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    body_path = work / "SMPLX_NEUTRAL.npz"
    write_smplx_npz(body_path, args.seed)
    train = train_phase(args.seed, work, body_path)
    trajtrain = trajnet_train_phase(args.seed, work, body_path)
    cli = cli_phase(args.seed, work, body_path, train["checkpoint"], trajtrain["checkpoints"])
    video = video_phase(args.seed, work, body_path, train["checkpoint"], trajtrain["checkpoints"])
    single = single_net_phase(args.seed, work, body_path, train["checkpoint"], trajtrain["checkpoints"])
    dp = data_parallel_phase(args.seed, work, body_path, cli, train, trajtrain)
    serve_phase(args.seed, work, body_path, cli, video["runs"], single)
    trained = trained_phase(work)
    shutil.rmtree(work)
    bench = bench_phase(args.seed, stats)
    log(f"[done] chip_smoke.py phases took {time.perf_counter() - t_start:.1f} s")
    # launches: the slice's, the training runs' (TrajNet's launch none), the
    # CLIs' (AMASS, video, single-net) and the bench phase's main-path runs, each counted from 0; ms / plain_ms / bound_ms
    # / library_ms are per layer (summed over the launches one layer
    # makes), per 8-layer forward for encoder_stack_int8, and summed over
    # the probe's sizes or variants for gemm_skeleton and int8_layer_variant
    kernels = []
    for name, (_, _, src, rep) in KERNELS.items():
        st = stats[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(ph["launches"][name] for ph in (sl, train, trajtrain, cli, video, single, dp, trained,
                                                             bench)),
            "max_abs_err": st["max_abs_err"], "ms": st["ms"], "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"], "bound_by": "operations" if st["ops_ms"] > st["bytes_ms"] else "bytes",
            "library_ms": st["library_ms"], "card_ms": st["card_ms"], "library_card_ms": st["library_card_ms"],
        })
    unused = [k["name"] for k in kernels if k["launches"] == 0]
    if unused:
        raise AssertionError(f"kernels never launched by the main path: {unused}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
