"""Build and load the Hopper kernels of rohm_tpu_torch/ops/csrc.

The sources compile with nvcc into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so a build takes seconds):
one nvcc process per source, all started together, then one link.
The build runs at the first launch of a kernel, never at import, into
`rohm_tpu_torch/_build/<hash of the sources and flags>/`, so a change to a
source rebuilds and an unchanged tree reuses the library.

Every entry point returns a cudaError_t; `launch` raises on a non-zero code,
which is how a refused launch (too many threads, too much shared memory)
surfaces: torch.cuda.synchronize() would not report it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry point -> argtypes (pointers and the stream as c_void_p)
SIGNATURES = {
    "rt_gemm_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "rt_gemm_int8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "rt_gemm_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "rt_attention_bf16": [_P, _P, _I, _I, _I, _I, _I, _P],
    "rt_attention_f32": [_P, _P, _I, _I, _I, _I, _P],
    "rt_attention_int8": [_P, _P, _I, _I, _I, _I, _P],
    "rt_residual_layernorm": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    "rt_quant_rows_int8": [_P, _I, _P, _P, _I, _I, _I, _F, _P],
    "rt_encoder_stack_int8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "rt_encoder_stack_int8_grid": [_I, _I, _P],
    "rt_gemm_train": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _F, _I, _P, _P, _I, _I, _P, _P],
    "rt_round_bf16": [_P, _P, ctypes.c_longlong, _P],
    "rt_attention_train_fwd": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P],
    "rt_attention_train_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P],
    "rt_layernorm_train_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P],
    "rt_layernorm_train_bwd": [_P, _P, _P, _P, _P, _F, _P, _P, _P, _I, _I, _P],
    "rt_colsum": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    candidates.append(shutil.which("nvcc") or "")
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the Hopper kernels cannot be built")


def build() -> tuple[Path, float]:
    """Compile the library if this source hash has none yet.
    Returns (path, seconds spent compiling; 0.0 when it was already built)."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / "librohm_kernels.so"
    if lib_path.exists():
        return lib_path, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    t0 = time.perf_counter()
    compiles = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        compiles.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in compiles:
        output, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + output)
        if proc.returncode != 0:
            failed.append(output)
    if not failed:
        tmp = out_dir / f"librohm_kernels.{tag}.tmp.so"
        cmd = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(tmp),
               *(str(obj) for _, obj, _ in compiles)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(proc.stderr)
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text("\n".join(log))
    for _, obj, _ in compiles:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{failed[0][-4000:]}")
    os.replace(tmp, lib_path)
    return lib_path, seconds


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib_path, _ = build()
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call one C entry point; raise if it reports a CUDA error."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} ({lib.rt_error_string(err).decode()})")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def check_cuda(t: torch.Tensor, dtype: torch.dtype, ndim: int, name: str) -> None:
    """Validate a kernel operand: a contiguous CUDA tensor of this dtype and
    rank whose storage starts on a 16-byte boundary (vector loads)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {dtype} of rank {ndim}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a contiguous, 16-byte aligned tensor")
