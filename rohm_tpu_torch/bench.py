"""Benchmark: denoise steps per second on the card, on the int8 PoseNet
sampling chain.

    python -m rohm_tpu_torch.bench [--device cuda:0]

The port of the JAX package's root `bench.py`: PoseNet 512d x 8 layers (4
heads, FF 1024) with random weights, the full reverse diffusion (1000
cosine steps) at batch 32 x T=143 x 294 with zero conditioning, the shape
the AMASS pipeline samples, through the int8 path (`prepare_posenet_int8`,
`embed_cond` once, `posenet_apply_prepared` per step in `p_sample_loop`).
One warm-up chain, then three timed chains, each on the host clock around
work that ends in `torch.cuda.synchronize()`.

Prints ONE JSON line on stdout, the keys of root bench.py: {"metric",
"value", "unit", "vs_baseline"}; vs_baseline is value /
REF_A100_STEPS_PER_SEC, the root bench's documented estimate of the
reference PyTorch sampling rate on an A100 at the same shape (BASELINE.md);
the uncertainty band goes to stderr with the card's name. The bench
measures the card and has no CPU fallback; `run` takes any device, for the
tests.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable

import torch

from rohm_tpu_torch.diffusion.sampler import p_sample_loop
from rohm_tpu_torch.diffusion.schedule import make_schedule
from rohm_tpu_torch.models import PoseNet
from rohm_tpu_torch.ops import embed_cond, posenet_apply_prepared, prepare_posenet_int8

# root bench.py's estimate of the reference sampling rate on an A100 (band
# [137 dispatch-bound, 557 compute-bound], point estimate 274 rounded up)
REF_A100_STEPS_PER_SEC = 300.0
REF_A100_BAND = (137.0, 557.0)

BATCH = 32
T = 143
STEPS = 1000
FEAT = 294


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_chain(posenet: PoseNet, prepare: Callable, batch: int, frames: int, steps: int,
               device) -> Callable:
    """The bench's sampling chain: `prepare(posenet)` once, the zero
    condition embedded once, then `p_sample_loop` over a cosine schedule of
    `steps` steps. Returns sample(generator, noise=None, step_noise=None) ->
    [batch, frames, 294], with the sampler's replay hooks."""
    device = torch.device(device)
    posenet = posenet.to(device)
    prep = prepare(posenet)
    cond = torch.zeros(batch, frames, FEAT, device=device)
    cond_emb = embed_cond(prep, cond)
    sched = make_schedule("cosine", steps, device=device)
    heads = posenet.num_heads

    def model_fn(x_t, t):
        return posenet_apply_prepared(prep, x_t, cond, t, num_heads=heads, cond_emb=cond_emb)

    def sample(generator, noise=None, step_noise=None):
        return p_sample_loop(model_fn, sched, (batch, frames, FEAT), generator, noise=noise,
                             step_noise=step_noise)

    return sample


def run(batch: int = BATCH, frames: int = T, steps: int = STEPS, device="cuda:0",
        prepare: Callable = prepare_posenet_int8, posenet: PoseNet | None = None, seed: int = 0,
        n_rep: int = 3) -> dict:
    """Time the chain: one warm-up chain (generator seed 1), then `n_rep`
    timed chains (seeds 2, 3, ...). `posenet` defaults to PoseNet() with
    weights from `seed`. Returns the JSON line's four keys, plus "seconds"
    (the timed chains' mean), "device" and "sample" (the last chain's output,
    a tensor)."""
    device = torch.device(device)
    if posenet is None:
        torch.manual_seed(seed)
        posenet = PoseNet()
    sample = make_chain(posenet, prepare, batch, frames, steps, device)

    def chain(i):
        out = sample(torch.Generator(device=device).manual_seed(i))
        _sync(device)
        return out

    chain(1)  # warm-up: the first launch builds the kernels
    t0 = time.perf_counter()
    for i in range(n_rep):
        out = chain(2 + i)
    dt = (time.perf_counter() - t0) / n_rep
    steps_per_sec = steps / dt
    return {
        "metric": "denoise_steps_per_sec_per_chip",
        "value": round(steps_per_sec, 2),
        "unit": (f"steps/s (PoseNet {posenet.latent_dim}d x{posenet.num_layers}L, "
                 f"bs={batch}, T={frames})"),
        "vs_baseline": round(steps_per_sec / REF_A100_STEPS_PER_SEC, 3),
        "seconds": dt,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "sample": out,
    }


def report(result: dict) -> None:
    """The A100 band and the device on stderr; the one JSON line on stdout."""
    v = result["value"]
    lo, hi = REF_A100_BAND
    print(f"[bench] {result['device']}: vs A100 band [{lo:.0f}, {hi:.0f}] steps/s: "
          f"{v / hi:.2f}x - {v / lo:.2f}x (point estimate {v / REF_A100_STEPS_PER_SEC:.2f}x at "
          f"{REF_A100_STEPS_PER_SEC:.0f})", file=sys.stderr)
    print(json.dumps({k: result[k] for k in ("metric", "value", "unit", "vs_baseline")}), flush=True)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit(f"bench: needs a CUDA device (got {args.device!r}, cuda available: "
                         f"{torch.cuda.is_available()}); it measures the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    result = run(device=device)
    report(result)
    return result


if __name__ == "__main__":
    main()
