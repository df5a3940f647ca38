"""Probe: does the int8 layer's GEMM chain run faster per row at more rows?

The port of scripts/bench_int8_gemm_rows.py. It times the int8 layer's GEMM
skeleton (dynamic row quantization, then the four W8A8 products QKV,
attention-out, FF1 and FF2 with int32 sums and the row x column rescale to
bf16; attention, softmax, LayerNorm and gelu stripped, q passed through in
place of attention) at 4, 8, 16 and 32 sequences of 144 tokens (576-4608
rows). If the time per row drops materially with more rows, the layer's
GEMMs want more rows; if it is flat, the row count is not what holds them.

On the card the skeleton is the layer's own hand-written kernels:
`quant_rows_int8` (the q passthrough read in place from the QKV buffer
through its row stride) and `gemm_int8` in mode "bf16" with a zero bias,
four times (`gemm_skeleton`). The bias add of 0.0 changes only the sign of
a zero product. Each size runs 1000 chained calls (each call's output is
the next one's input) from Python, timed with CUDA events, then the card
alone: 10 chained calls in a CUDA graph, replayed 100 times. The verdict
reads the card's times.

    python -m rohm_tpu_torch.scripts.bench_int8_gemm_rows [--device cuda:0] [--iters 1000]
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from rohm_tpu_torch.ops.transformer_layer_int8 import (
    _quant_cols,
    gemm_int8,
    gemm_int8_plain,
    quant_rows_int8,
    quant_rows_int8_plain,
)

S, D, F = 144, 512, 1024
ITERS = 1000
GROUPS = (4, 8, 16, 32)
PEAK_INT8_OPS = 1979e12  # H100 SXM, dense int8 (NVIDIA data sheet, 700 W)


@functools.cache
def _zeros(n: int, device: torch.device) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.float32, device=device)


def _skeleton(x: torch.Tensor, weights: tuple, quant, gemm) -> torch.Tensor:
    wqkv, sqkv, wo, so, w1, s1, w2, s2 = weights
    g, s, d = x.shape
    qx, rs = quant(x.reshape(g * s, d))
    qkv = gemm(qx, rs, wqkv, sqkv, _zeros(wqkv.shape[1], x.device), "bf16")
    qa, ra = quant(qkv[:, :d])  # attention replaced by a passthrough of q (the ablation)
    o = gemm(qa, ra, wo, so, _zeros(wo.shape[1], x.device), "bf16")
    qh, rh = quant(o)
    h = gemm(qh, rh, w1, s1, _zeros(w1.shape[1], x.device), "bf16")
    qg, rg = quant(h)
    y = gemm(qg, rg, w2, s2, _zeros(w2.shape[1], x.device), "bf16")
    return y.reshape(g, s, d)


def gemm_skeleton_plain(x: torch.Tensor, weights: tuple) -> torch.Tensor:
    """The skeleton through the plain PyTorch versions, on any device."""
    return _skeleton(x, weights, quant_rows_int8_plain, gemm_int8_plain)


def gemm_skeleton(x: torch.Tensor, weights: tuple) -> torch.Tensor:
    """x [g, S, D] bf16 -> [g, S, D] bf16 through the skeleton; `weights` =
    (wqkv, sqkv, wo, so, w1, s1, w2, s2) as `build` makes them.

    Replaces scripts/bench_int8_gemm_rows.py::gemm_kernel. CUDA: four
    quant_rows_int8 and four gemm_int8 launches (csrc/quant_rows_int8.cu,
    csrc/gemm_int8.cu); `launches` counts calls on the card."""
    if x.device.type == "cpu":
        return gemm_skeleton_plain(x, weights)
    out = _skeleton(x, weights, quant_rows_int8, gemm_int8)
    gemm_skeleton.launches += 1
    return out


gemm_skeleton.launches = 0


def build(b: int, device) -> tuple[tuple, torch.Tensor]:
    """The probe's weights (int8, per-column scales) and a [b, S, D] bf16
    input, from np.random.default_rng(0) in the order of the JAX script's
    `build`."""
    rng = np.random.default_rng(0)

    def qcols(*shape):
        q, s = _quant_cols(torch.from_numpy(rng.normal(size=shape).astype(np.float32)))
        return q.contiguous().to(device), s.to(device)

    wqkv, sqkv = qcols(D, 3 * D)
    wo, so = qcols(D, D)
    w1, s1 = qcols(D, F)
    w2, s2 = qcols(F, D)
    x = torch.from_numpy(rng.normal(size=(b, S, D)).astype(np.float32)).to(torch.bfloat16).to(device)
    return (wqkv, sqkv, wo, so, w1, s1, w2, s2), x


GRAPH_CALLS, GRAPH_REPLAYS = 10, 100


def _elapsed(run, n: int) -> float:
    """Seconds per run of n runs, CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / n


def time_calls(fn, x: torch.Tensor, iters: int) -> tuple[float, float]:
    """Seconds per call of chained calls x <- fn(x): (1) `iters` calls from
    Python, CUDA events around them, which counts the host's launch cost
    wherever the card waits on it; (2) the card alone: GRAPH_CALLS chained
    calls captured in one CUDA graph, replayed GRAPH_REPLAYS times (the
    replays launch the kernels without the wrappers, so without counting)."""
    fn(x)  # warm-up

    def chain(n):
        y = x
        for _ in range(n):
            y = fn(y)
        return y

    host = _elapsed(lambda: chain(iters), 1) / iters
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(x)  # warm-up off the default stream, before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        chain(GRAPH_CALLS)
    graph.replay()
    card = _elapsed(graph.replay, GRAPH_REPLAYS) / GRAPH_CALLS
    return host, card


def cuda_device(name: str, argv=None) -> tuple[torch.device, int]:
    """(--device, --iters) of a probe's command line; the probes measure
    the card and refuse any other device."""
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda:0")
    parser.add_argument("--iters", type=int, default=ITERS)
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit(f"{name}: needs a CUDA device (got {args.device!r})")
    print(f"device={torch.cuda.get_device_name(device)}", flush=True)
    return device, args.iters


def probe(device, iters: int = ITERS) -> dict:
    """Time chained skeleton calls at each size (from Python and on the
    card alone, `time_calls`); print and return us/group both ways, the
    ideal at the int8 peak, and the card's utilisation and ns/row, then the
    verdict on the card's times."""
    macs_per_row = D * 3 * D + D * D + D * F + F * D
    results = {}
    for group in GROUPS:
        weights, x = build(group, device)  # one group per call, as the JAX probe's grid=1
        host, card = time_calls(lambda c: gemm_skeleton(c, weights), x, iters)
        rows = group * S
        ideal = 2 * rows * macs_per_row / PEAK_INT8_OPS
        util = ideal / card
        results[group] = {"rows": rows, "host_us_per_group": host * 1e6, "us_per_group": card * 1e6,
                          "ideal_us": ideal * 1e6, "utilisation": util, "ns_per_row": card / rows * 1e9}
        print(f"group={group:2d} rows={rows:5d}: {host * 1e6:7.1f} us/group from Python, {card * 1e6:7.1f} on "
              f"the card | ideal {ideal * 1e6:5.1f} us at {PEAK_INT8_OPS / 1e12:.0f} TOP/s "
              f"| utilisation {util:6.1%} | {card / rows * 1e9:6.1f} ns/row", flush=True)
    g8, g16 = results[8], results[16]
    if g16["utilisation"] > 1.15 * g8["utilisation"]:
        verdict = ("REGROUP WINS: larger GEMM row counts materially beat group=8; "
                   "the layer's GEMMs want more rows")
    else:
        verdict = ("FLOOR PINNED: us/row is flat with row count; the GEMMs' utilisation at "
                   "1152 rows is not a grouping artifact")
    print(verdict, flush=True)
    return {"groups": results, "verdict": verdict}


def main(argv=None) -> dict:
    return probe(*cuda_device("bench_int8_gemm_rows", argv))


if __name__ == "__main__":
    main()
