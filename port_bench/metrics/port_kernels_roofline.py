"""The port's hand-written kernels' share of their roofline, in %: per
kernel name, the least time of its launches (the larger of operations over
the peak and bytes over the HBM rate, at the cell's shapes, from
harness/counts.py), summed, over the same launches' device time in the
trace. A kernel this list does not know drops out of both sums. Of every
kernel it knows, the launches found in the trace under its name must match
those ops.launch_counts() counted and those the batch's forwards make;
where any differs (a kernel renamed, missed or run off the counted path),
the metric reads nothing rather than a share of a different set of work."""

import re
import sys
from collections import defaultdict

from harness.counts import least_seconds

# the port's kernel (ops wrapper) -> its CUDA function's name in the trace
TRACE_NAMES = {
    "gemm_int8": r"^wg::gemm_kernel$",
    "gemm_f32": r"^f32g::gemm_kernel$",
    "attention_bf16": r"^attention_bf16_kernel$",
    "attention_f32": r"^attention_f32_kernel$",
    "residual_layernorm": r"^residual_layernorm_kernel$",
    "quant_rows_int8": r"^quant_rows_int8_kernel$",
}


def read(ctx: dict):
    per_forward = defaultdict(list)
    for kernel, ops, nbytes, cls in ctx["kernel_bounds"]:
        per_forward[kernel].append(least_seconds(ops, nbytes, cls))
    trace = ctx["trace"]
    bound = device = 0.0
    for kernel, bounds in per_forward.items():
        names = [n for n in trace["kernel_seconds"] if re.search(TRACE_NAMES[kernel], n)]
        n_launch = sum(trace["kernel_launches"].get(n, 0) for n in names)
        counted = sum(v for k, v in ctx["port_launches"].items() if k.startswith(kernel + "."))
        if not n_launch or n_launch != counted or n_launch != len(bounds) * ctx["forwards"]:
            print(f"[port_kernels_roofline] {kernel}: {n_launch} launches traced, {counted} counted by "
                  f"ops.launch_counts(), {len(bounds) * ctx['forwards']} expected: no reading", file=sys.stderr)
            return None
        bound += n_launch * sum(bounds) / len(bounds)
        device += sum(trace["kernel_seconds"][n] for n in names)
    if device <= 0:
        return None
    return 100.0 * bound / device
