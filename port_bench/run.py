"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic, limits and metrics come from
BENCHMARK.json and the files it names (harness/spec.py). With --trace 0 the
last line of standard output carries the cell's end-to-end metrics; with
--trace 1 its per-layer metrics, read from a profiled batch. Every run
checks what the timed path produced against the plain reference
(port_bench/reference) and prints each compared number beside its limit,
last on standard error and last in the result line.

Exits non-zero with no result line when no CUDA card (or fewer than the
cell asks for) is present, when the program cannot be imported, or when
JAX, jaxlib, flax or the JAX package was loaded in this process.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "rohm_tpu")


def forbidden_loaded() -> list[str]:
    """Top-level names in sys.modules that the benchmark must not load,
    compared whole (rohm_tpu_torch is not rohm_tpu)."""
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN_MODULES))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every cache the run writes stays inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    from harness import spec

    cell = spec.cell(args.workload, spec.benchmark(ROOT))

    import torch

    need = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"run.py: the cell needs {need} CUDA card(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    out = spec.driver(cell["config"]).run(cell, args, PROCESS_START)

    metrics = {}
    wanted = cell["per_layer"] if args.trace else cell["end_to_end"]
    for m in wanted:
        if args.trace:
            value = spec.metric_reader(m["name"]).read(out["trace_context"])
        else:
            value = out["end_to_end"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    found = forbidden_loaded()
    if found:
        print(f"run.py: forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 3

    checks = out["checks"]
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": out["device"]}
    if args.trace:
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
