"""Readings of a cell's check, for setting its limits: per seed, one batch
through the program at the cell's own size, then the check's numbers
against the reference and against the control (the reference in the
precision below the configuration's, in the program's place).

    python3 port_bench/readings.py --workload <cell> --seeds <n>,<n>,...

One JSON line per seed on standard output. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(BENCH_DIR.parent / ".bench_cache" / "triton")
    sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]
    import torch
    from harness import spec

    if not torch.cuda.is_available():
        print("readings.py: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload, spec.benchmark())
    seeds = [int(s) for s in args.seeds.split(",")]
    for row in spec.driver(cell["config"]).readings(cell, seeds, torch.device("cuda", 0)):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
