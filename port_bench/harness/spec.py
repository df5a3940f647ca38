"""BENCHMARK.json and the files it names, found by name.

- port_bench/configs/<config>.json: a configuration; its "driver" key names
  port_bench/drivers/<driver>.py
- port_bench/traffic/<traffic>.json: a traffic mix
- port_bench/limits/<workload>.json: the limits of a cell's correctness check
- port_bench/metrics/<metric>.py: the reader of a per-layer metric
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import a file as a module of its own (metric files carry dots in
    their names, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(f"port_bench_{path.parent.name}_{path.stem}".replace(".", "_"),
                                                  path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(workload: str, bench: dict) -> dict:
    """Everything one cell needs: its entry, configuration, traffic, limits,
    end-to-end metrics and per-layer metrics."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({sorted(entries)})")
    w = entries[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def reports(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    return {
        "workload": w,
        "config": load_json(ROOT / cfg_entry["file"]),
        "traffic": load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        "limits": load_json(BENCH_DIR / "limits" / f"{workload}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }


def driver(config: dict):
    return load_module(BENCH_DIR / "drivers" / f"{config['driver']}.py")


def metric_reader(name: str):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py")
