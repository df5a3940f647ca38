"""Where the window holds more batches than the traffic's
`checked_batches`, the check reads a sample of them drawn from the seed,
and a fault in any batch still fails the run when its batch is drawn."""

import time

import torch
from conftest import tiny
from harness import spec

CPU = torch.device("cpu")
SEED = 2**31 + 919


def run(bench, seconds, checked, seed=SEED):
    cell = tiny(spec.cell("amass_leg3_int8.b256", bench))
    cell["traffic"]["checked_batches"] = checked
    return spec.driver(cell["config"]).run_cell(cell, seed, seconds, False, CPU, time.perf_counter())


def test_window_longer_than_the_sample(bench, few_threads):
    first = run(bench, 0.0, 1)
    assert first["checked_batches"] == [0]
    out = run(bench, 3.5 * first["batch_seconds"][0], 2)
    n = len(out["batch_seconds"])
    assert n >= 3, out["batch_seconds"]
    assert out["correct"], out["checks"]
    assert out["attempted"] == n * 2
    assert len(out["checked_batches"]) == 2 and all(0 <= k < n for k in out["checked_batches"])

