"""The port's spans (utils/profiling.py) and the sampler's step observers,
on the CPU: the span tree of one batch of the benchmark's tiny preset under
a CPU-only torch.profiler profile, nothing recorded and the same outputs
without one, and the observers against the benchmark's StepRecorder.

The card's side (device stamps on the host clock, the sync counter) is in
test_torch_spans_cuda.py."""

import json
import os
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rohm_tpu_torch.diffusion import sampler
from rohm_tpu_torch.models.guidance import AMASS_SKATING_T_THRESH
from rohm_tpu_torch.utils import profiling

BENCH = Path(__file__).resolve().parents[1] / "port_bench"
SEED = 2**31 + 2525


@pytest.fixture(scope="module")
def tiny_cell():
    """The benchmark's int8 cell at its tiny preset, its driver, program and
    first batch (CPU)."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from harness import spec

    tiny = spec.load_module(BENCH / "tests" / "conftest.py").tiny
    cell = tiny(spec.cell("amass_leg3_int8.b256", spec.benchmark()))
    drv = spec.driver(cell["config"])
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        body, stats, batches = drv.make_inputs(cell["config"], cell["traffic"], SEED, torch.device("cpu"))
        prog = drv.Program(cell["config"], body, stats["mean"], stats["std"], SEED, torch.device("cpu"))
        yield cell, drv, prog, batches[0]
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tiny_cell):
    """One batch recorded under a CPU profile, then the same batch (same
    generator seed) with no profile while making a CUDA event raises."""
    _, _, prog, batch = tiny_cell
    profiling.take_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        recorded = prog.run_batch(batch, torch.Generator().manual_seed(7))
    log = profiling.take_spans()

    def no_event(*a, **kw):
        raise AssertionError("a CUDA event was made with no profile recording")

    orig, torch.cuda.Event = torch.cuda.Event, no_event
    try:
        plain = prog.run_batch(batch, torch.Generator().manual_seed(7))
    finally:
        torch.cuda.Event = orig
    return log, recorded, plain, profiling.take_spans()


def test_span_tree_of_a_batch(tiny_cell, runs):
    cell, _, _, _ = tiny_cell
    cfg = cell["config"]
    log = runs[0]
    traj_steps, pose_steps, iters = cfg["diffusion_steps_trajnet"], cfg["diffusion_steps_posenet"], cfg["sample_iter"]
    guided = min(AMASS_SKATING_T_THRESH, pose_steps - 1) + 1
    assert Counter(s["name"] for s in log) == {
        "batch": 1, "chain.traj": iters, "chain.pose": iters, "bridge": iters,
        "step": iters * (traj_steps + pose_steps), "guidance": iters * guided}
    assert log[0]["name"] == "batch" and log[0]["parent"] is None
    assert all(s["root"] == 0 for s in log)
    top = [(s["name"], s["attrs"]) for s in log if s["parent"] == 0]
    assert top == [(name, attrs) for i in range(iters)
                   for name, attrs in (("chain.traj", {"iteration": i}), ("bridge", {}),
                                       ("chain.pose", {"iteration": i}))]
    for i, s in enumerate(log):
        kids = [k for k in log if k["parent"] == i]
        if s["name"].startswith("chain."):
            steps = traj_steps if s["name"] == "chain.traj" else pose_steps
            assert [k["attrs"] for k in kids] == [{"t": t} for t in range(steps - 1, -1, -1)]
            assert all(k["name"] == "step" for k in kids)
        if s["name"] == "step":
            guides = log[s["parent"]]["name"] == "chain.pose" and s["attrs"]["t"] <= AMASS_SKATING_T_THRESH
            assert [k["name"] for k in kids] == (["guidance"] if guides else [])
        if s["name"] in ("guidance", "bridge"):
            assert kids == []
        if s["parent"] is not None:
            p = log[s["parent"]]
            assert p["host_start_ns"] <= s["host_start_ns"] <= s["host_end_ns"] <= p["host_end_ns"]
        # no card here: host stamps only, and no sync counter
        assert s["host_ns"] == s["host_end_ns"] - s["host_start_ns"] >= 0
        assert s["device_start_ns"] is s["device_end_ns"] is s["device_ns"] is s["syncs"] is None


def test_unrecorded_batch_records_nothing_and_gives_the_same_outputs(runs):
    _, recorded, plain, after = runs
    assert after == []
    assert all(torch.equal(a, b) for a, b in zip(recorded, plain))


def test_off_span_is_one_shared_no_op():
    assert profiling.span("step", "t", 3) is profiling.span("batch", root=True)
    with profiling.span("step", "t", 3) as s:
        assert s is None
    assert profiling.spans() == []


def test_reading_the_log():
    profiling.take_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer", "k", 1):
            with pytest.raises(RuntimeError, match="outer"):
                profiling.take_spans()
            with profiling.span("inner"):
                pass
    first = profiling.spans()
    assert [(s["name"], s["parent"], s["attrs"]) for s in first] == [("outer", None, {"k": 1}), ("inner", 0, {})]
    assert first[0]["root"] is None  # no root span: host stamps only
    assert profiling.spans() == first
    assert profiling.take_spans() == first and profiling.spans() == []


def test_spans_appear_in_the_chrome_trace(tmp_path):
    profiling.take_spans()
    with profiling.trace(str(tmp_path)):
        with profiling.span("batch", root=True):
            with profiling.span("step", "t", 0):
                torch.ones(8, 8) @ torch.ones(8, 8)
    (name,) = os.listdir(tmp_path)
    events = json.loads((tmp_path / name).read_text())["traceEvents"]
    assert {"batch", "step"} <= {e.get("name") for e in events}
    assert [s["name"] for s in profiling.take_spans()] == ["batch", "step"]


def test_step_observers_see_the_states_the_step_recorder_keeps(tiny_cell):
    """Every step of every chain of one batch: what an observer is handed
    equals what the benchmark's wrapper of p_sample_step keeps."""
    cell, drv, prog, batch = tiny_cell
    cfg = cell["config"]
    plan = {c: set(range(cfg["diffusion_steps_posenet"] if c % 2 else cfg["diffusion_steps_trajnet"]))
            for c in range(2 * cfg["sample_iter"])}
    seen, chain = {}, [-1]

    def observe(sched, t, x_t, x_prev, pred_x0):
        if t == sched.num_timesteps - 1:
            chain[0] += 1
        seen[(chain[0], t)] = (x_t.clone(), x_prev.clone(), None if pred_x0 is None else pred_x0.clone())

    sampler.step_observers.append(observe)
    try:
        with drv.StepRecorder() as rec:
            records, _ = rec.arm(plan)
            prog.run_batch(batch, torch.Generator().manual_seed(11))
            rec.disarm()
    finally:
        sampler.step_observers.remove(observe)
    assert sorted(seen) == sorted(records) == sorted((c, t) for c, ts in plan.items() for t in ts)
    guided = 0
    for key, kept in records.items():
        got = seen[key]
        assert torch.equal(got[0], kept[0]) and torch.equal(got[1], kept[1]), key
        assert (got[2] is None) == (kept[2] is None), key
        if kept[2] is not None:
            guided += 1
            assert torch.equal(got[2], kept[2]), key
    assert guided == cfg["sample_iter"] * (min(AMASS_SKATING_T_THRESH, cfg["diffusion_steps_posenet"] - 1) + 1)
