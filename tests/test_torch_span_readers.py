"""The benchmark's five span readers (port_bench/metrics/*.py over
port_bench/harness/spans.py) against hand-built span logs: each one's
value, and nothing read where the log does not match the traced batches
or the program has no spans."""

import sys
from pathlib import Path

import pytest

from rohm_tpu_torch.utils import profiling

BENCH = Path(__file__).resolve().parents[1] / "port_bench"
READERS = ("traj_step_ms.recon", "pose_step_ms.recon", "guidance_ms.recon", "pose_step_lead_ms.recon",
           "host_syncs_per_batch.recon")
TRAJ_STEPS, POSE_STEPS, GUIDED = 3, 6, 2  # per chain; the last GUIDED pose steps are guided
MS = 1_000_000  # ns


def reader(name: str):
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from harness import spec

    return spec.load_module(BENCH / "metrics" / f"{name}.py")


def build_log(batches=2, iters=2, traj_steps=(TRAJ_STEPS, TRAJ_STEPS), syncs=(4, 6)):
    """Span records as profiling.spans() gives them. Device durations: a
    traj step 2 ms, an unguided pose step 4 ms (8 ms for every third), a
    guided one 10 ms with guidance 6 ms; every step's device start lies
    1 ms (unguided pose steps: 3 ms) after its host start; batch k's root
    counted syncs[k] synchronisations."""
    log = []

    def add(name, parent, host_ns, dev_ns, lead_ns=MS, attrs=None):
        start = 10 * MS * len(log)
        log.append({"name": name, "parent": parent, "root": parent if parent is None else log[parent]["root"],
                    "attrs": attrs or {}, "host_start_ns": start, "host_end_ns": start + host_ns,
                    "host_ns": host_ns, "device_start_ns": start + lead_ns,
                    "device_end_ns": start + lead_ns + dev_ns, "device_ns": dev_ns, "syncs": None})
        if parent is None:
            log[-1]["root"], log[-1]["syncs"] = len(log) - 1, syncs[k]
        return len(log) - 1

    for k in range(batches):
        root = add("batch", None, 500 * MS, 500 * MS, 0)
        for i in range(iters):
            chain = add("chain.traj", root, 100 * MS, 100 * MS, 0, {"iteration": i})
            for t in range(traj_steps[i] - 1, -1, -1):
                add("step", chain, MS, 2 * MS, attrs={"t": t})
            add("bridge", root, MS, MS)
            chain = add("chain.pose", root, 100 * MS, 100 * MS, 0, {"iteration": i})
            for t in range(POSE_STEPS - 1, -1, -1):
                if t < GUIDED:
                    step = add("step", chain, MS, 10 * MS, attrs={"t": t})
                    add("guidance", step, MS, 6 * MS)
                else:
                    add("step", chain, MS, (8 if t % 3 == 0 else 4) * MS, 3 * MS, {"t": t})
    return log


def ctx(batches=2, iters=2):
    return {"batches": batches, "forwards": batches * iters * POSE_STEPS}


WANT = {"traj_step_ms.recon": 2.0, "pose_step_ms.recon": 4.0, "guidance_ms.recon": 6.0,
        "pose_step_lead_ms.recon": 3.0, "host_syncs_per_batch.recon": 5.0}


@pytest.mark.parametrize("name", READERS)
def test_value(name, monkeypatch):
    log = build_log()
    monkeypatch.setattr(profiling, "spans", lambda: log)
    assert reader(name).read(ctx()) == pytest.approx(WANT[name])


def _renamed(log, pick):
    """The log with the first span `pick` accepts renamed (no index moves)."""
    i = next(i for i, s in enumerate(log) if pick(log, s))
    log[i] = dict(log[i], name="other")
    return log


def _unguided_pose_step(log, s):
    return s["name"] == "step" and log[s["parent"]]["name"] == "chain.pose" and s["attrs"]["t"] >= GUIDED


def _no_device_stamps(log):
    return [dict(s, device_start_ns=None, device_end_ns=None, device_ns=None, syncs=None) for s in log]


# each a (log, ctx) with one thing that does not match
MISMATCHES = {
    "roots": lambda: (build_log(), dict(ctx(), batches=1)),
    "root_name": lambda: (_renamed(build_log(), lambda log, s: s["name"] == "batch"), ctx()),
    "pose_steps": lambda: (_renamed(build_log(), _unguided_pose_step), ctx()),
    "traj_chains": lambda: (build_log(traj_steps=(TRAJ_STEPS, TRAJ_STEPS + 1)), ctx()),
    "no_device_stamps": lambda: (_no_device_stamps(build_log()), ctx()),
}


@pytest.mark.parametrize("mismatch", sorted(MISMATCHES))
@pytest.mark.parametrize("name", READERS)
def test_nothing_read_on_a_mismatch(name, mismatch, monkeypatch):
    log, c = MISMATCHES[mismatch]()
    monkeypatch.setattr(profiling, "spans", lambda: log)
    assert reader(name).read(c) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_read_from_a_program_without_spans(name, monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    assert reader(name).read(ctx()) is None


def test_a_log_with_one_iteration_per_batch_is_read(monkeypatch):
    log = build_log(iters=1, traj_steps=(TRAJ_STEPS,))
    monkeypatch.setattr(profiling, "spans", lambda: log)
    assert reader("traj_step_ms.recon").read(ctx(iters=1)) == pytest.approx(2.0)
