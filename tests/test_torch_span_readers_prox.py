"""The PROX cell's six per-layer readers (port_bench/metrics/*.prox.py, the
span readers over port_bench/harness/guided.py) against hand-built span
logs and trace contexts: each one's value, and nothing read where the log
does not match the traced batches, where a guided step lacks a term's
span, or where the program has no spans."""

import sys
from pathlib import Path

import pytest

from rohm_tpu_torch.utils import profiling

BENCH = Path(__file__).resolve().parents[1] / "port_bench"
SPAN_READERS = ("guided_step_ms.prox", "proj2d_guidance_ms.prox", "skating_guidance_ms.prox",
                "guidance_launches_per_step.prox")
TRAJ_STEPS, POSE_STEPS, GUIDED = 3, 6, 2  # per chain; the last GUIDED pose steps are guided
TERMS = (("proj2d", 3), ("skating", 2))  # each guidance's terms, device ms
LAUNCHES_IN_GUIDANCE = 4
MS = 1_000_000  # ns


def reader(name: str):
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from harness import spec

    return spec.load_module(BENCH / "metrics" / f"{name}.py")


def build_log(batches=2, iters=2, terms=TERMS):
    """Span records as profiling.spans() gives them, with the host launch
    times: a traj step 2 ms on the card, an unguided pose step 4 ms, a
    guided one 10 ms (12 ms every other) holding a guidance span of 6 ms
    with `terms`; LAUNCHES_IN_GUIDANCE launches inside each guidance span's
    host range and one inside every step's, outside it."""
    log, launches = [], []

    def add(name, parent, host_ns, dev_ns, attrs=None):
        start = 10 * MS * len(log)
        log.append({"name": name, "parent": parent, "root": parent if parent is None else log[parent]["root"],
                    "attrs": attrs or {}, "host_start_ns": start, "host_end_ns": start + host_ns,
                    "host_ns": host_ns, "device_start_ns": start + MS, "device_end_ns": start + MS + dev_ns,
                    "device_ns": dev_ns, "syncs": None})
        if parent is None:
            log[-1]["root"], log[-1]["syncs"] = len(log) - 1, 3
        return len(log) - 1

    for _ in range(batches):
        root = add("batch", None, 500 * MS, 500 * MS)
        for i in range(iters):
            chain = add("chain.traj", root, 100 * MS, 100 * MS, {"iteration": i})
            for t in range(TRAJ_STEPS - 1, -1, -1):
                add("step", chain, MS, 2 * MS, {"t": t})
            add("bridge", root, MS, MS)
            chain = add("chain.pose", root, 100 * MS, 100 * MS, {"iteration": i})
            for t in range(POSE_STEPS - 1, -1, -1):
                if t >= GUIDED:
                    add("step", chain, MS, 4 * MS, {"t": t})
                    continue
                step = add("step", chain, 8 * MS, (12 if t % 2 else 10) * MS, {"t": t})
                launches.append(log[step]["host_start_ns"] + 1)
                g = add("guidance", step, 5 * MS, 6 * MS)
                launches += [log[g]["host_start_ns"] + k for k in range(1, LAUNCHES_IN_GUIDANCE + 1)]
                for term, dev_ms in terms:
                    add("guidance.term", g, MS, dev_ms * MS, {"term": term})
    return log, sorted(launches)


def ctx(launches, batches=2, iters=2):
    return {"batches": batches, "forwards": batches * iters * POSE_STEPS,
            "guided_steps": batches * iters * GUIDED, "launch_ns": launches}


WANT = {"guided_step_ms.prox": 11.0, "proj2d_guidance_ms.prox": 3.0, "skating_guidance_ms.prox": 2.0,
        "guidance_launches_per_step.prox": float(LAUNCHES_IN_GUIDANCE)}


@pytest.mark.parametrize("name", SPAN_READERS)
def test_value(name, monkeypatch):
    log, launches = build_log()
    monkeypatch.setattr(profiling, "spans", lambda: log)
    assert reader(name).read(ctx(launches)) == pytest.approx(WANT[name])


def _without_terms(log):
    """The log with every guidance.term span renamed (no index moves): a
    program whose guidance has no term spans."""
    return [dict(s, name="other") if s["name"] == "guidance.term" else s for s in log]


def _one_term_renamed(log):
    i = next(i for i, s in enumerate(log) if s["name"] == "guidance.term" and s["attrs"]["term"] == "proj2d")
    return log[:i] + [dict(log[i], attrs={"term": "other"})] + log[i + 1:]


# each a (log, ctx) with one thing that does not match
MISMATCHES = {
    "roots": lambda log, launches: (log, dict(ctx(launches), batches=1)),
    "forwards": lambda log, launches: (log, dict(ctx(launches), forwards=ctx(launches)["forwards"] + 1)),
    "guided_steps": lambda log, launches: (log, dict(ctx(launches), guided_steps=ctx(launches)["guided_steps"] - 1)),
}


@pytest.mark.parametrize("mismatch", sorted(MISMATCHES))
@pytest.mark.parametrize("name", SPAN_READERS)
def test_nothing_read_on_a_mismatch(name, mismatch, monkeypatch):
    log, c = MISMATCHES[mismatch](*build_log())
    monkeypatch.setattr(profiling, "spans", lambda: log)
    assert reader(name).read(c) is None


@pytest.mark.parametrize("name", ("proj2d_guidance_ms.prox", "skating_guidance_ms.prox"))
def test_no_term_read_without_term_spans(name, monkeypatch):
    """A program without term spans (one older than them) gives no term
    readings; its guided steps and launches are still read."""
    log, launches = build_log()
    monkeypatch.setattr(profiling, "spans", lambda: _without_terms(log))
    assert reader(name).read(ctx(launches)) is None
    assert reader("guided_step_ms.prox").read(ctx(launches)) == pytest.approx(WANT["guided_step_ms.prox"])


def test_no_term_read_where_a_guided_step_lacks_it(monkeypatch):
    log, launches = build_log()
    monkeypatch.setattr(profiling, "spans", lambda: _one_term_renamed(log))
    assert reader("proj2d_guidance_ms.prox").read(ctx(launches)) is None
    assert reader("skating_guidance_ms.prox").read(ctx(launches)) == pytest.approx(2.0)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_nothing_read_from_a_program_without_spans(name, monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    assert reader(name).read(ctx(build_log()[1])) is None


def test_no_launches_read_without_launch_times(monkeypatch):
    log, _ = build_log()
    monkeypatch.setattr(profiling, "spans", lambda: log)
    assert reader("guidance_launches_per_step.prox").read(ctx([])) is None


def test_mfu_and_idle():
    trace = {"window_s": 20.0, "busy_s": 15.0}
    c = {"trace": trace, "batches": 2, "least_batch_s": 3.0}
    assert reader("mfu.prox").read(c) == pytest.approx(30.0)
    assert reader("device_idle.prox").read(c) == pytest.approx(0.25)
    empty = {"trace": {"window_s": 0.0, "busy_s": 0.0}, "batches": 0, "least_batch_s": 3.0}
    assert reader("mfu.prox").read(empty) is None and reader("device_idle.prox").read(empty) is None
