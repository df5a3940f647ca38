"""The program's spans of the traced window (`rohm_tpu_torch.utils.profiling`
.spans(): every span the port recorded while the window's profiler ran,
left in the log so that each reader sees the same spans), checked against
the traced batches and grouped for the per-layer readers.

The log is read only where it holds what the traced batches make: exactly
ctx["batches"] roots, all `batch`; `step` spans under `chain.pose`
numbering ctx["forwards"]; and `chain.traj` spans that all hold the same
number of `step` spans. A program without spans (one older than them)
gives nothing to read.
"""

from __future__ import annotations

import statistics
from collections import defaultdict


def read(ctx: dict) -> dict | None:
    """{"roots", "traj_steps", "pose_steps", "unguided_pose_steps",
    "guidance"}: lists of span records, or None where the log does not
    match the traced batches."""
    from rohm_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    log = spans()
    kids = defaultdict(list)
    for i, s in enumerate(log):
        kids[s["parent"]].append(i)
    roots = [log[i] for i in kids[None]]
    if len(roots) != ctx["batches"] or any(r["name"] != "batch" for r in roots):
        return None

    def steps_under(chain: str) -> list[list[int]]:
        return [[j for j in kids[i] if log[j]["name"] == "step"] for i, s in enumerate(log) if s["name"] == chain]

    traj = steps_under("chain.traj")
    if not traj or len({len(steps) for steps in traj}) != 1:
        return None
    pose = [j for steps in steps_under("chain.pose") for j in steps]
    if len(pose) != ctx["forwards"]:
        return None
    guided = {s["parent"] for s in log if s["name"] == "guidance"}
    return {"roots": roots, "traj_steps": [log[j] for steps in traj for j in steps],
            "pose_steps": [log[j] for j in pose], "unguided_pose_steps": [log[j] for j in pose if j not in guided],
            "guidance": [s for s in log if s["name"] == "guidance"]}


def median_ms(values: list) -> float | None:
    """The median of nanosecond values in ms; None where there are none or
    any is missing (a span without device stamps)."""
    if not values or any(v is None for v in values):
        return None
    return statistics.median(values) * 1e-6


def device_ms(ctx: dict, group: str) -> float | None:
    """The median device duration of one group's spans, in ms."""
    tree = read(ctx)
    return None if tree is None else median_ms([s["device_ns"] for s in tree[group]])
