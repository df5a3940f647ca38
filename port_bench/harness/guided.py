"""The guided PoseNet steps of the traced window and the guidance terms
inside them, from the program's spans (`rohm_tpu_torch.utils.profiling
.spans()`), for the readers of the cells whose guidance has several terms.

Read only where harness/spans.py reads the log (its roots, chains and
forwards match the traced batches) and where the `guidance` spans number
ctx["guided_steps"], each under a `step` span of a `chain.pose` span. The
`guidance.term` spans (attribute `term`) are grouped by term; a program
without them gives no terms.
"""

from __future__ import annotations

from bisect import bisect_left
from collections import defaultdict

from harness.spans import read as read_spans


def read(ctx: dict) -> dict | None:
    """{"guided_steps", "guidance": lists of span records; "terms": {term:
    its guidance.term spans}}, or None where the log does not match."""
    if read_spans(ctx) is None:
        return None
    from rohm_tpu_torch.utils import profiling

    log = profiling.spans()
    guidance = [s for s in log if s["name"] == "guidance"]
    steps = [log[s["parent"]] for s in guidance]
    if len(guidance) != ctx["guided_steps"] or any(
            s["name"] != "step" or log[s["parent"]]["name"] != "chain.pose" for s in steps):
        return None
    terms = defaultdict(list)
    for s in log:
        if s["name"] == "guidance.term" and log[s["parent"]]["name"] == "guidance":
            terms[s["attrs"].get("term")].append(s)
    return {"guided_steps": steps, "guidance": guidance, "terms": dict(terms)}


def term_spans(ctx: dict, term: str) -> list | None:
    """The `guidance.term` spans of one term, where every guided step holds
    one; else None."""
    tree = read(ctx)
    if tree is None:
        return None
    spans = tree["terms"].get(term, [])
    return spans if len(spans) == len(tree["guided_steps"]) else None


def launches_inside(launch_ns: list, spans: list) -> int:
    """How many of the sorted host launch times fall in the spans' host
    ranges."""
    return sum(bisect_left(launch_ns, s["host_end_ns"]) - bisect_left(launch_ns, s["host_start_ns"]) for s in spans)
