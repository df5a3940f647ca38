"""The median device duration, in ms, of the `guidance.term` spans with
`term` "skating" (the foot skating loss through SMPL-X and its autograd)
in the traced batches (harness/guided.py); nothing where a guided step
lacks one."""

from harness.guided import term_spans
from harness.spans import median_ms


def read(ctx: dict):
    spans = term_spans(ctx, "skating")
    return None if spans is None else median_ms([s["device_ns"] for s in spans])
