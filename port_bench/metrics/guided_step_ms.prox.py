"""The median device duration, in ms, of the guided PoseNet `step` spans
(those holding a `guidance` span: denoiser, both guidance terms, draw and
posterior step) in the traced batches (harness/guided.py)."""

from harness.guided import read as read_guided
from harness.spans import median_ms


def read(ctx: dict):
    tree = read_guided(ctx)
    return None if tree is None else median_ms([s["device_ns"] for s in tree["guided_steps"]])
