"""The median, over the unguided `step` spans under the `chain.pose` spans
in the traced batches, of the span's device start stamp minus its host
start stamp, in ms (harness/spans.py): how far ahead of the card the host
was when it began the step. Near 0, the card had drained its queue and
waited for the host at that step."""

from harness.spans import median_ms, read as read_spans


def read(ctx: dict):
    tree = read_spans(ctx)
    if tree is None:
        return None
    steps = tree["unguided_pose_steps"]
    if any(s["device_start_ns"] is None for s in steps):
        return None
    return median_ms([s["device_start_ns"] - s["host_start_ns"] for s in steps])
