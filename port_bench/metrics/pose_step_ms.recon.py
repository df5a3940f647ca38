"""The median device duration, in ms, of the unguided `step` spans under
the `chain.pose` spans (PoseNet's steps without a `guidance` span inside:
denoiser, draw and posterior step) in the traced batches
(harness/spans.py)."""

from harness.spans import device_ms


def read(ctx: dict):
    return device_ms(ctx, "unguided_pose_steps")
