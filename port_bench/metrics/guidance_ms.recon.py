"""The median device duration, in ms, of the `guidance` spans
(rohm_tpu_torch.diffusion.sampler._guidance_shift at a step where a term
applies: the skating loss's autograd through SMPL-X) in the traced batches
(harness/spans.py)."""

from harness.spans import device_ms


def read(ctx: dict):
    return device_ms(ctx, "guidance")
