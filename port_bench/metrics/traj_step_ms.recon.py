"""The median device duration, in ms, of the `step` spans under the
`chain.traj` spans (rohm_tpu_torch.diffusion.sampler.p_sample_loop's steps
of TrajNet and TrajControl: denoiser, draw and posterior step) in the
traced batches (harness/spans.py)."""

from harness.spans import device_ms


def read(ctx: dict):
    return device_ms(ctx, "traj_steps")
