"""Diffusion: float64 schedules, the DDPM posterior and the guided sampler."""

from rohm_tpu_torch.diffusion.gaussian import p_mean_from_x0, q_sample
from rohm_tpu_torch.diffusion.sampler import GuidanceSpec, p_sample_loop
from rohm_tpu_torch.diffusion.schedule import DiffusionSchedule, make_schedule

__all__ = ["DiffusionSchedule", "make_schedule", "p_mean_from_x0", "q_sample", "GuidanceSpec", "p_sample_loop"]
