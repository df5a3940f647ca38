"""Diffusion: float64 schedules, the DDPM posterior, the guided sampler and DDIM."""

from rohm_tpu_torch.diffusion.gaussian import p_mean_from_x0, p_sample_step, q_posterior_mean, q_sample
from rohm_tpu_torch.diffusion.sampler import GuidanceSpec, ddim_sample_loop, p_sample_loop
from rohm_tpu_torch.diffusion.schedule import (
    DiffusionSchedule,
    get_named_beta_schedule,
    make_schedule,
    space_timesteps,
)

__all__ = [
    "DiffusionSchedule",
    "get_named_beta_schedule",
    "make_schedule",
    "space_timesteps",
    "p_mean_from_x0",
    "p_sample_step",
    "q_posterior_mean",
    "q_sample",
    "GuidanceSpec",
    "p_sample_loop",
    "ddim_sample_loop",
]
