"""DDPM core math (x0-prediction, FIXED_SMALL variance).

The port of rohm_tpu/diffusion/gaussian.py: forward noising for training
(`q_sample`, `t` a per-sample [B] tensor) and the posterior the sampling
loop uses (`t` one Python int for the whole batch, as in the reference loop
gaussian_diffusion_trajnet.py:611-612).
"""

from __future__ import annotations

import torch

from rohm_tpu_torch.diffusion.schedule import DiffusionSchedule


def q_sample(
    sched: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor
) -> torch.Tensor:
    """Sample q(x_t | x_0) for per-sample timesteps t [B] (reference
    gaussian_diffusion_trajnet.py:192-210)."""
    shape = t.shape + (1,) * (x_start.dim() - t.dim())
    return (
        sched.sqrt_alphas_cumprod[t].reshape(shape) * x_start
        + sched.sqrt_one_minus_alphas_cumprod[t].reshape(shape) * noise
    )


def q_posterior_mean(
    sched: DiffusionSchedule, x_start: torch.Tensor, x_t: torch.Tensor, t: int
) -> torch.Tensor:
    """Mean of q(x_{t-1} | x_t, x_0) (reference :212-234)."""
    return sched.posterior_mean_coef1[t] * x_start + sched.posterior_mean_coef2[t] * x_t


def p_mean_from_x0(
    sched: DiffusionSchedule, pred_xstart: torch.Tensor, x_t: torch.Tensor, t: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, variance, log_variance) of p(x_{t-1} | x_t) given predicted x0."""
    mean = q_posterior_mean(sched, pred_xstart, x_t, t)
    return mean, sched.posterior_variance[t], sched.posterior_log_variance_clipped[t]
