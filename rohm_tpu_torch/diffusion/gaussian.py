"""DDPM posterior math (x0-prediction, FIXED_SMALL variance).

The port of rohm_tpu/diffusion/gaussian.py's sampling half. Inside the
sampling loop `t` is one Python int for the whole batch, as in the
reference loop (gaussian_diffusion_trajnet.py:611-612).
"""

from __future__ import annotations

import torch

from rohm_tpu_torch.diffusion.schedule import DiffusionSchedule


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
