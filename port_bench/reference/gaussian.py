"""DDPM core math (x0-prediction, FIXED_SMALL variance).

A frozen copy of rohm_tpu_torch/diffusion/gaussian.py's sampling side: the
posterior the sampling loop uses and one reverse step (`t` one Python int for the whole batch, as in
the reference loop gaussian_diffusion_trajnet.py:611-612).
"""

from __future__ import annotations

import torch

from .schedule import DiffusionSchedule


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


def p_sample_step(
    sched: DiffusionSchedule,
    pred_xstart: torch.Tensor,
    x_t: torch.Tensor,
    t: int,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    mean_shift: torch.Tensor | float = 0.0,
) -> torch.Tensor:
    """One reverse step: x_{t-1} ~ N(mean + mean_shift, sigma_t^2 I).

    The step's noise is `noise` if given, else a draw from `generator` on
    x_t's device (the JAX version's key). mean_shift carries the guidance
    term (weight * variance * grad); no noise is added at t == 0 (reference
    :430-437).
    """
    mean, _, log_var = p_mean_from_x0(sched, pred_xstart, x_t, t)
    if isinstance(mean_shift, torch.Tensor) or mean_shift != 0:
        mean = mean + mean_shift  # no launch for the unguided step
    if t == 0:
        return mean
    if noise is None:
        noise = torch.randn(x_t.shape, generator=generator, device=x_t.device, dtype=x_t.dtype)
    return mean + torch.exp(0.5 * log_var) * noise
