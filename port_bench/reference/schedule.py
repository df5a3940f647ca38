"""Beta schedules, computed in float64 numpy on the host.

A frozen copy of rohm_tpu_torch/diffusion/schedule.py without respacing:
the same float64 table math
(guided-diffusion's definitions), moved to float32 tensors on one device at
the end, as the JAX package does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


def get_named_beta_schedule(
    schedule_name: str, num_diffusion_timesteps: int, scale_betas: float = 1.0
) -> np.ndarray:
    """'linear' (Ho et al., rescaled to any T) or 'cosine' (Nichol & Dhariwal)."""
    if schedule_name == "linear":
        scale = scale_betas * 1000 / num_diffusion_timesteps
        return np.linspace(
            scale * 0.0001, scale * 0.02, num_diffusion_timesteps, dtype=np.float64
        )
    if schedule_name == "cosine":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        n = num_diffusion_timesteps
        betas = [min(1 - alpha_bar((i + 1) / n) / alpha_bar(i / n), 0.999) for i in range(n)]
        return np.array(betas, dtype=np.float64)
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


@dataclass(frozen=True)
class DiffusionSchedule:
    """All precomputed schedule tables, float32 tensors on one device.

    """

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    timestep_map: torch.Tensor  # [num_timesteps] int64
    num_timesteps: int


def make_schedule(
    schedule_name: str = "cosine",
    num_diffusion_timesteps: int = 1000,
    scale_betas: float = 1.0,
    device="cpu",
    dtype=torch.float32,
) -> DiffusionSchedule:
    """Build a schedule; all math in float64 on the host."""
    base_betas = get_named_beta_schedule(schedule_name, num_diffusion_timesteps, scale_betas)

    betas = base_betas
    timestep_map = np.arange(num_diffusion_timesteps, dtype=np.int64)

    if not ((betas > 0).all() and (betas <= 1).all()):
        raise ValueError("betas must lie in (0, 1]")
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.append(1.0, ac[:-1])

    posterior_variance = betas * (1.0 - ac_prev) / (1.0 - ac)
    posterior_log_variance_clipped = np.log(
        np.append(posterior_variance[1], posterior_variance[1:])
    )
    c1 = betas * np.sqrt(ac_prev) / (1.0 - ac)
    c2 = (1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac)

    def as_dev(a):
        return torch.as_tensor(np.asarray(a, np.float64).astype(np.float32), device=device).to(dtype)

    return DiffusionSchedule(
        betas=as_dev(betas),
        alphas_cumprod=as_dev(ac),
        alphas_cumprod_prev=as_dev(ac_prev),
        sqrt_alphas_cumprod=as_dev(np.sqrt(ac)),
        sqrt_one_minus_alphas_cumprod=as_dev(np.sqrt(1.0 - ac)),
        sqrt_recip_alphas_cumprod=as_dev(np.sqrt(1.0 / ac)),
        sqrt_recipm1_alphas_cumprod=as_dev(np.sqrt(1.0 / ac - 1)),
        posterior_variance=as_dev(posterior_variance),
        posterior_log_variance_clipped=as_dev(posterior_log_variance_clipped),
        posterior_mean_coef1=as_dev(c1),
        posterior_mean_coef2=as_dev(c2),
        timestep_map=torch.as_tensor(timestep_map, device=device),
        num_timesteps=len(betas),
    )
