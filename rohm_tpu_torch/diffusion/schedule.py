"""Beta schedules + timestep respacing, computed in float64 numpy on the host.

The port of rohm_tpu/diffusion/schedule.py: the same float64 table math
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


def space_timesteps(num_timesteps: int, section_counts) -> set:
    """Subset of original timesteps for respaced sampling ('ddimN' or counts)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return set(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        frac_stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start_idx + round(cur))
            cur += frac_stride
        start_idx += size
    return set(all_steps)


@dataclass(frozen=True)
class DiffusionSchedule:
    """All precomputed schedule tables, float32 tensors on one device.

    When respaced, `timestep_map[i]` is the original timestep the model is
    conditioned on for internal step i (reference respace.py:183-195).
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
    timestep_respacing: str = "",
    scale_betas: float = 1.0,
    device="cpu",
    dtype=torch.float32,
) -> DiffusionSchedule:
    """Build an (optionally respaced) schedule; all math in float64 on the host."""
    base_betas = get_named_beta_schedule(schedule_name, num_diffusion_timesteps, scale_betas)

    if timestep_respacing:
        use = space_timesteps(num_diffusion_timesteps, timestep_respacing)
        last = 1.0
        betas_list, tmap = [], []
        for i, ac in enumerate(np.cumprod(1.0 - base_betas)):
            if i in use:
                betas_list.append(1 - ac / last)
                last = ac
                tmap.append(i)
        betas = np.array(betas_list, dtype=np.float64)
        timestep_map = np.array(tmap, dtype=np.int64)
    else:
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
