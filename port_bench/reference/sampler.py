"""The reverse diffusion chain with test-time guidance, plain PyTorch.

A frozen copy of rohm_tpu_torch/diffusion/sampler.py's p_sample_loop
(single process, no respacing of the draws): x_T and then one normal draw
of the whole batch per step, from `generator`, in the order the port draws
them, so a generator seeded alike replays the port's noise.

Each `GuidanceSpec` adds `weight * posterior_variance[t] * (-grad loss(pred_x0))`
to the posterior mean, the gradient taken on a detached copy of pred_x0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from .gaussian import p_sample_step
from .schedule import DiffusionSchedule


@dataclass(frozen=True)
class GuidanceSpec:
    """One test-time guidance term: loss_fn(x) -> scalar, differentiated
    wrt the model's pred_x0; grad_mask zeroes protected dims."""

    loss_fn: Callable[[torch.Tensor], torch.Tensor]
    weight: float
    t_threshold: int
    grad_mask: torch.Tensor | None = None


def _guidance_shift(guidance, pred_x0: torch.Tensor, t: int, var: torch.Tensor):
    shift = None
    for spec in guidance:
        if t > spec.t_threshold:
            continue
        x0 = pred_x0.detach().requires_grad_()
        with torch.enable_grad():
            (grad,) = torch.autograd.grad(spec.loss_fn(x0), x0)
        g = -grad
        if spec.grad_mask is not None:
            g = g * spec.grad_mask
        term = spec.weight * var * g
        shift = term if shift is None else shift + term
    return shift


def p_sample_loop(model_fn: Callable[[torch.Tensor, int], torch.Tensor], sched: DiffusionSchedule,
                  shape: tuple, generator: torch.Generator, guidance: tuple = ()) -> torch.Tensor:
    """The full reverse chain from t = T-1 to 0; model_fn(x_t, t) -> pred_x0."""
    device = generator.device

    def randn():
        return torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)

    tmap = sched.timestep_map.tolist()
    x = randn()
    for t in range(sched.num_timesteps - 1, -1, -1):
        pred_x0 = model_fn(x, tmap[t])
        shift = _guidance_shift(guidance, pred_x0, t, sched.posterior_variance[t]) if guidance else None
        x = p_sample_step(sched, pred_x0, x, t, noise=randn(), mean_shift=0.0 if shift is None else shift)
    return x
