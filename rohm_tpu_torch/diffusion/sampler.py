"""The reverse diffusion chain with test-time guidance, in eager PyTorch.

The port of rohm_tpu/diffusion/sampler.py: p_sample_loop, and
ddim_sample_loop for 'ddimN'-respaced schedules. The JAX version
runs the chain as two `lax.scan` segments split at the highest guidance
threshold, with a `lax.cond` gate inside the lower one; here a Python loop
does the same steps and the gate is `if t <= threshold`, so the steps above
the highest threshold run no guidance code at all.

Each `GuidanceSpec` adds `weight * posterior_variance[t] * (-grad loss(pred_x0))`
to the posterior mean, the gradient taken with torch.autograd.grad on a
detached copy of pred_x0.

Each step of p_sample_loop is a `step` span (utils/profiling.py), and the
guidance at a step where a term applies a `guidance` span inside it. After
each step's posterior step, every callable in `step_observers` is called
with (sched, t, x_t, x_{t-1}, pred_x0 if the step was guided else None).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from rohm_tpu_torch.diffusion.gaussian import p_sample_step
from rohm_tpu_torch.diffusion.schedule import DiffusionSchedule
from rohm_tpu_torch.parallel.mesh import DataMesh, draw_rows
from rohm_tpu_torch.utils.profiling import span

# called after every step of p_sample_loop (see the module docstring)
step_observers: list[Callable] = []


@dataclass(frozen=True)
class GuidanceSpec:
    """One test-time guidance term.

    loss_fn(x [*shape]) -> scalar; differentiated wrt the model's pred_x0.
    grad_mask zeroes protected dims (traj + contact labels in RoHM).
    """

    loss_fn: Callable[[torch.Tensor], torch.Tensor]
    weight: float
    t_threshold: int
    grad_mask: torch.Tensor | None = None


def _guidance_shift(guidance, pred_x0: torch.Tensor, t: int, var: torch.Tensor):
    # thresholds compare the INTERNAL (spaced) step index, as the
    # reference does; timestep_map remaps t for the model call only
    if all(t > spec.t_threshold for spec in guidance):
        return None
    shift = None
    with span("guidance"):
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


def p_sample_loop(
    model_fn: Callable[[torch.Tensor, int], torch.Tensor],
    sched: DiffusionSchedule,
    shape: tuple,
    generator: torch.Generator,
    noise: torch.Tensor | None = None,
    guidance: tuple[GuidanceSpec, ...] = (),
    early_stop_steps: int = 0,
    dtype=torch.float32,
    step_noise: torch.Tensor | None = None,
    mesh: DataMesh | None = None,
) -> torch.Tensor:
    """Run the full reverse chain.

    Args:
      model_fn(x_t, t) -> pred_x0, where t is the (respacing-mapped) original
        timestep as a Python int.
      shape: sample shape (B, T, D).
      generator: torch.Generator on the device the chain runs on; draws x_T
        (unless `noise` is given) and then one normal sample per step.
      noise: optional fixed x_T.
      guidance: guidance terms (see GuidanceSpec).
      early_stop_steps: truncate the chain this many steps before t=0 and
        return the last pred_x0 instead of the stochastic sample.
      step_noise: optional preset per-step noise [num_timesteps, *shape],
        indexed by internal timestep t (deterministic replay).
      mesh: a data-parallel mesh; shape (and noise, step_noise) are this
        rank's rows, and every draw is taken at the global batch and sliced
        (parallel.draw_rows), so the chain is the single-process one.

    Returns: final sample [B, T, D] (or final pred_x0 when early stopping).
    """
    device = generator.device

    def randn(shape):
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)

    num_steps = sched.num_timesteps - early_stop_steps
    t_hi = sched.num_timesteps - 1
    t_lo = sched.num_timesteps - num_steps
    tmap = sched.timestep_map.tolist()

    if noise is None:
        x = draw_rows(randn, shape, mesh)
    else:
        x = noise.to(device=device, dtype=dtype)
    pred_x0 = x
    for t in range(t_hi, t_lo - 1, -1):
        with span("step", "t", t):
            pred_x0 = model_fn(x, tmap[t])
            shift = _guidance_shift(guidance, pred_x0, t, sched.posterior_variance[t]) if guidance else None
            if step_noise is not None:
                noise_t = step_noise[t].to(device=device, dtype=dtype)
            else:
                noise_t = draw_rows(randn, shape, mesh)
            x_prev = p_sample_step(sched, pred_x0, x, t, noise=noise_t, mean_shift=0.0 if shift is None else shift)
        if step_observers:
            for observe in step_observers:
                observe(sched, t, x, x_prev, None if shift is None else pred_x0)
        x = x_prev
    if early_stop_steps > 0:
        return pred_x0
    return x


def ddim_sample_loop(
    model_fn: Callable[[torch.Tensor, int], torch.Tensor],
    sched: DiffusionSchedule,
    shape: tuple,
    generator: torch.Generator,
    eta: float = 0.0,
    noise: torch.Tensor | None = None,
    dtype=torch.float32,
    step_noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """The DDIM reverse chain (rohm_tpu/diffusion/sampler.py::ddim_sample_loop;
    the reference's ddim loops of gaussian_diffusion_*.py), for a schedule
    respaced with 'ddimN' (make_schedule(..., timestep_respacing="ddimN")).

    eta = 0 is deterministic. The generator draws x_T (unless `noise` is
    given) and then, only when eta > 0, one normal sample per step (unless
    `step_noise` [num_timesteps, *shape], indexed by internal timestep,
    replays them). model_fn(x_t, t) -> pred_x0 as in p_sample_loop.
    """
    device = generator.device
    tmap = sched.timestep_map.tolist()
    if noise is None:
        x = torch.randn(shape, generator=generator, device=device, dtype=dtype)
    else:
        x = noise.to(device=device, dtype=dtype)
    for t in range(sched.num_timesteps - 1, -1, -1):
        pred_x0 = model_fn(x, tmap[t])
        eps = (sched.sqrt_recip_alphas_cumprod[t] * x - pred_x0) / sched.sqrt_recipm1_alphas_cumprod[t]
        acp, acp_prev = sched.alphas_cumprod[t], sched.alphas_cumprod_prev[t]
        sigma = eta * torch.sqrt((1 - acp_prev) / (1 - acp)) * torch.sqrt(1 - acp / acp_prev)
        x = torch.sqrt(acp_prev) * pred_x0 + torch.sqrt(torch.clamp(1.0 - acp_prev - sigma**2, min=0.0)) * eps
        if eta > 0:
            if step_noise is not None:
                noise_t = step_noise[t].to(device=device, dtype=dtype)
            else:
                noise_t = torch.randn(shape, generator=generator, device=device, dtype=dtype)
            if t != 0:
                x = x + sigma * noise_t
    return x
