"""PoseNet training and eval-sampling steps.

The port of rohm_tpu/train/steps.py (its PoseNet half; reference
gaussian_diffusion_posenet.py:892-910 through model/posenet.py:99-193).
One optimizer step: uniform timesteps, full-294-d q_sample, the model's
train-mode forward, SMPL-X-in-the-loop losses, backward, AdamW. The JAX
package jits it into one program; here it runs eagerly, and with
`fused_train` the encoder layers run through the hand-written CUDA
forward and backward kernels (ops/transformer_layer_train.py).

Randomness: t, the q_sample noise and every dropout mask are drawn on the
device from one torch.Generator, in the order t, noise, masks.
"""

from __future__ import annotations

from typing import Callable

import torch

from rohm_tpu_torch.body.model import SmplxModel
from rohm_tpu_torch.diffusion.gaussian import q_sample
from rohm_tpu_torch.diffusion.sampler import p_sample_loop
from rohm_tpu_torch.diffusion.schedule import DiffusionSchedule
from rohm_tpu_torch.models.losses import posenet_losses
from rohm_tpu_torch.ops.transformer_layer_train import posenet_apply_train, posenet_dropout_masks
from rohm_tpu_torch.train.state import TrainState


def make_posenet_grads_fn(
    model,
    sched: DiffusionSchedule,
    mean: torch.Tensor,
    std: torch.Tensor,
    body_model: SmplxModel,
    loss_weights: dict,
    fused_train: str = "",
) -> Callable:
    """grads_and_losses(model, batch, t, noise, dropout, skating_active)
    -> (grads, loss_dict).

    The exact per-step training math with t [B] and the q_sample noise as
    explicit inputs. `dropout` is a torch.Generator the masks are drawn
    from, or the masks themselves (posenet_dropout_masks' structure), so a
    caller can hand in masks made elsewhere. The gradients are left in the
    parameters' `.grad` (zeroed first) and returned by parameter name;
    the losses come back detached.

    fused_train: "" runs PoseNet.forward_train under autograd; "bfloat16" /
    "float32" runs the encoder stack through the CUDA training layers with
    that GEMM operand mode (the same math, a hand-written backward).
    """
    if fused_train not in ("", "bfloat16", "float32"):
        raise ValueError(f"fused_train must be '', 'bfloat16' or 'float32', got {fused_train!r}")

    def grads_and_losses(model, batch: dict, t: torch.Tensor, noise: torch.Tensor, dropout,
                         skating_active):
        clean = batch["motion_repr_clean"]
        cond = batch["cond"]
        masks = dropout
        if isinstance(dropout, torch.Generator):
            masks = posenet_dropout_masks(dropout, model, clean.shape[0], clean.shape[1])
        x_t = q_sample(sched, clean, t, noise)
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            if fused_train:
                out = posenet_apply_train(model, x_t, cond, t, masks, fused_train)
            else:
                out = model.forward_train(x_t, cond, t, masks)
            losses = posenet_losses(out, clean, mean, std, body_model, loss_weights,
                                    skating_active=skating_active)
            losses["loss"].backward()
        grads = {name: p.grad for name, p in model.named_parameters()}
        return grads, {k: v.detach() for k, v in losses.items()}

    return grads_and_losses


def make_posenet_train_step(
    model,
    sched: DiffusionSchedule,
    mean: torch.Tensor,
    std: torch.Tensor,
    body_model: SmplxModel,
    loss_weights: dict,
    fused_train: str = "",
) -> Callable:
    """step(state, batch, generator, skating_active) -> (state, loss_dict).

    batch: motion_repr_clean [B, T, 294], cond [B, T, 294] (masked), on the
    device of `generator`. skating_active gates the foot-skating loss
    (start_skating_loss_epoch)."""
    grads_and_losses = make_posenet_grads_fn(
        model, sched, mean, std, body_model, loss_weights, fused_train
    )

    def step(state: TrainState, batch: dict, generator: torch.Generator, skating_active):
        clean = batch["motion_repr_clean"]
        dev = generator.device
        t = torch.randint(0, sched.num_timesteps, (clean.shape[0],), generator=generator, device=dev)
        noise = torch.randn(clean.shape, generator=generator, device=dev, dtype=clean.dtype)
        _, losses = grads_and_losses(state.model, batch, t, noise, generator, skating_active)
        return state.apply_gradients(), losses

    return step


def make_posenet_sampler(model, sched: DiffusionSchedule) -> Callable:
    """sample(cond, generator) -> [B, T, 294]: the reverse chain through the
    plain PoseNet module (eval mode), as the JAX package's eval-during-
    training sampler runs its flax model. (The JAX sampler's guidance and
    early stop serve its single-net test CLI, which is not ported.)"""

    def sample(cond: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return p_sample_loop(lambda x, t: model(x, cond, t), sched, tuple(cond.shape), generator)

    return sample
