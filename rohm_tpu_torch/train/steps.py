"""TrajNet and PoseNet training and eval-sampling steps.

The port of rohm_tpu/train/steps.py (reference
gaussian_diffusion_trajnet.py:857-875 through model/trajnet.py:278-400, and
gaussian_diffusion_posenet.py:892-910 through model/posenet.py:99-193).
One optimizer step: uniform timesteps, q_sample, the model's train-mode
forward, SMPL-X-in-the-loop losses, backward, AdamW. The JAX package jits
it into one program; here it runs eagerly. TrajNet is plain PyTorch; with
`fused_train` PoseNet's encoder layers run through the hand-written CUDA
forward and backward kernels (ops/transformer_layer_train.py).

Randomness: t, the q_sample noise and (PoseNet) every dropout mask are
drawn on the device from one torch.Generator, in the order t, noise, masks.

Data parallelism (`mesh=`): the batch is this rank's rows. Every draw is
taken at the global batch from the same seeded generator on every rank
and sliced (parallel.draw_rows), the losses are the global batch's
(models/losses.py), and the gradients are summed over ranks before the
optimizer step, so every rank keeps the single-process parameters. The
JAX fused path instead folds the shard index into its dropout key
(rohm_tpu/train/steps.py:168-176); the port draws the global masks.
"""

from __future__ import annotations

from typing import Callable

import torch

from rohm_tpu_torch.body.model import SmplxModel
from rohm_tpu_torch.diffusion.gaussian import q_sample
from rohm_tpu_torch.diffusion.sampler import p_sample_loop
from rohm_tpu_torch.diffusion.schedule import DiffusionSchedule
from rohm_tpu_torch.models.losses import posenet_losses, trajnet_losses
from rohm_tpu_torch.ops.transformer_layer import embed_cond_f32, posenet_apply_fused
from rohm_tpu_torch.ops.transformer_layer_train import posenet_apply_train, posenet_dropout_masks
from rohm_tpu_torch.parallel.mesh import DataMesh, draw_rows, shard_rows, sum_gradients
from rohm_tpu_torch.train.state import TrainState


def _draw_t_noise(generator: torch.Generator, num_timesteps: int, shape: tuple, dtype,
                  mesh: DataMesh | None):
    """t [B] then the q_sample noise [B, ...] for this rank's B rows."""
    dev = generator.device
    t = draw_rows(lambda sh: torch.randint(0, num_timesteps, sh, generator=generator, device=dev),
                  shape[:1], mesh)
    noise = draw_rows(lambda sh: torch.randn(sh, generator=generator, device=dev, dtype=dtype),
                      shape, mesh)
    return t, noise


def make_trajnet_grads_fn(
    model,
    sched: DiffusionSchedule,
    mean: torch.Tensor,
    std: torch.Tensor,
    body_model: SmplxModel,
    loss_weights: dict,
    repr_abs_only: bool = True,
    traj_feat_dim: int = 13,
    mesh: DataMesh | None = None,
) -> Callable:
    """grads_and_losses(model, batch, t, noise) -> (grads, loss_dict).

    The exact per-step training math (q_sample slicing -> model forward ->
    SMPL-X-in-the-loop losses -> parameter gradients) with t [B] and the
    q_sample noise [B, T, traj_feat_dim] as explicit inputs. The gradients
    are left in the parameters' `.grad` (zeroed first) and returned by
    parameter name, for the parameters that require them; the losses come
    back detached. batch: motion_repr_clean [B, T, 294], cond [B, T,
    traj_feat_dim], and control_cond [B, T, 272] when the model is
    TrajControl (it goes to the model only when present). Under a mesh
    the inputs are this rank's rows and the gradients and losses returned
    are the global ones.
    """

    def grads_and_losses(model, batch: dict, t: torch.Tensor, noise: torch.Tensor):
        clean = batch["motion_repr_clean"]
        # q_sample runs on the FIRST traj_feat_dim dims of the clean repr:
        # the reference does this even in abs-only mode, where the model's
        # output is read as the scattered abs dims
        # (gaussian_diffusion_trajnet.py:869-872 vs model/trajnet.py:292-297)
        x_t = q_sample(sched, clean[..., :traj_feat_dim], t, noise)
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            out = model.forward_train(x_t, batch["cond"], t, control_cond=batch.get("control_cond"))
            losses = trajnet_losses(out, clean, mean, std, body_model, loss_weights, repr_abs_only,
                                    mesh)
            losses["loss"].backward()
        sum_gradients(model.parameters(), mesh)
        grads = {name: p.grad for name, p in model.named_parameters() if p.requires_grad}
        return grads, {k: v.detach() for k, v in losses.items()}

    return grads_and_losses


def make_trajnet_train_step(
    model,
    sched: DiffusionSchedule,
    mean: torch.Tensor,
    std: torch.Tensor,
    body_model: SmplxModel,
    loss_weights: dict,
    repr_abs_only: bool = True,
    traj_feat_dim: int = 13,
    mesh: DataMesh | None = None,
) -> Callable:
    """step(state, batch, generator) -> (state, loss_dict).

    batch: motion_repr_clean [B, T, 294], cond [B, T, traj_feat_dim],
    optionally control_cond [B, T, 272] (TrajControl fine-tuning), on the
    device of `generator`, which draws t and then the noise. Under a mesh
    the batch is this rank's rows."""
    grads_and_losses = make_trajnet_grads_fn(
        model, sched, mean, std, body_model, loss_weights, repr_abs_only, traj_feat_dim, mesh
    )

    def step(state: TrainState, batch: dict, generator: torch.Generator):
        clean = batch["motion_repr_clean"]
        t, noise = _draw_t_noise(generator, sched.num_timesteps, clean[..., :traj_feat_dim].shape,
                                 clean.dtype, mesh)
        _, losses = grads_and_losses(state.model, batch, t, noise)
        return state.apply_gradients(), losses

    return step


def make_trajnet_sampler(model, sched: DiffusionSchedule, traj_feat_dim: int = 13,
                         mesh: DataMesh | None = None) -> Callable:
    """sample(cond, generator, control_cond=None, noise=None, step_noise=None)
    -> [B, T, traj_feat_dim]: the whole (typically 100-step) reverse chain
    through the eval forward. noise / step_noise replay x_T and the
    per-step noise (p_sample_loop). Under a mesh cond is this rank's rows
    and so is the sample."""

    def sample(cond: torch.Tensor, generator: torch.Generator, control_cond=None, noise=None,
               step_noise=None) -> torch.Tensor:
        shape = (cond.shape[0], cond.shape[1], traj_feat_dim)
        return p_sample_loop(lambda x, t: model(x, cond, t, control_cond=control_cond), sched, shape,
                             generator, noise=noise, step_noise=step_noise, mesh=mesh)

    return sample


def make_posenet_grads_fn(
    model,
    sched: DiffusionSchedule,
    mean: torch.Tensor,
    std: torch.Tensor,
    body_model: SmplxModel,
    loss_weights: dict,
    fused_train: str = "",
    mesh: DataMesh | None = None,
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

    mesh: batch, t, noise and handed-in masks are this rank's rows; masks
    from a generator are drawn for the global batch and sliced; the
    gradients and losses returned are the global ones.
    """
    if fused_train not in ("", "bfloat16", "float32"):
        raise ValueError(f"fused_train must be '', 'bfloat16' or 'float32', got {fused_train!r}")

    def grads_and_losses(model, batch: dict, t: torch.Tensor, noise: torch.Tensor, dropout,
                         skating_active):
        clean = batch["motion_repr_clean"]
        cond = batch["cond"]
        masks = dropout
        if isinstance(dropout, torch.Generator):
            n = clean.shape[0] * (mesh.size if mesh is not None else 1)
            keep, layers = posenet_dropout_masks(dropout, model, n, clean.shape[1])
            masks = (None if keep is None else shard_rows(keep, mesh),
                     [tuple(shard_rows(m, mesh) for m in lm) for lm in layers])
        x_t = q_sample(sched, clean, t, noise)
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            if fused_train:
                out = posenet_apply_train(model, x_t, cond, t, masks, fused_train)
            else:
                out = model.forward_train(x_t, cond, t, masks)
            losses = posenet_losses(out, clean, mean, std, body_model, loss_weights,
                                    skating_active=skating_active, mesh=mesh)
            losses["loss"].backward()
        sum_gradients(model.parameters(), mesh)
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
    mesh: DataMesh | None = None,
) -> Callable:
    """step(state, batch, generator, skating_active) -> (state, loss_dict).

    batch: motion_repr_clean [B, T, 294], cond [B, T, 294] (masked), on the
    device of `generator` (this rank's rows under a mesh). skating_active
    gates the foot-skating loss (start_skating_loss_epoch)."""
    grads_and_losses = make_posenet_grads_fn(
        model, sched, mean, std, body_model, loss_weights, fused_train, mesh
    )

    def step(state: TrainState, batch: dict, generator: torch.Generator, skating_active):
        clean = batch["motion_repr_clean"]
        t, noise = _draw_t_noise(generator, sched.num_timesteps, clean.shape, clean.dtype, mesh)
        _, losses = grads_and_losses(state.model, batch, t, noise, generator, skating_active)
        return state.apply_gradients(), losses

    return step


def make_posenet_sampler(model, sched: DiffusionSchedule, guidance: tuple = (),
                         early_stop_steps: int = 0, fused: bool = False,
                         mesh: DataMesh | None = None) -> Callable:
    """sample(cond, generator) -> [B, T, 294]: the reverse chain (1000
    steps at full size) through PoseNet in eval mode, with test-time
    `guidance` (GuidanceSpec terms) and `early_stop_steps` passed to
    p_sample_loop as they are.

    fused=False runs the PoseNet module; fused=True runs each step through
    `ops.posenet_apply_fused`, the f32 kernel chain that replaces K1
    (`gemm_f32`, `attention_f32`, the two-pass `residual_layernorm`), on the
    module's own weights, with the condition embedded once per chain.
    Under a mesh cond is this rank's rows and so is the sample."""

    def sample(cond: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        if fused:
            cond_emb = embed_cond_f32(model, cond)

            def model_fn(x, t):
                return posenet_apply_fused(model, x, cond, t, cond_emb=cond_emb)
        else:
            def model_fn(x, t):
                return model(x, cond, t)

        return p_sample_loop(model_fn, sched, tuple(cond.shape), generator, guidance=guidance,
                             early_stop_steps=early_stop_steps, mesh=mesh)

    return sample
