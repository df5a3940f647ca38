"""The AMASS test-time guidance (foot skating through SMPL-X), plain PyTorch.

A frozen copy of rohm_tpu_torch/models/guidance.py's 'amass' stack and of
models/losses.py's foot_skating_loss, single process: skating weight 3e6
at t <= 50, the gradient masked to zero on the trajectory dims [:22] and
the contact dims [-4:]. The loss is the masked sum over the whole batch
divided by the whole batch's mask count.
"""

from __future__ import annotations

import torch

from .body import SmplxModel
from .decode import recover_from_repr
from .sampler import GuidanceSpec
from .schema import BODY_FEAT_DIM, FOOT_JOINT_INDEX, TRAJ_FEAT_DIM_FULL, split_repr

AMASS_SKATING_WEIGHT = 3e6
AMASS_SKATING_T_THRESH = 50
FPS = 30.0
FOOT_SKATING_VEL_THRESH = 0.1


def guidance_grad_mask(device, dtype=torch.float32) -> torch.Tensor:
    """[294] mask: 0 on traj dims and contact dims, 1 elsewhere."""
    m = torch.ones(BODY_FEAT_DIM, dtype=dtype, device=device)
    m[:TRAJ_FEAT_DIM_FULL] = 0.0
    m[-4:] = 0.0
    return m


def foot_skating_loss(joints: torch.Tensor, contact_gt: torch.Tensor) -> torch.Tensor:
    """Masked mean foot speed where feet should be planted: joints [..., T,
    22, 3], contact_gt [..., T, 4]; mask = (speed > 0.1 m/s) AND contact,
    carrying no gradient."""
    foot = joints[..., list(FOOT_JOINT_INDEX), :]
    disp = (foot[..., 1:, :, :] - foot[..., :-1, :, :]) * FPS
    sq = (disp * disp).sum(-1)
    pos = sq > 0.0
    vel = torch.where(pos, torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))), torch.zeros_like(sq))
    mask = ((vel > FOOT_SKATING_VEL_THRESH).to(vel.dtype) * contact_gt[..., :-1, :]).detach()
    return (vel * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def skating_loss_fn(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                    body_model: SmplxModel) -> torch.Tensor:
    """Foot-skating loss on a normalized repr x [B, T, 294]: contact labels
    from x itself (> 0.5, detached), skating of the abs-traj and of the
    SMPL-X joint decodings."""
    dn = x * std + mean
    d = split_repr(dn)
    contact = (dn[..., -4:] > 0.5).to(x.dtype).detach()
    j_abs = recover_from_repr(d, mode="joint_abs_traj")
    j_smpl = recover_from_repr(d, mode="smplx_params", body_model=body_model)
    return foot_skating_loss(j_abs, contact) + foot_skating_loss(j_smpl, contact)


def amass_guidance(mean, std, body_model) -> tuple[GuidanceSpec, ...]:
    return (
        GuidanceSpec(
            loss_fn=lambda x: skating_loss_fn(x, mean, std, body_model),
            weight=AMASS_SKATING_WEIGHT,
            t_threshold=AMASS_SKATING_T_THRESH,
            grad_mask=guidance_grad_mask(mean.device),
        ),
    )
