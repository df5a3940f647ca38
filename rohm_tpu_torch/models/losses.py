"""Losses, ported from rohm_tpu/models/losses.py: the traj scatter used by
the bridge, the foot skating term used by test-time guidance, and the
PoseNet training losses (reference model/posenet.py:99-193), in the
normalized repr space for the repr terms and in metric space (after
denormalization and decoding) for the global-joint terms."""

from __future__ import annotations

import torch

from rohm_tpu_torch.body.model import SmplxModel
from rohm_tpu_torch.reprs.decode import recover_from_repr
from rohm_tpu_torch.reprs.schema import (
    FOOT_JOINT_INDEX,
    TRAJ_FEAT_DIM_FULL,
    scatter_traj_abs,
    split_repr,
)

FPS = 30.0
FOOT_SKATING_VEL_THRESH = 0.1


def merge_traj_output(
    motion_repr_clean: torch.Tensor, model_output: torch.Tensor, repr_abs_only: bool
) -> torch.Tensor:
    """Scatter TrajNet output back into a full 294-d repr (pose part from GT)."""
    if repr_abs_only:
        return scatter_traj_abs(motion_repr_clean, model_output)
    return torch.cat([model_output, motion_repr_clean[..., TRAJ_FEAT_DIM_FULL:]], dim=-1)


def foot_skating_loss(joints: torch.Tensor, contact_gt: torch.Tensor) -> torch.Tensor:
    """Masked mean foot speed where feet should be planted.

    joints [..., T, 22, 3]; contact_gt [..., T, 4] (order l_ankle/l_toe/
    r_ankle/r_toe). Mask = (speed > 0.1 m/s) AND gt contact; the mask carries
    no gradient (reference posenet.py:154-179).
    """
    foot = joints[..., list(FOOT_JOINT_INDEX), :]
    disp = (foot[..., 1:, :, :] - foot[..., :-1, :, :]) * FPS
    # grad-safe norm: the double-where keeps primal and gradient finite at
    # exactly-zero displacement
    sq = (disp * disp).sum(-1)
    pos = sq > 0.0
    vel = torch.where(pos, torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))), torch.zeros_like(sq))
    mask = ((vel > FOOT_SKATING_VEL_THRESH).to(vel.dtype) * contact_gt[..., :-1, :]).detach()
    denom = torch.clamp(mask.sum(), min=1.0)
    return (vel * mask).sum() / denom


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b) ** 2


def posenet_losses(
    model_output: torch.Tensor,  # [B, T, 294] normalized
    motion_repr_clean: torch.Tensor,  # [B, T, 294] normalized
    mean: torch.Tensor,
    std: torch.Tensor,
    body_model: SmplxModel,
    weights: dict,
    traj_feat_dim: int = TRAJ_FEAT_DIM_FULL,
    skating_active: bool | torch.Tensor = True,
) -> dict:
    """PoseNet loss dict; key 'loss' is the weighted total. Differentiable
    in model_output (through the decoders and SMPL-X forward kinematics).

    skating_active is the `start_skating_loss_epoch` gate (posenet.py:181-184),
    a bool or a 0/1 tensor."""
    loss = {}
    l_all = _mse(motion_repr_clean, model_output)
    loss["loss_repr_full_body"] = l_all[..., traj_feat_dim:-4].mean()
    loss["loss_repr_foot_contact_mse"] = l_all[..., -4:].mean()

    d_clean = split_repr(motion_repr_clean * std + mean)
    d_rec = split_repr(model_output * std + mean)
    j_clean = recover_from_repr(d_clean, mode="joint_abs_traj")
    j_rec = {
        "abs_traj": recover_from_repr(d_rec, mode="joint_abs_traj"),
        "rel_traj": recover_from_repr(d_rec, mode="joint_rel_traj"),
        "smpl": recover_from_repr(d_rec, mode="smplx_params", body_model=body_model),
    }

    def vel(p):
        return p[..., 1:, :, :] - p[..., :-1, :, :]

    v_clean = vel(j_clean)
    contact_gt = d_clean["foot_contact"]
    for name, j in j_rec.items():
        loss[f"loss_joint_pos_global_from_{name}"] = _mse(j, j_clean).mean()
    for name, j in j_rec.items():
        loss[f"loss_joint_vel_global_from_{name}"] = _mse(vel(j), v_clean).mean()
    for name, j in j_rec.items():
        loss[f"loss_joint_smooth_from_{name}"] = (vel(vel(j)) ** 2).mean()
    for name, j in j_rec.items():
        loss[f"loss_foot_skating_from_{name}"] = foot_skating_loss(j, contact_gt)

    def total(term):
        return sum(loss[f"loss_{term}_from_{name}"] for name in j_rec)

    w = weights
    skating_w = w.get("weight_loss_foot_skating", 0.0) * torch.as_tensor(
        skating_active, dtype=model_output.dtype, device=model_output.device
    )
    loss["loss"] = (
        w.get("weight_loss_rec_repr_full_body", 0.0) * loss["loss_repr_full_body"]
        + w.get("weight_loss_repr_foot_contact_mse", 0.0) * loss["loss_repr_foot_contact_mse"]
        + w.get("weight_loss_joint_pos_global", 0.0) * total("joint_pos_global")
        + w.get("weight_loss_joint_vel_global", 0.0) * total("joint_vel_global")
        + w.get("weight_loss_joint_smooth", 0.0) * total("joint_smooth")
        + skating_w * total("foot_skating")
    )
    return loss
