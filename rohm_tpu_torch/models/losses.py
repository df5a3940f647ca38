"""The two loss pieces the inference slice needs, ported from
rohm_tpu/models/losses.py: the traj scatter used by the bridge and the foot
skating term used by test-time guidance."""

from __future__ import annotations

import torch

from rohm_tpu_torch.reprs.schema import FOOT_JOINT_INDEX, TRAJ_FEAT_DIM_FULL, scatter_traj_abs

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
