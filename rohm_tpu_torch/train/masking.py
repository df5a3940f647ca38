"""Occlusion-mask helpers the inference pipeline uses (numpy, host side).

A copy of the evaluation-time part of rohm_tpu/train/masking.py: the port
never imports the JAX package. Masks are multiplicative visibility masks
(1 = visible / keep).

Index map (traj_feat_dim = 22):
  local_positions  dims traj+joint*3+k          (k<3)
  local_vel        dims traj+66+joint*3+k       (k<3)
  body_pose_6d     dims traj+132+(joint-1)*6+k  (k<6), joint>=1
  foot_contact     dims -4:-2 left (joints 7/10), -2: right (joints 8/11)
"""

from __future__ import annotations

import numpy as np

from rohm_tpu_torch.reprs.schema import BODY_FEAT_DIM, TRAJ_FEAT_DIM_FULL

LOWER_BODY_JOINTS = np.array([1, 2, 4, 5, 7, 8, 10, 11])
UPPER_BODY_JOINTS = np.array([3, 6, 9, 12, 13, 14, 15, 16, 17, 18, 19, 20])


def joint_mask_to_vec(masked_joints: np.ndarray, traj_feat_dim: int = TRAJ_FEAT_DIM_FULL) -> np.ndarray:
    """Expand per-joint masked flags [..., 22] bool (True = mask OUT) into a
    flat repr visibility mask [..., 294] float. Traj dims and betas stay
    visible; contact dims follow the foot joints."""
    masked = np.asarray(masked_joints, bool)
    vis = np.ones(masked.shape[:-1] + (BODY_FEAT_DIM,), np.float32)
    keep = (~masked).astype(np.float32)  # [..., 22]

    j3 = np.repeat(keep, 3, axis=-1)  # [..., 66]
    vis[..., traj_feat_dim : traj_feat_dim + 66] = j3
    vis[..., traj_feat_dim + 66 : traj_feat_dim + 132] = j3
    vis[..., traj_feat_dim + 132 : traj_feat_dim + 132 + 126] = np.repeat(keep[..., 1:], 6, axis=-1)
    left_masked = masked[..., 7] | masked[..., 10]
    right_masked = masked[..., 8] | masked[..., 11]
    vis[..., -4:-2] *= (~left_masked).astype(np.float32)[..., None]
    vis[..., -2:] *= (~right_masked).astype(np.float32)[..., None]
    return vis


def lower_body_mask(batch_size: int) -> np.ndarray:
    masked = np.zeros((batch_size, 22), bool)
    masked[:, LOWER_BODY_JOINTS] = True
    return masked
