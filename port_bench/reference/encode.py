"""Motion-repr encoder: canonical joints + SMPL-X params -> 294-d frames.

A frozen copy of rohm_tpu_torch/reprs/encode.py. Batched over leading dims; it runs
inside the traj->pose bridge of every pipeline iteration. Output has T-1
frames for T input frames (the last frame is dropped so velocity blocks
align).
"""

from __future__ import annotations

import torch

from .rotations import (
    _cross,
    aa_to_rotmat,
    qbetween,
    qinv,
    qmul,
    qrot,
    rotmat_to_rot6d,
    skew_angular_velocity,
)
from .schema import REPR_LIST

# face direction: across = pos[1] - pos[2] + pos[17] - pos[16] (the reference
# unpacks the index list with swapped names; this is its actual arithmetic)
_FWD_A, _FWD_B = (1, 17), (2, 16)
_FEET_L = [7, 10]
_FEET_R = [8, 11]


def _foot_contact(positions: torch.Tensor, vel_thresh: float, up_axis: int = 2) -> torch.Tensor:
    """Binary contact labels [..., T-1, 4] in order (l_ankle, l_toe, r_ankle, r_toe).

    contact = squared per-frame displacement < vel_thresh AND height < (0.18, 0.15).
    """
    heightfactor = positions.new_tensor([0.18, 0.15])

    def detect(idx):
        p = positions[..., idx, :]  # [..., T, 2, 3]
        disp_sq = ((p[..., 1:, :, :] - p[..., :-1, :, :]) ** 2).sum(-1)
        height = p[..., :-1, :, up_axis]
        return ((disp_sq < vel_thresh) & (height < heightfactor)).to(positions.dtype)

    return torch.cat([detect(_FEET_L), detect(_FEET_R)], dim=-1)


def _patch_degenerate_quats(quat: torch.Tensor, raw_norm: torch.Tensor) -> torch.Tensor:
    """Replace frames where qbetween degenerated (antiparallel vectors) with the
    last good frame's quaternion, identity before any good frame (reference
    NaN patch, motion_representation.py:216-219).

    quat: [..., T, 4]; raw_norm: [..., T, 1] pre-normalization magnitude.
    """
    good = raw_norm[..., 0] >= 1e-6  # [..., T]
    t = torch.arange(quat.shape[-2], device=quat.device).expand(good.shape)
    last_good = torch.where(good, t, torch.full_like(t, -1)).cummax(dim=-1).values
    patched = torch.gather(quat, -2, last_good.clamp(min=0)[..., None].expand(quat.shape))
    ident = quat.new_tensor([1.0, 0.0, 0.0, 0.0])
    return torch.where((last_good >= 0)[..., None], patched, ident)


def heading_quat(positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-frame root-heading quaternion rotating the body's forward to y+.

    positions: [..., T, 22, 3] (z-up). Returns (quat [..., T, 4], forward [..., T, 3]).
    Frame 0 is forced to identity, as in the reference.
    """
    across = (
        positions[..., _FWD_A[0], :] - positions[..., _FWD_B[0], :]
        + positions[..., _FWD_A[1], :] - positions[..., _FWD_B[1], :]
    )
    across = across / torch.clamp(torch.linalg.vector_norm(across, dim=-1, keepdim=True), min=1e-12)
    z_up = positions.new_tensor([0.0, 0.0, 1.0])
    forward = _cross(z_up, across)
    forward = forward / torch.clamp(torch.linalg.vector_norm(forward, dim=-1, keepdim=True), min=1e-12)

    target = positions.new_tensor([0.0, 1.0, 0.0]).expand(forward.shape)
    # raw (unnormalized) qbetween to detect degenerate antiparallel frames
    v = _cross(forward, target)
    w = 1.0 + (forward * target).sum(-1, keepdim=True)
    raw_norm = torch.linalg.vector_norm(torch.cat([w, v], dim=-1), dim=-1, keepdim=True)
    quat = _patch_degenerate_quats(qbetween(forward, target), raw_norm)
    ident = positions.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(quat[..., :1, :].shape)
    quat = torch.cat([ident, quat[..., 1:, :]], dim=-2)
    return quat, forward


def get_repr(
    positions: torch.Tensor,
    global_orient: torch.Tensor | None = None,
    transl: torch.Tensor = None,
    body_pose: torch.Tensor | None = None,
    betas: torch.Tensor = None,
    feet_vel_thresh: float = 5e-5,
    global_orient_mat: torch.Tensor | None = None,
    body_pose_mat: torch.Tensor | None = None,
) -> torch.Tensor:
    """Encode a canonical sequence into the flat 294-d representation.

    Args:
      positions: [..., T, 22, 3] canonical joints (z-up).
      global_orient: [..., T, 3] axis-angle (or pass global_orient_mat [..., T, 3, 3]).
      transl: [..., T, 3] SMPL-X translation.
      body_pose: [..., T, 63] axis-angle (or body_pose_mat [..., T, 21, 3, 3]).
      betas: [..., T, 10].

    Returns: [..., T-1, 294].
    """
    quat, _ = heading_quat(positions)  # [..., T, 4]
    quat_vel = qmul(quat[..., 1:, :], qinv(quat[..., :-1, :]))

    root = positions[..., 0, :]  # [..., T, 3]
    root_height = root[..., 2:3]
    root_vel = qrot(quat[..., 1:, :], root[..., 1:, :] - root[..., :-1, :])

    root_rot_angle = torch.atan2(quat[..., 3:4], quat[..., 0:1])  # half-angle
    root_rot_angle_vel = torch.atan2(quat_vel[..., 3:4], quat_vel[..., 0:1])

    # local pose: recenter xy on root, rotate each frame to face y+
    local = positions - root[..., None, :] * positions.new_tensor([1.0, 1.0, 0.0])
    local = qrot(quat[..., :, None, :], local)  # broadcast over 22 joints

    local_vel = qrot(
        quat[..., :-1, None, :], positions[..., 1:, :, :] - positions[..., :-1, :, :]
    )

    # smplx-based traj
    if global_orient_mat is None:
        global_orient_mat = aa_to_rotmat(global_orient)
    rot6d = rotmat_to_rot6d(global_orient_mat)
    drdt = global_orient_mat[..., 1:, :, :] - global_orient_mat[..., :-1, :, :]
    rot_vel = skew_angular_velocity(global_orient_mat[..., :-1, :, :], drdt)
    trans_vel = transl[..., 1:, :] - transl[..., :-1, :]

    if body_pose_mat is None:
        body_pose_mat = aa_to_rotmat(body_pose.reshape(body_pose.shape[:-1] + (21, 3)))
    body_pose_6d = rotmat_to_rot6d(body_pose_mat)  # [..., T, 21, 6]
    body_pose_6d = body_pose_6d.reshape(body_pose_6d.shape[:-2] + (126,))

    contact = _foot_contact(positions, feet_vel_thresh)

    t_m1 = positions.shape[-3] - 1
    blocks = {
        "root_rot_angle": root_rot_angle[..., :-1, :],
        "root_rot_angle_vel": root_rot_angle_vel,
        "root_l_pos": root[..., :-1, 0:2],
        "root_l_vel": root_vel[..., 0:2],
        "root_height": root_height[..., :-1, :],
        "smplx_rot_6d": rot6d[..., :-1, :],
        "smplx_rot_vel": rot_vel,
        "smplx_trans": transl[..., :-1, :],
        "smplx_trans_vel": trans_vel,
        "local_positions": local[..., :-1, :, :].reshape(local.shape[:-3] + (t_m1, 66)),
        "local_vel": local_vel.reshape(local_vel.shape[:-3] + (t_m1, 66)),
        "smplx_body_pose_6d": body_pose_6d[..., :-1, :],
        "smplx_betas": betas[..., :-1, :],
        "foot_contact": contact,
    }
    return torch.cat([blocks[name] for name in REPR_LIST], dim=-1)
