"""Motion-repr decoder: 294-d frames -> joints.

The port of rohm_tpu/reprs/decode.py in the two modes the inference slice
uses (reference data_loaders/motion_representation.py:285-398):

- joint_abs_traj: root from absolute traj dims, local joints un-rotated
- smplx_params: rot6d -> rotmat -> SMPL-X forward kinematics
"""

from __future__ import annotations

import torch

from rohm_tpu_torch.body.model import SmplxModel, forward_joints
from rohm_tpu_torch.geometry.rotations import qinv, qrot, rot6d_to_rotmat
from rohm_tpu_torch.reprs.schema import split_repr


def recover_root_rot_pos(data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Root heading quaternion + root position from an absolute 4-d traj slice
    (rot_angle, x, y, height), z-up. Returns (quat [..., T, 4], pos [..., T, 3])."""
    ang = data[..., 0]
    zeros = torch.zeros_like(ang)
    quat = torch.stack([torch.cos(ang), zeros, zeros, torch.sin(ang)], dim=-1)
    pos = torch.stack([data[..., 1], data[..., 2], data[..., 3]], dim=-1)
    return quat, pos


def recover_from_repr(
    x: torch.Tensor | dict,
    mode: str = "joint_abs_traj",
    body_model: SmplxModel | None = None,
) -> torch.Tensor:
    """Recover joint positions [..., T, 22, 3] from a (denormalized) 294-d
    repr, given flat [..., T, 294] or as a pre-split block dict."""
    d = split_repr(x) if not isinstance(x, dict) else x

    if mode == "joint_abs_traj":
        traj = torch.cat([d["root_rot_angle"], d["root_l_pos"], d["root_height"]], dim=-1)
        quat, r_pos = recover_root_rot_pos(traj)
        local = d["local_positions"][..., 3:]  # drop root slot
        local = local.reshape(local.shape[:-1] + (21, 3))
        local = qrot(qinv(quat)[..., None, :], local)
        offset = torch.stack([r_pos[..., 0], r_pos[..., 1], torch.zeros_like(r_pos[..., 2])], -1)
        local = local + offset[..., None, :]
        return torch.cat([r_pos[..., None, :], local], dim=-2)

    if mode == "smplx_params":
        if body_model is None:
            raise ValueError("smplx_params mode needs a body model")
        # rot6d -> rotmat feeds FK directly (the reference's rotmat ->
        # axis-angle -> rotmat round trip is the identity)
        go_mat = rot6d_to_rotmat(d["smplx_rot_6d"])
        pose6d = d["smplx_body_pose_6d"]
        bp_mat = rot6d_to_rotmat(pose6d.reshape(pose6d.shape[:-1] + (21, 6)))
        return forward_joints(
            body_model, d["smplx_betas"], None, None, d["smplx_trans"],
            num_joints=22, global_orient_mat=go_mat, body_pose_mat=bp_mat,
        )

    raise ValueError(f"bad recover mode {mode}")
