"""Losses, ported from rohm_tpu/models/losses.py: the traj scatter used by
the bridge, the foot skating term used by test-time guidance, and the
TrajNet and PoseNet training losses (reference model/trajnet.py:278-400,
model/posenet.py:99-193), in the normalized repr space for the repr terms
and in metric space (after denormalization and decoding) for the
global-joint terms.

Under a data-parallel mesh (`mesh=`, each rank holding its rows of the
batch) every reduction over the batch is taken over the global batch, as
GSPMD takes it in the JAX package: the mean terms are averaged over ranks
and the skating loss divides the global masked sum by the global mask
count, both through `global_sum`, so every rank returns the global value
and its gradient is this rank's share of the global gradient."""

from __future__ import annotations

import torch

from rohm_tpu_torch.body.model import SmplxModel
from rohm_tpu_torch.geometry.rotations import rot6d_to_rotmat, skew_angular_velocity
from rohm_tpu_torch.parallel.mesh import DataMesh, global_sum
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


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b) ** 2


def _global_means(loss: dict, mesh: DataMesh | None, skip: str = "loss_foot_skating") -> None:
    """Replace each rank-local mean term of `loss` (equal row counts on every
    rank) by the mean over ranks, in one collective; keys starting with
    `skip` are global already."""
    if mesh is None:
        return
    keys = [k for k in loss if not k.startswith(skip)]
    means = global_sum(torch.stack([loss[k] for k in keys]), mesh) / mesh.size
    loss.update(zip(keys, means.unbind()))


def trajnet_losses(
    model_output: torch.Tensor,  # [B, T, 13|22] normalized
    motion_repr_clean: torch.Tensor,  # [B, T, 294] normalized
    mean: torch.Tensor,
    std: torch.Tensor,
    body_model: SmplxModel,
    weights: dict,
    repr_abs_only: bool = True,
    mesh: DataMesh | None = None,
) -> dict:
    """TrajNet loss dict; key 'loss' is the weighted total. Differentiable
    in model_output (through the decoders and SMPL-X forward kinematics).
    mesh: the batch is this rank's rows; the terms are global means."""
    loss = {}
    full_rec = merge_traj_output(motion_repr_clean, model_output, repr_abs_only)
    l_all = _mse(motion_repr_clean, full_rec)

    loss["loss_repr_traj_root_rot_angle"] = l_all[..., 0].mean()
    loss["loss_repr_traj_root_l_pos"] = l_all[..., 2:4].mean()
    loss["loss_repr_traj_root_height"] = l_all[..., 6].mean()
    loss["loss_repr_traj_smplx_rot_6d"] = l_all[..., 7:13].mean()
    loss["loss_repr_traj_smplx_trans"] = l_all[..., 16:19].mean()
    if not repr_abs_only:
        loss["loss_repr_traj_root_rot_angle_vel"] = l_all[..., 1].mean()
        loss["loss_repr_traj_root_l_vel"] = l_all[..., 4:6].mean()
        loss["loss_repr_traj_smplx_rot_vel"] = l_all[..., 13:16].mean()
        loss["loss_repr_traj_smplx_trans_vel"] = l_all[..., 19:22].mean()
        loss["loss_repr_traj"] = l_all[..., :TRAJ_FEAT_DIM_FULL].mean()
    else:
        loss["loss_repr_traj"] = torch.cat(
            [l_all[..., 0:1], l_all[..., 2:4], l_all[..., 6:7], l_all[..., 7:13], l_all[..., 16:19]],
            dim=-1,
        ).mean()

    d_clean = split_repr(motion_repr_clean * std + mean)
    d_rec = split_repr(full_rec * std + mean)
    root_clean = recover_from_repr(d_clean, mode="joint_abs_traj")[..., 0, :]
    root_abs = recover_from_repr(d_rec, mode="joint_abs_traj")[..., 0, :]
    root_rel = recover_from_repr(d_rec, mode="joint_rel_traj")[..., 0, :]
    root_smpl = recover_from_repr(d_rec, mode="smplx_params", body_model=body_model)[..., 0, :]

    loss["loss_root_pos_global_from_abs_traj"] = _mse(root_abs, root_clean).mean()
    loss["loss_root_pos_global_from_rel_traj"] = _mse(root_rel, root_clean).mean()
    loss["loss_root_pos_global_from_smpl"] = _mse(root_smpl, root_clean).mean()

    def vel(p):
        return p[..., 1:, :] - p[..., :-1, :]

    v_clean = vel(root_clean)
    v_abs, v_rel, v_smpl = vel(root_abs), vel(root_rel), vel(root_smpl)
    loss["loss_root_vel_global_from_abs_traj"] = _mse(v_abs, v_clean).mean()
    loss["loss_root_vel_global_from_rel_traj"] = _mse(v_rel, v_clean).mean()
    loss["loss_root_vel_global_from_smpl"] = _mse(v_smpl, v_clean).mean()

    # smplx global-orient angular-velocity consistency
    rot_mats = rot6d_to_rotmat(d_rec["smplx_rot_6d"])
    drdt = rot_mats[..., 1:, :, :] - rot_mats[..., :-1, :, :]
    rot_vel = skew_angular_velocity(rot_mats[..., :-1, :, :], drdt)
    loss["loss_root_smplx_rot_vel"] = _mse(rot_vel, d_clean["smplx_rot_vel"][..., :-1, :]).mean()

    transl_vel = vel(d_rec["smplx_trans"])
    loss["loss_root_smplx_transl_vel"] = _mse(
        transl_vel, d_clean["smplx_trans_vel"][..., :-1, :]
    ).mean()

    # translational smoothness (squared accel)
    loss["loss_root_smooth_from_abs_traj"] = (vel(v_abs) ** 2).mean()
    loss["loss_root_smooth_from_rel_traj"] = (vel(v_rel) ** 2).mean()
    loss["loss_root_smooth_from_smpl"] = (vel(v_smpl) ** 2).mean()

    # heading smoothness on cos(2*half-angle): continuous, no wrap jumps
    def cosv(d):
        return vel(torch.cos(d["root_rot_angle"] * 2))

    cos_vel_clean, cos_vel_rec = cosv(d_clean), cosv(d_rec)
    loss["loss_root_rot_cos_vel_from_abs_traj"] = _mse(cos_vel_clean, cos_vel_rec).mean()
    loss["loss_root_rot_cos_smooth_from_abs_traj"] = (vel(cos_vel_rec) ** 2).mean()

    if repr_abs_only:
        # rel-traj dims are GT in abs-only mode; their losses are defined as 0
        zero = torch.zeros((), dtype=model_output.dtype, device=model_output.device)
        loss["loss_root_pos_global_from_rel_traj"] = zero
        loss["loss_root_vel_global_from_rel_traj"] = zero
        loss["loss_root_smooth_from_rel_traj"] = zero
    _global_means(loss, mesh)

    def total(term):
        return sum(loss[f"loss_{term}_from_{name}"] for name in ("abs_traj", "rel_traj", "smpl"))

    w = weights
    loss["loss"] = (
        w.get("weight_loss_root_rec_repr", 0.0) * loss["loss_repr_traj"]
        + w.get("weight_loss_root_pos_global", 0.0) * total("root_pos_global")
        + w.get("weight_loss_root_vel_global", 0.0) * total("root_vel_global")
        + w.get("weight_loss_root_rot_vel_from_abs_traj", 0.0) * loss["loss_root_rot_cos_vel_from_abs_traj"]
        + w.get("weight_loss_root_smplx_transl_vel", 0.0) * loss["loss_root_smplx_transl_vel"]
        + w.get("weight_loss_root_smplx_rot_vel", 0.0) * loss["loss_root_smplx_rot_vel"]
        + w.get("weight_loss_root_smooth", 0.0) * total("root_smooth")
        + w.get("weight_loss_root_rot_cos_smooth_from_abs_traj", 0.0)
        * loss["loss_root_rot_cos_smooth_from_abs_traj"]
    )
    return loss


def foot_skating_loss(joints: torch.Tensor, contact_gt: torch.Tensor,
                      mesh: DataMesh | None = None) -> torch.Tensor:
    """Masked mean foot speed where feet should be planted.

    joints [..., T, 22, 3]; contact_gt [..., T, 4] (order l_ankle/l_toe/
    r_ankle/r_toe). Mask = (speed > 0.1 m/s) AND gt contact; the mask carries
    no gradient (reference posenet.py:154-179). Under a mesh the masked sum
    and the mask count are both summed over ranks before the division: the
    ranks' counts differ, so a mean of per-rank means would not be the
    global mean.
    """
    foot = joints[..., list(FOOT_JOINT_INDEX), :]
    disp = (foot[..., 1:, :, :] - foot[..., :-1, :, :]) * FPS
    # grad-safe norm: the double-where keeps primal and gradient finite at
    # exactly-zero displacement
    sq = (disp * disp).sum(-1)
    pos = sq > 0.0
    vel = torch.where(pos, torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))), torch.zeros_like(sq))
    mask = ((vel > FOOT_SKATING_VEL_THRESH).to(vel.dtype) * contact_gt[..., :-1, :]).detach()
    num, count = (vel * mask).sum(), mask.sum()
    if mesh is not None:
        num, count = global_sum(torch.stack([num, count]), mesh).unbind()
    return num / torch.clamp(count, min=1.0)


def posenet_losses(
    model_output: torch.Tensor,  # [B, T, 294] normalized
    motion_repr_clean: torch.Tensor,  # [B, T, 294] normalized
    mean: torch.Tensor,
    std: torch.Tensor,
    body_model: SmplxModel,
    weights: dict,
    traj_feat_dim: int = TRAJ_FEAT_DIM_FULL,
    skating_active: bool | torch.Tensor = True,
    mesh: DataMesh | None = None,
) -> dict:
    """PoseNet loss dict; key 'loss' is the weighted total. Differentiable
    in model_output (through the decoders and SMPL-X forward kinematics).

    skating_active is the `start_skating_loss_epoch` gate (posenet.py:181-184),
    a bool or a 0/1 tensor. mesh: the batch is this rank's rows; every
    term is the global one."""
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
        loss[f"loss_foot_skating_from_{name}"] = foot_skating_loss(j, contact_gt, mesh)
    _global_means(loss, mesh)

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
