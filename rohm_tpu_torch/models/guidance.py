"""Test-time guidance losses on the model's predicted x0.

The port of rohm_tpu/models/guidance.py. The sampler differentiates each
loss with torch.autograd.grad wrt pred_x0; the gradient is masked to zero
on the trajectory dims [:22] and the contact dims [-4:] (reference
posenet.py:251-252, 313-314). Weights and thresholds
(gaussian_diffusion_posenet.py:461-477): 'amass' -> foot skating 3e6 at
t <= 50; 'prox' (PROX and EgoBody) -> 2-D keypoint reprojection 3e5 plus
skating 1e5, both at t <= 100.

The reprojection takes one camera for the batch (cam_r [3, 3], cam_t
[3], as the CLI gives one recording's) or one camera per row (cam_r
[B, 3, 3], cam_t [B, 3]: windows of several recordings in one batch).

Under a data-parallel mesh x holds this rank's rows and each loss is the
global batch's: the skating loss through its global sums, the
reprojection mean as this rank's sum over the global count (the other
ranks' terms do not depend on these rows). Each rank then gets the
gradient of the global loss with respect to its own rows.
"""

from __future__ import annotations

import torch

from rohm_tpu_torch.body.model import SmplxModel
from rohm_tpu_torch.diffusion.sampler import GuidanceSpec
from rohm_tpu_torch.models.losses import foot_skating_loss
from rohm_tpu_torch.parallel.mesh import DataMesh
from rohm_tpu_torch.reprs.decode import recover_from_repr
from rohm_tpu_torch.reprs.schema import BODY_FEAT_DIM, TRAJ_FEAT_DIM_FULL, split_repr

# joints entering the 2-D reprojection loss (posenet.py:308)
GUIDANCE_2D_JOINTS = (16, 18, 20, 17, 19, 21, 4, 5, 7, 8)

AMASS_SKATING_WEIGHT = 3e6
AMASS_SKATING_T_THRESH = 50
PROX_PROJ2D_WEIGHT = 3e5
PROX_SKATING_WEIGHT = 1e5
PROX_T_THRESH = 100


def guidance_grad_mask(device, dtype=torch.float32) -> torch.Tensor:
    """[294] mask: 0 on traj dims and contact dims, 1 elsewhere."""
    m = torch.ones(BODY_FEAT_DIM, dtype=dtype, device=device)
    m[:TRAJ_FEAT_DIM_FULL] = 0.0
    m[-4:] = 0.0
    return m


def skating_loss_fn(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                    body_model: SmplxModel, mesh: DataMesh | None = None) -> torch.Tensor:
    """Foot-skating guidance loss on a normalized repr x [B, T, 294].

    Contact labels come from x itself, thresholded at 0.5 and detached; the
    loss sums skating over the abs-traj and SMPL-X joint decodings
    (posenet.py:220-248).
    """
    dn = x * std + mean
    d = split_repr(dn)
    contact = (dn[..., -4:] > 0.5).to(x.dtype).detach()
    j_abs = recover_from_repr(d, mode="joint_abs_traj")
    j_smpl = recover_from_repr(d, mode="smplx_params", body_model=body_model)
    return foot_skating_loss(j_abs, contact, mesh) + foot_skating_loss(j_smpl, contact, mesh)


def perspective_projection(points: torch.Tensor, focal_length: torch.Tensor,
                           camera_center: torch.Tensor) -> torch.Tensor:
    """Pinhole projection: points [..., N, 3] (camera coords) -> pixels [..., N, 2]
    (reference utils/other_utils.py:150-185 with identity rotation)."""
    uv = points[..., :2] / points[..., 2:3]
    return uv * focal_length[..., None, :] + camera_center[..., None, :]


def camera_inverses(transf_matrix: torch.Tensor, cam_r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(cano -> scene transforms [B, 4, 4], scene -> camera rotation [3, 3]
    or, for one camera per row, [B, 3, 3]): the inverses of a batch's
    canonicalization transforms and of its camera rotation bases. They do
    not depend on x, so they are computed once per batch, not in every
    guided step."""
    return torch.linalg.inv(transf_matrix), torch.linalg.inv(cam_r)


def projection_2d_loss_fn(
    x: torch.Tensor,
    mean: torch.Tensor,
    std: torch.Tensor,
    body_model: SmplxModel,
    cano_to_scene: torch.Tensor,  # [B, 4, 4] inverse of the scene->canonical transform
    cam_r_inv: torch.Tensor,  # [3, 3] or [B, 3, 3] inverse of the scene->camera rotation basis
    cam_t: torch.Tensor,  # [3] or [B, 3] camera origin in scene coords
    focal_length: torch.Tensor,  # [B, 2]
    camera_center: torch.Tensor,  # [B, 2]
    keypoints_2d: torch.Tensor,  # [B, T, 22, 3] (u, v, confidence)
    joint_index: torch.Tensor,  # GUIDANCE_2D_JOINTS on x's device
    mesh: DataMesh | None = None,
) -> torch.Tensor:
    """Confidence-weighted L1 between projected SMPL-X joints and 2-D keypoints.

    Joint path: canonical -> scene (inverse canonicalization transform)
    -> camera (cam_R^-1 (p - cam_t)) -> pixels (posenet.py:284-309), in the
    JAX package's order of operations (it divides by the camera depth last,
    so both packages agree on near-zero depths). The inverses come from
    `camera_inverses`; a batched cam_r_inv with its [B, 3] cam_t puts each
    row in its own camera, and a single one is taken as that camera on
    every row. The loss is the mean over the whole batch.
    """
    dn = x * std + mean
    d = split_repr(dn)
    joints = recover_from_repr(d, mode="smplx_params", body_model=body_model)  # [B, T, 22, 3]

    r = cano_to_scene[:, :3, :3]
    t = cano_to_scene[:, :3, 3]
    scene = torch.einsum("bij,btnj->btni", r, joints) + t[:, None, None, :]
    # one camera for the batch is that camera on every row (views, no copy)
    cam_r_inv = cam_r_inv.expand(scene.shape[0], 3, 3)
    cam = torch.einsum("bij,btnj->btni", cam_r_inv, scene - cam_t.reshape(-1, 1, 1, 3))
    proj = perspective_projection(cam, focal_length[:, None, :], camera_center[:, None, :])

    seq_len = joints.shape[-3]
    kp = keypoints_2d[:, :seq_len]
    l1 = (proj - kp[..., :2]).abs() * kp[..., 2:3]
    loss = l1[..., joint_index, :].mean()
    return loss if mesh is None else loss / mesh.size


def amass_guidance(mean, std, body_model, mesh: DataMesh | None = None) -> tuple[GuidanceSpec, ...]:
    """Guidance stack for AMASS evaluation (skating only)."""
    return (
        GuidanceSpec(
            loss_fn=lambda x: skating_loss_fn(x, mean, std, body_model, mesh),
            weight=AMASS_SKATING_WEIGHT,
            t_threshold=AMASS_SKATING_T_THRESH,
            grad_mask=guidance_grad_mask(mean.device),
            name="skating",
        ),
    )


def prox_guidance(mean, std, body_model, transf_matrix, cam_r, cam_t, focal_length,
                  camera_center, keypoints_2d, mesh: DataMesh | None = None) -> tuple[GuidanceSpec, ...]:
    """Guidance stack for PROX/EgoBody (2-D reprojection + skating); the
    camera inverses are taken here, once per batch. The camera is cam_r
    [3, 3] with cam_t [3] for the whole batch, or cam_r [B, 3, 3] with
    cam_t [B, 3], one per row. Under a mesh the batch-leading inputs
    (a per-row camera too) are this rank's rows."""
    if cam_r.dim() not in (2, 3) or cam_t.dim() != cam_r.dim() - 1:
        raise ValueError(f"cam_r {tuple(cam_r.shape)} with cam_t {tuple(cam_t.shape)}: expected [3, 3] with [3] "
                         "or [B, 3, 3] with [B, 3]")
    mask = guidance_grad_mask(mean.device)
    cano_to_scene, cam_r_inv = camera_inverses(transf_matrix, cam_r)
    joint_index = torch.as_tensor(GUIDANCE_2D_JOINTS, device=mean.device)
    return (
        GuidanceSpec(
            loss_fn=lambda x: projection_2d_loss_fn(
                x, mean, std, body_model, cano_to_scene, cam_r_inv, cam_t,
                focal_length, camera_center, keypoints_2d, joint_index, mesh,
            ),
            weight=PROX_PROJ2D_WEIGHT,
            t_threshold=PROX_T_THRESH,
            grad_mask=mask,
            name="proj2d",
        ),
        GuidanceSpec(
            loss_fn=lambda x: skating_loss_fn(x, mean, std, body_model, mesh),
            weight=PROX_SKATING_WEIGHT,
            t_threshold=PROX_T_THRESH,
            grad_mask=mask,
            name="skating",
        ),
    )
