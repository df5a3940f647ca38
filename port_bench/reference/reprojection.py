"""The PROX/EgoBody test-time guidance, plain PyTorch: the 2-D keypoint
reprojection through SMPL-X and a pinhole camera, beside the foot skating.

Written from the published description (RoHM, CVPR 2024; the paper's code
at posenet.py:284-309 and gaussian_diffusion_posenet.py:461-477), not copied
from the port. Per row (one window of a recording) with its own camera:

  joints   = SMPL-X joints [T, 22, 3] decoded from the denormalized repr
  scene    = R_c2s joints + t_c2s     (inverse of the window's scene ->
                                       canonical transform)
  camera   = R_cam^-1 (scene - t_cam) (cam2world = [R_cam | t_cam])
  pixels   = camera_xy / camera_z * focal + center
  loss     = mean over rows, frames, GUIDANCE_2D_JOINTS and (u, v) of
             confidence * |pixels - keypoints|

Weights and thresholds: reprojection 3e5 plus skating 1e5, both at t <= 100,
the gradient masked to zero on the trajectory dims [:22] and the contact
dims [-4:].

Departures from the published code: the cameras are given per row
(cam_r [B, 3, 3], cam_t [B, 3]) where the paper's loop holds one recording's
camera for the batch; a single camera ([3, 3], [3]) is taken as that camera
on every row. The keypoints are taken as already undistorted, as the
paper's data loader leaves them. The inverses are taken once per batch.
"""

from __future__ import annotations

import torch

from .body import SmplxModel
from .decode import recover_from_repr
from .guidance import guidance_grad_mask, skating_loss_fn
from .sampler import GuidanceSpec
from .schema import split_repr

# f32 products and convolutions in full f32, TF32 off (the controls switch
# TF32 on around their own runs: drivers/prox.py's run_checks)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# SMPL-X joints entering the reprojection loss: shoulders, elbows, wrists,
# knees and ankles (the paper's posenet.py:308)
GUIDANCE_2D_JOINTS = (16, 18, 20, 17, 19, 21, 4, 5, 7, 8)
PROX_PROJ2D_WEIGHT = 3e5
PROX_SKATING_WEIGHT = 1e5
PROX_T_THRESH = 100


def per_row_camera(cam_r: torch.Tensor, cam_t: torch.Tensor, rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The camera as [rows, 3, 3] and [rows, 3]: one camera repeated on
    every row, or the per-row cameras as given."""
    if cam_r.dim() == 2:
        return cam_r.expand(rows, 3, 3), cam_t.expand(rows, 3)
    return cam_r, cam_t


def camera_inverses(transf_matrix: torch.Tensor, cam_r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(canonical -> scene [B, 4, 4], scene -> camera rotation [B, 3, 3]) of
    each row, from its scene -> canonical transform and its camera's
    rotation (cam2world's [3, 3] block)."""
    return torch.linalg.inv(transf_matrix), torch.linalg.inv(cam_r)


def project(points: torch.Tensor, focal: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """Pinhole: camera-coordinate points [B, T, N, 3] -> pixels [B, T, N, 2];
    focal and center [B, 2]."""
    return points[..., :2] / points[..., 2:3] * focal[:, None, None, :] + center[:, None, None, :]


def reprojection_loss(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor, body_model: SmplxModel,
                      cano_to_scene: torch.Tensor, cam_r_inv: torch.Tensor, cam_t: torch.Tensor,
                      focal: torch.Tensor, center: torch.Tensor, keypoints: torch.Tensor) -> torch.Tensor:
    """The confidence-weighted L1 between the projected SMPL-X joints of x
    [B, T, 294] (normalized) and the keypoints [B, >=T, 22, 3] (u, v,
    confidence), averaged over the whole batch."""
    d = split_repr(x * std + mean)
    joints = recover_from_repr(d, mode="smplx_params", body_model=body_model)  # [B, T, 22, 3]
    r, t = cano_to_scene[:, :3, :3], cano_to_scene[:, :3, 3]
    scene = (r[:, None, None] @ joints[..., None]).squeeze(-1) + t[:, None, None, :]
    camera = (cam_r_inv[:, None, None] @ (scene - cam_t[:, None, None, :])[..., None]).squeeze(-1)
    pixels = project(camera, focal, center)
    kp = keypoints[:, : joints.shape[1]]
    index = list(GUIDANCE_2D_JOINTS)
    return ((pixels[:, :, index] - kp[:, :, index, :2]).abs() * kp[:, :, index, 2:3]).mean()


def prox_guidance(mean, std, body_model, transf_matrix, cam_r, cam_t, focal_length, camera_center,
                  keypoints_2d) -> tuple[GuidanceSpec, ...]:
    """The two PROX terms: reprojection (3e5) and skating (1e5), both at
    t <= 100, the gradient masked on the trajectory and contact dims."""
    cam_r, cam_t = per_row_camera(cam_r, cam_t, transf_matrix.shape[0])
    cano_to_scene, cam_r_inv = camera_inverses(transf_matrix, cam_r)
    mask = guidance_grad_mask(mean.device)
    return (
        GuidanceSpec(
            loss_fn=lambda x: reprojection_loss(x, mean, std, body_model, cano_to_scene, cam_r_inv, cam_t,
                                                focal_length, camera_center, keypoints_2d),
            weight=PROX_PROJ2D_WEIGHT, t_threshold=PROX_T_THRESH, grad_mask=mask,
        ),
        GuidanceSpec(
            loss_fn=lambda x: skating_loss_fn(x, mean, std, body_model),
            weight=PROX_SKATING_WEIGHT, t_threshold=PROX_T_THRESH, grad_mask=mask,
        ),
    )
