"""Per-clip canonicalization (host-side numpy; runs in the data layer).
A frozen copy of rohm_tpu_torch/reprs/canonicalize.py's z-up sequences
(AMASS, PROX).

Normalizes each clip so the floor is at z=0, frame 0's pelvis xy is at the
origin, and frame 0 faces y+. Rewrites SMPL-X global_orient/transl through the
same rigid transform (pelvis-aware, since SMPL-X translation is not the pelvis).

Parity targets: reference data_loaders/motion_representation.py:47-184 and
utils/other_utils.py:189-240 (update_globalRT_for_smplx).
"""

from __future__ import annotations

import math

import numpy as np
from scipy.spatial.transform import Rotation as R

# r_hip, l_hip, sdr_r, sdr_l (cano convention — note the encoder's different
# unpacking order; see encode.py)
_FACE_JOINTS = (2, 1, 17, 16)


def update_global_rt(
    smplx_params: dict, transf_matrix: np.ndarray, delta_t: np.ndarray
) -> dict:
    """Rewrite global_orient/transl so the body is rigidly moved by transf_matrix.

    delta_t: [T, 3] pelvis offset = joints[:, 0] - transl (pelvis location of
    the zero-orient, zero-transl body depends on betas).
    """
    t = len(smplx_params["transl"])
    body_r = R.from_rotvec(smplx_params["global_orient"]).as_matrix()  # [T, 3, 3]
    body_mat = np.zeros((t, 4, 4))
    body_mat[:, :3, :3] = body_r
    body_mat[:, :3, 3] = smplx_params["transl"] + delta_t
    body_mat[:, 3, 3] = 1.0

    new_mat = transf_matrix[None] @ body_mat
    out = dict(smplx_params)
    out["global_orient"] = R.from_matrix(new_mat[:, :3, :3]).as_rotvec().reshape(-1, 3)
    out["transl"] = (new_mat[:, :3, 3] - delta_t).reshape(-1, 3)
    return out


def cano_seq_smplx(
    positions: np.ndarray,
    smplx_params: dict,
    preset_floor_height: float | None = None,
    return_transf_mat: bool = False,
):
    """Canonicalize a z-up sequence (AMASS / PROX).

    positions: [T, 22, 3] z-up joints. Returns (cano_positions,
    cano_smplx_params[, transf_matrix 4x4]).
    """
    pos = positions.copy()
    r_hip, l_hip, sdr_r, sdr_l = _FACE_JOINTS

    floor = preset_floor_height if preset_floor_height is not None else pos.min(axis=(0, 1))[2]
    pos[:, :, 2] -= floor

    root_xy = pos[0, 0] * np.array([1.0, 1.0, 0.0])
    pos = pos - root_xy

    j0 = pos[0]
    across = (j0[r_hip] - j0[l_hip]) + (j0[sdr_r] - j0[sdr_l])
    across[2] = 0.0
    x_axis = across / np.linalg.norm(across)
    z_axis = np.array([0.0, 0.0, 1.0])
    y_axis = np.cross(z_axis, x_axis)
    y_axis /= np.linalg.norm(y_axis)
    rot = np.stack([x_axis, y_axis, z_axis], axis=1)  # [3, 3] columns are new axes
    pos = pos @ rot

    m1 = np.eye(4)
    m1[:3, 3] = [-root_xy[0], -root_xy[1], -floor]
    m2 = np.eye(4)
    m2[:3, :3] = rot.T
    transf = m2 @ m1

    delta_t = positions[:, 0] - smplx_params["transl"]
    cano_params = update_global_rt(smplx_params, transf, delta_t)
    if return_transf_mat:
        return pos, cano_params, transf
    return pos, cano_params
