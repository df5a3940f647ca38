"""Benchmark metrics, formula-exact vs the reference eval scripts.

A copy of rohm_tpu/evals/metrics.py (reference eval_amass_full.py:72-147:
MPJPE, contact accuracy, skating, acceleration, ground penetration;
eval_prox_egobody.py:184-272: the fixed-floor skating and penetration,
the acceleration magnitude and EgoBody's MPJPE set; test_trajnet.py:332-366:
the root diagnostics). Pure numpy on [n_seq, T, 22, 3] joint arrays in
meters, 30 fps.
"""

from __future__ import annotations

import numpy as np

FPS = 30
FOOT_JOINTS = [7, 10, 8, 11]  # l_ankle, l_toe, r_ankle, r_toe
TOE_JOINTS = [10, 11]
LOWER_BODY = np.array([1, 2, 4, 5, 7, 8, 10, 11])
UPPER_BODY = np.array([3, 6, 9, 12, 13, 14, 15, 16, 17, 18, 19, 20])


def mpjpe_global(clean: np.ndarray, rec: np.ndarray) -> float:
    """Mean per-joint global position error in meters."""
    return float(np.linalg.norm(clean - rec, axis=-1).mean())


def mpjpe_masked(
    clean: np.ndarray,
    rec: np.ndarray,
    mask_scheme: str,
    traj_mask_ratio: float = 0.0,
    infill_start: int = 65,
) -> tuple[float, float]:
    """(visible, occluded) MPJPE under the eval mask scheme
    (eval_amass_full.py:74-88). 'lower'/'upper' split by joints; 'full' splits
    by the fixed infill window."""
    err = np.linalg.norm(clean - rec, axis=-1)  # [n, T, 22]
    if mask_scheme in ("lower", "upper"):
        occ = LOWER_BODY if mask_scheme == "lower" else UPPER_BODY
        vis = np.asarray(sorted(set(range(22)) - set(occ.tolist())))
        return float(err[:, :, vis].mean()), float(err[:, :, occ].mean())
    if mask_scheme == "full":
        start = infill_start
        end = start + int(traj_mask_ratio * 145)
        vis = np.concatenate([err[:, :start], err[:, end:]], axis=1)
        return float(vis.mean()), float(err[:, start:end].mean())
    raise ValueError(f"bad mask_scheme {mask_scheme}")


def contact_label_accuracy(repr_clean: np.ndarray, repr_rec: np.ndarray) -> float:
    """Thresholded agreement of the 4 contact dims (eval_amass_full.py:91-96)."""
    rec = (repr_rec[:, :, -4:] > 0.5).astype(np.float32)
    gt = repr_clean[:, :, -4:]
    return float((gt == rec).mean())


def _skating_mask(joints: np.ndarray, min_height: np.ndarray, up_axis: int = 2,
                  thresh_vel: float = 0.10, thresh_height: float = 0.10) -> np.ndarray:
    """Per-frame skating indicator [n, T-1] (eval_amass_full.py:99-132).

    A foot skates when BOTH its joints move horizontally > thresh_vel while
    low (ankle < 0.15, toe < 0.10 above the sequence floor); the reference
    reports the AND over both feet.
    """
    horiz = [a for a in range(3) if a != up_axis]
    foot = joints[:, :, FOOT_JOINTS, :]  # [n, T, 4, 3]
    disp = foot[:, 1:][..., horiz] - foot[:, :-1][..., horiz]
    vel = np.linalg.norm(disp, axis=-1) * FPS  # [n, T-1, 4]
    height = foot[:, :-1, :, up_axis] - min_height[:, None, None]
    left = (vel[:, :, 0] > thresh_vel) & (vel[:, :, 1] > thresh_vel) & \
           (height[:, :, 0] < thresh_height + 0.05) & (height[:, :, 1] < thresh_height)
    right = (vel[:, :, 2] > thresh_vel) & (vel[:, :, 3] > thresh_vel) & \
            (height[:, :, 2] < thresh_height + 0.05) & (height[:, :, 3] < thresh_height)
    return left & right


def skating_ratio(joints: np.ndarray, joints_for_floor: np.ndarray | None = None,
                  up_axis: int = 2) -> float:
    """Fraction of skating frames; floor height taken from joints_for_floor
    (the reference uses the GT sequence's min height for both gt and rec)."""
    ref = joints if joints_for_floor is None else joints_for_floor
    min_h = ref[..., up_axis].min(axis=(1, 2))  # [n]
    return float(_skating_mask(joints, min_h, up_axis).mean())


def accel_error(clean: np.ndarray, rec: np.ndarray) -> float:
    """Mean ||a_rec - a_gt|| in m/s^2, central finite difference x fps^2
    (eval_amass_full.py:135-138)."""
    acc = lambda j: (j[:, 2:] - 2 * j[:, 1:-1] + j[:, :-2]) * FPS**2
    return float(np.linalg.norm(acc(rec) - acc(clean), axis=-1).mean())


def accel_magnitude(rec: np.ndarray) -> float:
    """Mean ||a|| (PROX, no GT; eval_prox_egobody.py:212-217)."""
    acc = (rec[:, 2:] - 2 * rec[:, 1:-1] + rec[:, :-2]) * FPS**2
    return float(np.linalg.norm(acc, axis=-1).mean())


def ground_penetration(
    rec: np.ndarray, floor_joints: np.ndarray | None = None, up_axis: int = 2,
    thresh: float = 0.05,
) -> tuple[float, float]:
    """(freq, mean_dist) of toe joints below floor - thresh
    (eval_amass_full.py:141-147). dist is averaged over ALL frames (non-
    penetrating frames count as 0), matching the reference."""
    ref = rec if floor_joints is None else floor_joints
    min_h = ref[..., up_axis].min(axis=(1, 2))  # [n]
    pene = rec[:, :, TOE_JOINTS, up_axis] - min_h[:, None, None]
    freq = float((pene < -thresh).mean())
    dist = pene.copy()
    dist[dist >= 0] = 0.0
    return freq, float(dist.mean())


def skating_ratio_fixed_floor(joints: np.ndarray, ground_height: float, up_axis: int = 2) -> float:
    """Video-data skating: per-scene preset floor height, axis-aware
    (eval_prox_egobody.py:184-210; z-up for PROX, y-up for EgoBody)."""
    min_h = np.full(len(joints), ground_height)
    return float(_skating_mask(joints, min_h, up_axis).mean())


def ground_penetration_fixed_floor(
    rec: np.ndarray, ground_height: float, up_axis: int = 2, thresh: float = 0.05
) -> tuple[float, float]:
    """(freq, mean_dist<0) of toes below the preset floor
    (eval_prox_egobody.py:256-264)."""
    pene = rec[:, :, TOE_JOINTS, up_axis] - ground_height
    freq = float((pene < -thresh).mean())
    dist = pene.copy()
    dist[dist >= 0] = 0.0
    return freq, float(dist.mean())


def egobody_mpjpe_set(
    gt_scene: np.ndarray, rec_scene: np.ndarray, mask_joint_vis: np.ndarray
) -> dict:
    """G-MPJPE (global), MPJPE (root-relative), and vis/occ splits weighted by
    the per-joint visibility mask (eval_prox_egobody.py:229-254, :486-490)."""
    g = np.linalg.norm(gt_scene - rec_scene, axis=-1)  # [n, T, 22]
    local_gt = gt_scene - gt_scene[:, :, [0]]
    local_rec = rec_scene - rec_scene[:, :, [0]]
    err = np.linalg.norm(local_gt - local_rec, axis=-1)
    vis_sum = mask_joint_vis.sum()
    occ_sum = (1 - mask_joint_vis).sum()
    return {
        "gmpjpe": float(g.mean()),
        "mpjpe": float(err.mean()),
        "mpjpe_vis": float((err * mask_joint_vis).sum() / max(vis_sum, 1)),
        "mpjpe_occ": float((err * (1 - mask_joint_vis)).sum() / max(occ_sum, 1)),
    }


def trajnet_root_errors(
    root_clean: np.ndarray, root_rec: np.ndarray,
    rot_angle_clean: np.ndarray | None = None, rot_angle_rec: np.ndarray | None = None,
) -> dict:
    """TrajNet-only diagnostics (test_trajnet.py:332-366): per-axis root
    position error (m), heading error (deg), jitter (3rd derivative, m/s^3)."""
    out = {}
    diff = np.abs(root_clean - root_rec)
    out["root_x_err"] = float(diff[..., 0].mean())
    out["root_y_err"] = float(diff[..., 1].mean())
    out["root_z_err"] = float(diff[..., 2].mean())
    jitter = lambda p: float(
        np.linalg.norm(
            (p[:, 3:] - 3 * p[:, 2:-1] + 3 * p[:, 1:-2] - p[:, :-3]) * FPS**3, axis=-1
        ).mean()
    )
    out["root_jitter_rec"] = jitter(root_rec)
    out["root_jitter_gt"] = jitter(root_clean)
    if rot_angle_clean is not None:
        # repr stores the half-angle (arctan2 trick); x2 for the full heading.
        # No 360-deg wrap-around: the reference reports the raw absolute
        # difference (test_trajnet.py:233,339), so +179 vs -179 deg counts as 358
        d = np.rad2deg(np.abs(rot_angle_clean - rot_angle_rec)) * 2
        out["root_rot_err_deg"] = float(d.mean())
    return out
