"""Synthetic PROX recordings, made in set-up from the seed, and what the
PROX/EgoBody evaluation feeds `RohmPipeline.run_batch` for their windows.

A recording stands in for one PROX RGB recording and its `init_prox_rgb`
fits: a person walking loops around a room (the harness's grounded motion
generator for the body, a circular path with stance holds for the root),
seen by one static camera of its own (cam2world and intrinsics), with
OpenPose-style 2-D keypoints and confidences, per-frame joint visibility
(furniture hiding the legs or an arm for stretches of frames), the scene's
floor height, and a noisy per-frame init motion (the clean motion with the
evaluation's level-3 SMPL-X parameter noise). The recording is cut into
windows of clip_len frames overlapping by `overlap` frames, each
canonicalized with the preset floor height and encoded, as
data/video.py's VideoClipDataset does; the stats come from the clean
windows. Forward kinematics and the encoding run through the reference's
plain PyTorch on the device, in bulk. Both the port and the reference get
these arrays.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R

from harness.inputs import PARAM_NAMES, _stance_time_warp, clip_params, compute_stats, euler_noise_rotvec
from reference.body import forward_joints
from reference.canonicalize import cano_seq_smplx
from reference.encode import get_repr
from reference.schema import REPR_DIM_DICT, REPR_LIST, TRAJ_ABS_INDEX

# the guidance inputs of a batch, in RohmPipeline's GUIDANCE_DATA_KEYS order
CAMERA_KEYS = ("transf_matrix", "cam_r", "cam_t", "focal_length", "camera_center", "keypoints_2d")
LOWER_BODY = (1, 2, 4, 5, 7, 8, 10, 11)
LEFT_ARM, RIGHT_ARM = (16, 18, 20), (17, 19, 21)
KEYPOINT_CONF_THRESH = 0.2  # data/video.py: a keypoint under this confidence is not visible
PROX_FLOOR_RANGE = (-1.08, -0.34)  # the span of PROX's per-scene floor heights (data/video.py)


def expand_joint_visibility(mask: np.ndarray) -> np.ndarray:
    """Per-joint visibility [T, 22] (1 visible) -> the repr's [T, 294]
    (train/masking.py's expand_joint_visibility): trajectory and betas
    always visible; positions and velocities follow all 22 joints; the
    body pose joints 1..21; a foot's contact pair only where both of its
    joints are visible."""
    mask = np.asarray(mask, np.float32)
    t = mask.shape[0]
    parts = []
    for key in REPR_LIST:
        if key in ("local_positions", "local_vel"):
            parts.append(np.repeat(mask, 3, axis=1))
        elif key == "smplx_body_pose_6d":
            parts.append(np.repeat(mask[:, 1:], 6, axis=1))
        elif key == "foot_contact":
            fc = np.zeros((t, 4), np.float32)
            fc[(mask[:, 7] == 1) & (mask[:, 10] == 1), 0:2] = 1.0
            fc[(mask[:, 8] == 1) & (mask[:, 11] == 1), 2:4] = 1.0
            parts.append(fc)
        else:
            parts.append(np.ones((t, REPR_DIM_DICT[key]), np.float32))
    return np.concatenate(parts, axis=-1)


def _look_at(position: np.ndarray, target: np.ndarray) -> np.ndarray:
    """cam2world's rotation of a camera at `position` looking at `target`
    (z-up world; camera axes x right, y down, z forward, as OpenCV's)."""
    z = target - position
    z /= np.linalg.norm(z)
    x = np.cross(np.array([0.0, 0.0, -1.0]), z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z], axis=1)


def recording(frames: int, seed: int) -> dict:
    """One recording's clean motion (world, z-up), camera, floor, occluders
    and keypoint noise, drawn from the seed (host numpy)."""
    rng = np.random.default_rng(seed)
    p = clip_params(frames, int(rng.integers(0, 2**31 - 1)))
    w, z_dip = _stance_time_warp(frames)
    s = np.cumsum(w) - w[0]
    radius, speed = rng.uniform(0.8, 1.5), rng.uniform(0.008, 0.015)  # m, m per frame walking
    turn = rng.choice([-1.0, 1.0])
    theta = rng.uniform(0, 2 * np.pi) + turn * speed * s / radius
    room = rng.uniform(-1.0, 1.0, size=2)
    floor = rng.uniform(*PROX_FLOOR_RANGE)
    heading = theta + turn * np.pi / 2
    tilt = 0.05 * np.sin(2 * np.pi * 0.03 * s)
    orient = R.from_euler("z", heading[:, None]) * R.from_euler("x", (np.pi / 2 + tilt)[:, None])
    p["global_orient"] = orient.as_rotvec()
    p["transl"] = np.stack([room[0] + radius * np.cos(theta), room[1] + radius * np.sin(theta),
                            floor + 0.95 + 0.02 * np.sin(2 * np.pi * 0.07 * s) - z_dip], axis=-1)
    azimuth = rng.uniform(0, 2 * np.pi)
    distance = radius + rng.uniform(2.0, 3.0)
    position = np.array([room[0] + distance * np.cos(azimuth), room[1] + distance * np.sin(azimuth),
                         floor + rng.uniform(1.2, 2.2)])
    cam_r = _look_at(position, np.array([room[0], room[1], floor + 0.9]))
    fx = 1060.0 * rng.uniform(0.97, 1.03)
    focal = np.array([fx, fx * rng.uniform(0.995, 1.005)])
    center = np.array([960.0, 540.0]) + rng.uniform(-15.0, 15.0, size=2)
    occluded = np.zeros((frames, 22), bool)
    for _ in range(int(rng.integers(3, 7))):
        start, length = int(rng.integers(0, frames)), int(rng.integers(40, 200))
        joints = [LOWER_BODY, LOWER_BODY, LEFT_ARM, RIGHT_ARM][int(rng.integers(0, 4))]
        occluded[start:start + length, list(joints)] = True
    return {"params": p, "floor": floor, "cam_r": cam_r, "cam_t": position, "focal": focal, "center": center,
            "occluded": occluded, "rng": rng}


@torch.no_grad()
def make_recordings(body, n_rec: int, windows: int, clip_len: int, overlap: int, seed: int, noise: dict,
                    device) -> dict:
    """n_rec recordings of `windows` consecutive windows each, in recording
    order: the pipeline's inputs for every window (normalized with the
    stats of the clean windows) and the stats. Keys: traj_cond [N, T-1,
    13], traj_clean and pose_noisy [N, T-1, 294], pose_mask [N, T-2, 294],
    the CAMERA_KEYS (cam_r [N, 3, 3] and cam_t [N, 3] repeat each
    recording's camera on its windows), mean, std."""
    stride = clip_len - overlap
    frames = stride * (windows - 1) + clip_len
    rng = np.random.default_rng(seed)
    recs = [recording(frames, int(s)) for s in rng.integers(0, 2**31 - 1, size=n_rec)]

    def fk(p):
        return forward_joints(body, *(torch.as_tensor(p[k], dtype=torch.float32, device=device)
                                      for k in ("betas", "global_orient", "body_pose", "transl")),
                              num_joints=22).double()

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    out = {k: [] for k in ("clean", "noisy", "transf_matrix", "cam_r", "cam_t", "focal_length", "camera_center",
                           "keypoints_2d", "pose_mask")}
    for rec in recs:
        p, r = rec["params"], rec["rng"]
        joints = fk(p)
        lift = rec["floor"] + 0.05 - float(joints[..., 2].min())  # the lowest joint 5 cm over the floor
        p["transl"] = p["transl"] + np.array([0.0, 0.0, lift])
        joints = joints + dev([0.0, 0.0, lift])
        shape = (frames,)
        noisy = {
            "transl": p["transl"] + r.normal(0.0, noise["transl"], shape + (3,)),
            "betas": p["betas"] + r.normal(0.0, noise["betas"], shape + (10,)),
            "global_orient": euler_noise_rotvec(dev(p["global_orient"]), dev(
                r.normal(0.0, noise["global_orient_deg"], shape + (3,)))).cpu().numpy(),
            "body_pose": euler_noise_rotvec(dev(p["body_pose"].reshape(frames, 21, 3)), dev(
                r.normal(0.0, noise["body_pose_deg"], shape + (21, 3)))).reshape(frames, 63).cpu().numpy(),
        }
        joints_noisy = fk(noisy).cpu().numpy()
        # keypoints: the clean joints through the camera, pixel noise, confidences
        cam = (joints.cpu().numpy() - rec["cam_t"]) @ rec["cam_r"]
        uv = cam[..., :2] / cam[..., 2:3] * rec["focal"] + rec["center"]
        occ = rec["occluded"]
        conf = np.where(occ, r.uniform(0.0, 0.3, occ.shape), r.uniform(0.5, 1.0, occ.shape))
        uv = uv + r.normal(0.0, 1.0, uv.shape) * np.where(occ, 20.0, 3.0)[..., None]
        keypoints = np.concatenate([uv, conf[..., None]], axis=-1)
        visible = ((conf > KEYPOINT_CONF_THRESH) & ~occ).astype(np.float32)
        joints = joints.cpu().numpy()
        for k in range(windows):
            s, e = k * stride, k * stride + clip_len
            for key, pos, prm in (("clean", joints, p), ("noisy", joints_noisy, noisy)):
                cano_pos, cano_prm, transf = cano_seq_smplx(pos[s:e], {n: prm[n][s:e] for n in PARAM_NAMES},
                                                            preset_floor_height=rec["floor"], return_transf_mat=True)
                out[key].append((cano_pos, {n: cano_prm[n].reshape(clip_len, -1) for n in PARAM_NAMES}))
            out["transf_matrix"].append(transf)  # the noisy (input) window's, as the loader's
            out["cam_r"].append(rec["cam_r"])
            out["cam_t"].append(rec["cam_t"])
            out["focal_length"].append(rec["focal"])
            out["camera_center"].append(rec["center"])
            out["keypoints_2d"].append(keypoints[s:e])
            mask = expand_joint_visibility(visible[s:e])[: clip_len - 2]
            mask[..., -4:] = 0.0
            out["pose_mask"].append(mask)

    def encode(items):
        pos = torch.as_tensor(np.stack([a for a, _ in items]), dtype=torch.float32, device=device)
        prm = {n: torch.as_tensor(np.stack([b[n] for _, b in items]), dtype=torch.float32, device=device)
               for n in PARAM_NAMES}
        return get_repr(pos, global_orient=prm["global_orient"], transl=prm["transl"], body_pose=prm["body_pose"],
                        betas=prm["betas"]).cpu().numpy()

    repr_clean, repr_noisy = encode(out.pop("clean")), encode(out.pop("noisy"))
    mean, std = compute_stats(repr_clean)
    noisy_n = ((repr_noisy - mean) / std).astype(np.float32)
    arrays = {k: np.asarray(np.stack(v), np.float32) for k, v in out.items()}
    return {"traj_cond": np.ascontiguousarray(noisy_n[..., TRAJ_ABS_INDEX]), "traj_clean": noisy_n,
            "pose_noisy": noisy_n, **arrays, "mean": mean, "std": std}
