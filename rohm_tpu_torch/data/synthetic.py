"""Deterministic synthetic motion sequences and data trees for tests and
benchmarks.

The port of rohm_tpu/data/synthetic.py: the same numpy generators (one
seed, the same params in both packages) and the same AMASS, PROX and
EgoBody trees, with forward kinematics through the port's torch body model
on the model's device. Real AMASS/PROX/EgoBody data and SMPL-X weights are
not shipped; these produce
kinematically-consistent sequences (params + FK joints from the same body
model) so every pipeline stage runs with realistic shapes and dynamics.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch

from rohm_tpu_torch.body.model import NUM_BODY_JOINTS, SmplxModel, forward_joints


@torch.no_grad()
def _fk_positions(model: SmplxModel, params: dict) -> np.ndarray:
    """One FK call over params with a flat leading dim [N, ...], in f32 on
    the body model's device."""
    dev = model.v_template.device

    def t(k):
        return torch.as_tensor(np.asarray(params[k]), dtype=torch.float32, device=dev)

    joints = forward_joints(model, t("betas"), t("global_orient"), t("body_pose"), t("transl"),
                            num_joints=NUM_BODY_JOINTS)
    return joints.cpu().numpy().astype(np.float64)


def _stance_time_warp(num_frames: int) -> tuple[np.ndarray, np.ndarray]:
    """Speed profile + pelvis z-dip for periodic stance phases.

    Returns (w [T] — per-frame motion-speed factor, dipping to ~0.02 during
    8-frame holds via raised-cosine ramps; z_dip [T] — smooth 0.2 m pelvis
    drop synchronized with the holds). Sampling the smooth base motion at
    warped time cumsum(w) makes the whole body nearly still during a hold
    (foot vel² < 5e-5, the foot_detect velocity gate, reference
    motion_representation.py:23-44) while keeping velocities/accelerations
    C¹-smooth. A hard freeze + z-teleport would create accel spikes the
    shipped smoothness losses fight: a curriculum-trained TrajNet plateaus
    ~4x WORSE than the noisy input on such data (measured with the JAX
    package)."""
    w = np.ones(num_frames)
    z_dip = np.zeros(num_frames)
    # period 17 == the tests' clip_len: every carved clip sees the stance at
    # the same in-clip frames, so contact labels are frame-consistent across
    # clips and a small model can actually learn them (with an unaligned
    # period the stance phase drifts per clip and tiny-budget training
    # hedges contact predictions at the base rate, never crossing the 0.5
    # guidance threshold, as measured with the JAX package)
    period, ramp, flat = 17, 3, 6
    hold = 2 * ramp + flat
    for start in range(4, num_frames - hold, period):
        up = 0.5 - 0.5 * np.cos(np.linspace(0, np.pi, ramp + 1)[1:])  # 0 -> 1
        prof = np.concatenate([up, np.ones(flat), up[::-1]])  # [hold]
        w[start:start + hold] = 1.0 - 0.98 * prof
        z_dip[start:start + hold] = 0.2 * prof
    return w, z_dip


def _synthetic_params(
    num_frames: int, seed: int, walk_speed: float = 0.02, grounded: bool = False
) -> dict:
    """Host-only smooth-motion smplx params for one clip (no device work).

    grounded=True inserts smooth stance phases (see _stance_time_warp) so
    foot-contact labels and skating metrics are non-vacuous."""
    rng = np.random.default_rng(seed)
    if grounded:
        w, z_dip = _stance_time_warp(num_frames)
        t = (np.cumsum(w) - w[0])[:, None]  # warped time, starts at 0
    else:
        w, z_dip = np.ones(num_frames), np.zeros(num_frames)
        t = np.arange(num_frames)[:, None]

    # smooth body pose: sum of low-frequency sinusoids per dof
    freqs = rng.uniform(0.02, 0.12, size=(1, 63))
    phases = rng.uniform(0, 2 * np.pi, size=(1, 63))
    amps = rng.uniform(0.05, 0.35, size=(1, 63))
    if grounded:
        # Damp the torso chain (spine1/2/3, neck, both collars — SMPL-X
        # joints 3,6,9,12,13,14; body_pose dofs (j-1)*3..) so the
        # hips+shoulders-derived forward direction (reference
        # motion_representation.py:204-210) is stable, as it is for real
        # humans. Full-amplitude random spine twists make the per-frame
        # forward estimate wander tens of degrees, which puts a step
        # discontinuity into the canonicalized root_rot_angle (frame 0 is
        # pinned to 0 by cano, the rest of the clip sits at the wander
        # offset) — unlearnable for the TrajNet and unlike any mocap.
        amps = amps.copy()
        for j in (3, 6, 9, 12, 13, 14):
            amps[:, (j - 1) * 3:(j - 1) * 3 + 3] *= 0.15
    body_pose = (amps * np.sin(2 * np.pi * freqs * t + phases)).astype(np.float64)

    # heading slowly turning about z (z-up world), slight tilt wobble
    heading = 0.5 * np.sin(2 * np.pi * 0.01 * t[:, 0]) + rng.uniform(-np.pi, np.pi)
    tilt = 0.05 * np.sin(2 * np.pi * 0.03 * t[:, 0])
    global_orient = np.stack(
        [np.full(num_frames, np.pi / 2) + tilt, np.zeros(num_frames), heading], axis=-1
    )

    # walking path in xy, height bobbing; xy advance scales with the stance
    # speed factor so the body stops walking while it stands
    step = walk_speed * np.stack([np.cos(heading), np.sin(heading)], axis=-1)
    step = step * w[:, None]
    xy = np.cumsum(step, axis=0) + rng.normal(scale=1.0, size=(1, 2))
    z = 0.95 + 0.02 * np.sin(2 * np.pi * 0.07 * t[:, 0]) - z_dip
    transl = np.concatenate([xy, z[:, None]], axis=-1)

    betas = np.tile(rng.normal(scale=0.5, size=(1, 10)), (num_frames, 1))

    return {
        "global_orient": global_orient,
        "transl": transl,
        "body_pose": body_pose,
        "betas": betas,
    }


def synthetic_motion(
    model: SmplxModel,
    num_frames: int = 145,
    seed: int = 0,
    walk_speed: float = 0.02,
    grounded: bool = False,
) -> tuple[np.ndarray, dict]:
    """Generate one smooth motion clip.

    Returns (positions [T, 22, 3] z-up world joints, smplx_params dict with
    global_orient [T,3] / transl [T,3] / body_pose [T,63] / betas [T,10]).
    """
    params = _synthetic_params(num_frames, seed, walk_speed, grounded=grounded)
    return _fk_positions(model, params), params


def synthetic_clip_batch(
    model: SmplxModel, batch_size: int = 4, num_frames: int = 145, seed: int = 0,
    grounded: bool = False,
) -> tuple[np.ndarray, dict]:
    """Batch of clips: (positions [B, T, 22, 3], params dict of [B, T, ...]).

    All clips go through one FK call ([B*T] flat)."""
    plist = [_synthetic_params(num_frames, seed + i, grounded=grounded)
             for i in range(batch_size)]
    params = {k: np.stack([p[k] for p in plist]) for k in plist[0]}
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in params.items()}
    positions = _fk_positions(model, flat).reshape(batch_size, num_frames, 22, 3)
    return positions, params


def params_to_flat178(params: dict) -> np.ndarray:
    """Pack a params dict into the [T, 178] preprocessed-AMASS layout
    (3 global_orient + 3 transl + 10 betas + 63 body_pose + 90 hands +
    9 jaw/eyes, reference preprocessing_amass.py:74 / dataloader_amass.py:145-149)."""
    t = len(params["transl"])
    flat = np.zeros((t, 178), np.float64)
    flat[:, 0:3] = params["global_orient"]
    flat[:, 3:6] = params["transl"]
    flat[:, 6:16] = params["betas"]
    flat[:, 16:79] = params["body_pose"]
    return flat


def synthetic_amass_arrays(
    model: SmplxModel, n_clips: int = 4, clip_len: int = 145, seed: int = 0,
    grounded: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """(joints [N, T, 25, 3], params [N, T, 178]) ready for AmassClipDataset."""
    positions, params = synthetic_clip_batch(model, n_clips, clip_len, seed, grounded=grounded)
    joints25 = np.zeros((n_clips, clip_len, 25, 3))
    joints25[:, :, :22] = positions
    flat = np.stack([params_to_flat178({k: params[k][i] for k in params}) for i in range(n_clips)])
    return joints25, flat


def write_synthetic_amass(
    root: str,
    model: SmplxModel,
    datasets: dict[str, int] | None = None,
    seq_len: int = 300,
    seed: int = 0,
    grounded: bool = False,
) -> None:
    """Write a synthetic preprocessed-AMASS tree (pose_data_fps_30/ +
    smpl_data_fps_30/) so the CLIs run end-to-end without real data."""
    datasets = datasets or {"SynthA": 3, "SynthB": 2}
    total = sum(datasets.values())
    all_pos, all_params = synthetic_clip_batch(model, total, seq_len, seed, grounded=grounded)
    i = 0
    for dataset_name, n_seqs in datasets.items():
        for s in range(n_seqs):
            positions = all_pos[i]
            params = {k: v[i] for k, v in all_params.items()}
            i += 1
            joints25 = np.zeros((seq_len, 25, 3))
            joints25[:, :22] = positions
            flat = params_to_flat178(params)
            seq_dir = f"seq{s:03d}"
            jdir = os.path.join(root, "pose_data_fps_30", dataset_name, seq_dir)
            pdir = os.path.join(root, "smpl_data_fps_30", dataset_name, seq_dir)
            os.makedirs(jdir, exist_ok=True)
            os.makedirs(pdir, exist_ok=True)
            np.save(os.path.join(jdir, "motion.npy"), joints25)
            np.save(os.path.join(pdir, "motion.npy"), flat)


def _write_frame_params(path_dir: str, params: dict, i: int) -> None:
    """One frame's init (or GT) params as `<dir>/000.pkl`, [1, k] float32."""
    os.makedirs(path_dir, exist_ok=True)
    payload = {k: params[k][i : i + 1].astype(np.float32)
               for k in ("global_orient", "transl", "betas", "body_pose")}
    with open(os.path.join(path_dir, "000.pkl"), "wb") as f:
        pickle.dump(payload, f, protocol=2)


def _write_keypoints(path: str, joints: np.ndarray, focal: float) -> None:
    """OpenPose BODY_25 json of camera-coord joints [22, 3] through a pinhole
    (principal point 960, 540), confidence 0.9 on every SMPL-X slot."""
    from rohm_tpu_torch.data.video import OPENPOSE_TO_SMPL

    z = np.maximum(np.abs(joints[:, 2]), 0.5)
    uv = joints[:, :2] / z[:, None] * focal + np.array([960.0, 540.0])
    # scatter smpl-topology keypoints back into BODY_25 slots
    kp25 = np.zeros((25, 3))
    for smpl_j, op_j in enumerate(OPENPOSE_TO_SMPL):
        kp25[op_j, :2] = uv[smpl_j]
        kp25[op_j, 2] = 0.9
    with open(path, "w") as f:
        json.dump({"people": [{"pose_keypoints_2d": kp25.reshape(-1).tolist()}]}, f)


def write_synthetic_prox(
    init_root: str,
    base_dir: str,
    model: SmplxModel,
    recording_name: str = "MPH11_00034_01",
    n_frames: int = 40,
    seed: int = 0,
) -> None:
    """Write a synthetic PROX-format recording tree (per-frame 000.pkl params,
    cam2world json, Color.json intrinsics, OpenPose keypoint jsons,
    mask_joint.npy) so the video pipeline runs end-to-end without real data.

    The body moves in CAMERA coordinates here (the loader lifts to world)."""
    scene_name = recording_name.split("_")[0]
    positions, params = synthetic_motion(model, n_frames, seed)

    results_dir = os.path.join(init_root, recording_name, "results")
    for i in range(n_frames):
        _write_frame_params(os.path.join(results_dir, f"s001_frame_{i + 1:05d}"), params, i)

    # camera extrinsics/intrinsics
    os.makedirs(os.path.join(base_dir, "cam2world"), exist_ok=True)
    cam2world = np.eye(4)
    cam2world[:3, 3] = [0.1, -0.2, 0.05]
    with open(os.path.join(base_dir, "cam2world", scene_name + ".json"), "w") as f:
        json.dump(cam2world.tolist(), f)
    os.makedirs(os.path.join(base_dir, "calibration"), exist_ok=True)
    color_cam = {
        "f": [1060.0, 1060.0],
        "c": [960.0, 540.0],
        "camera_mtx": [[1060.0, 0.0, 960.0], [0.0, 1060.0, 540.0], [0.0, 0.0, 1.0]],
        "k": [0.0, 0.0, 0.0, 0.0, 0.0],
    }
    with open(os.path.join(base_dir, "calibration", "Color.json"), "w") as f:
        json.dump(color_cam, f)

    # keypoints: project camera-coord joints through the pinhole
    kp_dir = os.path.join(base_dir, "keypoints_openpose", recording_name)
    os.makedirs(kp_dir, exist_ok=True)
    for i in range(n_frames):
        _write_keypoints(os.path.join(kp_dir, f"s001_frame_{i + 1:05d}_keypoints.json"), positions[i], 1060.0)

    # depth-test visibility mask: all visible except an occluded leg window
    mask = np.ones((n_frames, 25), np.int64)
    occ_start = n_frames // 4
    for j in (1, 4, 7, 10):
        mask[occ_start : occ_start + 10, j] = 0
    mask_dir = os.path.join(base_dir, "mask_joint", recording_name)
    os.makedirs(mask_dir, exist_ok=True)
    np.save(os.path.join(mask_dir, "mask_joint.npy"), mask)


def write_synthetic_egobody(
    init_root: str,
    base_dir: str,
    model: SmplxModel,
    recording_name: str = "recording_20211004_S12_S20_01",
    scene_name: str = "seminar_g110",
    view: str = "sub_1",
    n_frames: int = 40,
    seed: int = 0,
) -> None:
    """Write a synthetic EgoBody-format tree: info/splits CSVs, kinect
    calibration chain, per-frame init + GT pkls, cleaned keypoints, masks."""
    body_idx = 0
    positions, params = synthetic_motion(model, n_frames, seed)

    # csvs
    os.makedirs(base_dir, exist_ok=True)
    with open(os.path.join(base_dir, "egobody_rohm_info.csv"), "w") as f:
        f.write("recording_name,target_idx,target_gender,view,scene_name,body_idx_fpv\n")
        f.write(f"{recording_name},{body_idx},female,{view},{scene_name},0 female\n")
    with open(os.path.join(base_dir, "data_splits.csv"), "w") as f:
        f.write("train,val,test\n")
        f.write(f",,{recording_name}\n")

    # calibration chain: master->world and sub->master
    calib = os.path.join(base_dir, "calibrations", recording_name, "cal_trans")
    os.makedirs(os.path.join(calib, "kinect12_to_world"), exist_ok=True)
    m2w = np.eye(4)
    m2w[:3, 3] = [0.2, 0.1, -0.1]
    with open(os.path.join(calib, "kinect12_to_world", scene_name + ".json"), "w") as f:
        json.dump({"trans": m2w.tolist()}, f)
    s2m = np.eye(4)
    s2m[:3, 3] = [0.05, 0.0, 0.02]
    with open(os.path.join(calib, "kinect_11to12_color.json"), "w") as f:
        json.dump({"trans": s2m.tolist()}, f)

    cam_dir = os.path.join(base_dir, "kinect_cam_params", f"kinect_{view}")
    os.makedirs(cam_dir, exist_ok=True)
    with open(os.path.join(cam_dir, "Color.json"), "w") as f:
        json.dump({"f": [980.0, 980.0], "c": [960.0, 540.0]}, f)

    # per-frame init + GT pkls (the same motion for both; the loader runs
    # the GT through the gendered model, here the same synthetic body)
    fit_dir = os.path.join(init_root, recording_name, f"body_idx_{body_idx}", "results")
    gt_dir = os.path.join(
        base_dir, "smplx_interactee_test", recording_name, f"body_idx_{body_idx}", "results"
    )
    kp_dir = os.path.join(base_dir, "keypoints_cleaned", recording_name, view)
    os.makedirs(kp_dir, exist_ok=True)
    for i in range(n_frames):
        frame_name = f"frame_{i + 1:05d}"
        for d in (fit_dir, gt_dir):
            _write_frame_params(os.path.join(d, frame_name), params, i)
        _write_keypoints(os.path.join(kp_dir, frame_name + "_keypoints.json"), positions[i], 980.0)

    mask = np.ones((n_frames, 25), np.int64)
    mask_dir = os.path.join(base_dir, "mask_joint", recording_name, view)
    os.makedirs(mask_dir, exist_ok=True)
    np.save(os.path.join(mask_dir, "mask_joint.npy"), mask)


# raw AMASS tree: dataset -> [(sequence dir, recording name, fps, layout,
# gender, kept by preprocessing_amass)], one file for each rule that drops one
RAW_AMASS_SEQUENCES = {
    "ACCAD": [("s01", "walk_poses", 120.0, "release", "neutral", True),  # stride 4
              ("s01", "neutral_stagei", 120.0, "release", "neutral", False)],  # skipped by name
    "CMU": [("s02", "run_poses", 60.0, "flat", "neutral", True),  # stride 2, the flat 'poses' layout
            ("s02", "jump_poses", 60.0, "flat", "female", False)],  # not neutral
    "SSM": [("s03", "dance_poses", 59.9944, "release", "neutral", True)],  # SSM's fractional fps: stride 2
    "BMLrub": [("rub001", "rub001_treadmill_fast", 120.0, "release", "neutral", False)],  # skipped by name
    "KIT": [("s04", "turn_poses", 100.0, "release", "neutral", False)],  # no integer stride to 30 fps
}


def write_synthetic_amass_raw(root: str, n_frames: int = 48, seed: int = 0) -> int:
    """Write a raw AMASS tree (`<root>/<dataset>/<seq>/<name>.npz`, the
    release's keys: mocap_frame_rate, gender, surface_model_type, trans,
    betas and either root_orient/pose_body/pose_hand/pose_jaw/pose_eye or
    the flat 165-d 'poses') for preprocessing_amass, from smooth synthetic
    motion with small random hand, jaw and eye rotations: the sequences of
    RAW_AMASS_SEQUENCES, `n_frames` each. Returns how many of them
    preprocessing_amass keeps."""
    kept = 0
    for d, (dataset, seqs) in enumerate(RAW_AMASS_SEQUENCES.items()):
        for s, (seq_dir, name, fps, layout, gender, keep) in enumerate(seqs):
            rng = np.random.default_rng(seed + 100 * d + s)
            p = _synthetic_params(n_frames, seed=seed + 100 * d + s)
            hands, jaw, eye = (rng.normal(scale=0.1, size=(n_frames, k)) for k in (90, 3, 6))
            out = {"mocap_frame_rate": np.float64(fps), "gender": np.array(gender),
                   "surface_model_type": np.array("smplx"), "trans": p["transl"],
                   "betas": np.concatenate([p["betas"][0], rng.normal(size=6)])}
            if layout == "release":
                out.update(root_orient=p["global_orient"], pose_body=p["body_pose"], pose_hand=hands,
                           pose_jaw=jaw, pose_eye=eye)
            else:
                out["poses"] = np.concatenate(
                    [p["global_orient"], p["body_pose"], jaw, eye[:, :3], eye[:, :3], hands], axis=-1)
            os.makedirs(os.path.join(root, dataset, seq_dir), exist_ok=True)
            np.savez(os.path.join(root, dataset, seq_dir, name + ".npz"), **out)
            kept += keep
    return kept
