"""PROX / EgoBody video clip dataset.

The port of rohm_tpu/data/video.py (reference
data_loaders/dataloader_video.py:11-498). Per-frame init SMPL-X pkls are
read on the host, then all frames go through batched FK on the dataset's
device, and all windows through one batched encoding (the reference calls
the torch smplx model once per frame). Keypoint undistortion, and the
distorted projection the occlusion-mask tool uses, are numpy (OpenCV's
model and its iteration, without cv2) and the EgoBody CSVs are
read with the `csv` module (no pandas); `__getitem__` emits fixed-shape
float32 arrays.

Item dict (dataloader_video.py:421-498):
  motion_repr_noisy [T-1, 294] normalized   noisy_joints [T, 22, 3] (cano)
  noisy_joints_scene_coord [T, 22, 3]       transf_matrix [4, 4]
  focal_length [2] / camera_center [2]      keypoints_2d [T, 22, 3]
  mask_joint_vis [T, 22]                    mask_vec_vis [T-1, 294]
  cond / control_cond (traj task)           gt_joints_scene_coord (egobody)
"""

from __future__ import annotations

import copy
import csv
import hashlib
import json
import os
import pickle

import numpy as np
import torch

from rohm_tpu_torch.body.model import SmplxModel
from rohm_tpu_torch.data.amass import _chunked, _encode_fn, _fk_fn, _walk_fingerprint, model_fingerprint
from rohm_tpu_torch.data.clips import overlapping_windows, pad_tail_size
from rohm_tpu_torch.reprs.canonicalize import cano_seq_smplx, cano_seq_smplx_egobody, update_global_rt
from rohm_tpu_torch.reprs.schema import gather_traj_abs
from rohm_tpu_torch.reprs.stats import load_stats
from rohm_tpu_torch.train.masking import expand_joint_visibility

# per-scene floor heights (reference utils/other_utils.py:41-60)
PROX_FLOOR_HEIGHT = {
    "N0Sofa": -0.9843093165454873,
    "MPH1Library": -0.34579620031341207,
    "N3Library": -0.6736229583361132,
    "N3Office": -0.7772727989022952,
    "BasementSittingBooth": -0.767080139846674,
    "MPH8": -0.41432886722717904,
    "MPH11": -0.7169139211234009,
    "MPH16": -0.8408992040141058,
    "MPH112": -0.6419028605753081,
    "N0SittingBooth": -0.6677103008966809,
    "N3OpenArea": -1.0754909672969915,
    "Werkraum": -0.6777057869851316,
}
EGOBODY_FLOOR_HEIGHT = {  # y-up
    "seminar_g110": -1.660,
    "seminar_d78": -0.810,
    "seminar_j716": -0.8960,
    "seminar_g110_0315": -0.73,
    "seminar_d78_0318": -1.03,
    "seminar_g110_0415": -0.77,
}

# openpose BODY_25 index for each smpl joint (dataloader_video.py:50)
OPENPOSE_TO_SMPL = [8, 12, 9, 8, 13, 10, 8, 14, 11, 1, 20, 23, 1, 5, 2, 0, 5, 2, 6, 3, 7, 4][:22]

JOINTS_NUM = 22
FK_CHUNK = 512  # frames per batched FK call
KEYPOINT_CONF_THRESH = 0.2
PROX_IMG_WIDTH = 1920
# cv2.undistortPoints' default stop: 5 iterations, no tolerance test
UNDISTORT_ITERATIONS = 5

_PARAM_KEYS = ("global_orient", "transl", "betas", "body_pose")


def _load_frame_params(pkl_path: str) -> dict:
    with open(pkl_path, "rb") as f:
        p = pickle.load(f)
    return {
        "global_orient": np.asarray(p["global_orient"], np.float64).reshape(-1)[:3],
        "transl": np.asarray(p["transl"], np.float64).reshape(-1)[:3],
        "betas": np.asarray(p["betas"], np.float64).reshape(-1)[:10],
        "body_pose": np.asarray(p["body_pose"], np.float64).reshape(-1)[:63],
    }


def _load_keypoints(path: str, body_idx: int) -> np.ndarray:
    try:
        with open(path) as f:
            data = json.load(f)
        if not data["people"]:
            return np.zeros((JOINTS_NUM, 3))
        kp = np.array(data["people"][body_idx]["pose_keypoints_2d"], np.float32).reshape(-1, 3)
        return kp[OPENPOSE_TO_SMPL]
    except (FileNotFoundError, KeyError, IndexError):
        return np.zeros((JOINTS_NUM, 3))


def _dist5(dist_coeffs) -> np.ndarray:
    """OpenCV's distortion vector as (k1, k2, p1, p2, k3) in float64: a
    shorter one is padded with zeros, and past the fifth the coefficients
    are not read."""
    k = np.zeros(5)
    dist = np.asarray(dist_coeffs, np.float64).reshape(-1)
    k[: min(len(dist), 5)] = dist[:5]
    return k


def undistort_points(points: np.ndarray, camera_mtx, dist_coeffs) -> np.ndarray:
    """cv2.undistortPoints(points, camera_mtx, dist_coeffs, P=camera_mtx) in
    float64 numpy, points [..., 2] in pixels: normalize by the intrinsics,
    invert the k1, k2, p1, p2[, k3] model by OpenCV's fixed-point iteration
    with its default stop (UNDISTORT_ITERATIONS steps; a point whose radial
    factor turns negative keeps its distorted coordinates, as OpenCV's does),
    then map back through the same matrix."""
    mtx = np.asarray(camera_mtx, np.float64)
    k = _dist5(dist_coeffs)
    k1, k2, p1, p2, k3 = k
    fx, fy, cx, cy = mtx[0, 0], mtx[1, 1], mtx[0, 2], mtx[1, 2]
    pts = np.asarray(points, np.float64)
    x0 = (pts[..., 0] - cx) * (1.0 / fx)
    y0 = (pts[..., 1] - cy) * (1.0 / fy)
    x, y = x0.copy(), y0.copy()
    if k.any():
        live = np.ones(x.shape, bool)
        for _ in range(UNDISTORT_ITERATIONS):
            r2 = x * x + y * y
            icdist = 1.0 / (1 + ((k3 * r2 + k2) * r2 + k1) * r2)
            live &= icdist >= 0
            dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
            dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
            x = np.where(live, (x0 - dx) * icdist, x0)
            y = np.where(live, (y0 - dy) * icdist, y0)
    # P @ [x, y, 1], divided by its third row
    w = 1.0 / (mtx[2, 0] * x + mtx[2, 1] * y + mtx[2, 2])
    u = (mtx[0, 0] * x + mtx[0, 1] * y + mtx[0, 2]) * w
    v = (mtx[1, 0] * x + mtx[1, 1] * y + mtx[1, 2]) * w
    return np.stack([u, v], axis=-1)


def project_points_distorted(points: np.ndarray, color_cam: dict) -> np.ndarray:
    """cv2.projectPoints(points, rvec=0, tvec=0, camera_mtx, k) in float64
    numpy: camera-frame points [N, 3] -> pixels [N, 2] through the k1, k2,
    p1, p2, k3 forward model of the PROX color camera (`color_cam` holds
    "camera_mtx" and "k"); OpenCV reads fx, fy, cx, cy of the matrix and
    takes a depth of 0 as 1."""
    mtx = np.asarray(color_cam["camera_mtx"], np.float64)
    k1, k2, p1, p2, k3 = _dist5(color_cam["k"])
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    z = pts[:, 2]
    inv_z = np.where(z != 0, 1.0 / np.where(z != 0, z, 1.0), 1.0)
    x, y = pts[:, 0] * inv_z, pts[:, 1] * inv_z
    r2 = x * x + y * y
    radial = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([mtx[0, 0] * xd + mtx[0, 2], mtx[1, 1] * yd + mtx[1, 2]], axis=-1)


def undistort_keypoints_prox(keypoints: np.ndarray, color_cam: dict) -> np.ndarray:
    """PROX keypoint undistortion with the flip/undistort/flip-back dance
    (dataloader_video.py:442-458); keypoints [T, 22, 3]."""
    kp = np.array(keypoints, np.float64)
    flipped = kp.copy()
    flipped[..., 0] = PROX_IMG_WIDTH - 1 - kp[..., 0]
    out = flipped.copy()
    out[..., :2] = undistort_points(flipped[..., :2], color_cam["camera_mtx"], color_cam["k"])
    out[..., 0] = PROX_IMG_WIDTH - 1 - out[..., 0]
    return out


def _read_csv_rows(path: str) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


class VideoClipDataset:
    """Overlapping-window clip dataset over one PROX/EgoBody recording.
    FK and the encoding run on `device` (default: the body model's); the
    EgoBody ground truth goes through the same (neutral) body model."""

    # the per-recording arrays a build derives (and the disk cache holds)
    _ARRAYS = ("joints_clip_world", "keypoints_clips", "joint_mask_clips", "cano_joints",
               "transf_matrix", "repr_input", "cam_r", "cam_t")

    def __init__(
        self,
        body_model: SmplxModel,
        dataset: str = "prox",
        init_root: str = "",
        base_dir: str = "",
        recording_name: str = "",
        use_scene_floor_height: bool = False,
        repr_abs_only: bool = False,
        task: str = "traj",
        overlap_len: int = 2,
        clip_len: int = 150,
        logdir: str | None = None,
        disk_cache_dir: str | None = None,
        device: torch.device | str | None = None,
    ):
        assert dataset in ("prox", "egobody"), f"bad dataset {dataset}"
        assert task in ("traj", "pose")
        self.dataset = dataset
        self.body_model = body_model
        self.recording_name = recording_name
        self.clip_len = clip_len
        self.overlap_len = overlap_len
        self.task = task
        self.repr_abs_only = repr_abs_only
        self.traj_feat_dim = 13 if repr_abs_only else 22
        self.pose_feat_dim = 272
        self.use_scene_floor_height = use_scene_floor_height
        self.device = torch.device(device) if device is not None else body_model.v_template.device

        # on-disk cache of the built recording (FK, canonicalization and
        # encoding are deterministic given the tree, the config, the body
        # model and the device type). Its own name, "video_torch_<key>.npz":
        # the JAX package caches "video_<key>.pkl" in the same directory,
        # and its arrays are never read here. No pickled objects inside.
        cache_path = None
        if disk_cache_dir is not None:
            key = self._disk_cache_key(init_root, base_dir)
            cache_path = os.path.join(disk_cache_dir, f"video_torch_{key}.npz")
        if cache_path is not None and os.path.exists(cache_path):
            self._load_disk_cache(cache_path)
        else:
            if dataset == "prox":
                self._read_prox(init_root, base_dir)
            else:
                self._read_egobody(init_root, base_dir)
            self._create_body_repr()
            if cache_path is not None:
                self._save_disk_cache(cache_path)

        assert logdir is not None, "video datasets need the train-stats logdir"
        self.mean, self.std = load_stats(logdir)

    def _disk_cache_key(self, init_root: str, base_dir: str) -> str:
        """Fingerprint: config + body model + the device type + listing
        (path/size/mtime) of every file under the init/base trees (cache dirs
        pruned). View config (task / repr_abs_only) is not keyed: views share
        the entry."""
        h = hashlib.sha1()
        cfg = dict(dataset=self.dataset, recording=self.recording_name,
                   clip_len=self.clip_len, overlap_len=self.overlap_len,
                   scene_floor=self.use_scene_floor_height,
                   model=model_fingerprint(self.body_model),
                   device=self.device.type)
        h.update(json.dumps(cfg, sort_keys=True).encode())
        for root in (init_root, base_dir):
            _walk_fingerprint(h, root)
        return h.hexdigest()[:16]

    def _save_disk_cache(self, path: str) -> None:
        payload = {k: getattr(self, k) for k in self._ARRAYS}
        for k in _PARAM_KEYS:
            payload[f"cano_{k}"] = self.cano_params[k]
        payload["frame_names"] = np.asarray(self.frame_name_list, dtype=str).reshape(self.n_samples, self.clip_len)
        payload["color_cam"] = np.asarray(json.dumps(self.color_cam))
        meta = {k: getattr(self, k) for k in ("scene_name", "scene_floor_height", "kinect_view",
                                              "body_idx", "gender_gt") if hasattr(self, k)}
        payload["meta"] = np.asarray(json.dumps(meta))
        if self.joints_clip_world_gt is not None:
            payload["joints_clip_world_gt"] = self.joints_clip_world_gt
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)

    def _load_disk_cache(self, path: str) -> None:
        with np.load(path, allow_pickle=False) as z:
            for k in self._ARRAYS:
                setattr(self, k, z[k])
            self.cano_params = {k: z[f"cano_{k}"] for k in _PARAM_KEYS}
            self.frame_name_list = [list(row) for row in z["frame_names"].tolist()]
            self.color_cam = json.loads(str(z["color_cam"]))
            self.__dict__.update(json.loads(str(z["meta"])))
            self.joints_clip_world_gt = z["joints_clip_world_gt"] if "joints_clip_world_gt" in z else None
        self.n_samples = len(self.repr_input)

    # ------------------------------------------------------------------
    def _fk_world(self, params: dict, cam_r: np.ndarray, cam_t: np.ndarray):
        """Batched FK for all frames + rigid lift to world coords.

        Returns (joints_world [T, 22, 3], params_world dict)."""
        joints_cam = _chunked(
            _fk_fn(self.body_model, JOINTS_NUM), len(params["transl"]), FK_CHUNK, self.device,
            params["betas"], params["global_orient"], params["body_pose"], params["transl"],
        ).astype(np.float64)  # [T, 22, 3]
        joints_world = joints_cam @ cam_r.T + cam_t

        cam2world = np.eye(4)
        cam2world[:3, :3] = cam_r
        cam2world[:3, 3] = cam_t
        delta_t = joints_cam[:, 0] - params["transl"]
        params_world = update_global_rt(params, cam2world, delta_t)
        params_world["betas"] = params["betas"]
        params_world["body_pose"] = params["body_pose"]
        return joints_world, params_world

    def _read_frames(self, fitting_dir: str, gt_dir: str | None, keypoint_path, body_idx: int):
        """Per-frame params (and GT params) and keypoints of a recording."""
        frame_names = sorted(os.listdir(fitting_dir))
        params = {k: [] for k in _PARAM_KEYS}
        params_gt = {k: [] for k in _PARAM_KEYS}
        keypoints = []
        for name in frame_names:
            p = _load_frame_params(os.path.join(fitting_dir, name, "000.pkl"))
            pg = _load_frame_params(os.path.join(gt_dir, name, "000.pkl")) if gt_dir else None
            for k in _PARAM_KEYS:
                params[k].append(p[k])
                if pg is not None:
                    params_gt[k].append(pg[k])
            keypoints.append(_load_keypoints(keypoint_path(name), body_idx))
        params = {k: np.stack(v) for k, v in params.items()}
        params_gt = {k: np.stack(v) for k, v in params_gt.items()} if gt_dir else None
        return frame_names, params, params_gt, np.stack(keypoints)

    def _read_prox(self, init_root: str, base_dir: str):
        fitting_dir = os.path.join(init_root, self.recording_name, "results")
        scene_name = self.recording_name.split("_")[0]
        self.scene_name = scene_name
        self.scene_floor_height = PROX_FLOOR_HEIGHT.get(scene_name)
        with open(os.path.join(base_dir, "cam2world", scene_name + ".json")) as f:
            cam2world = np.array(json.load(f))
        self.cam_r = cam2world[:3, :3]
        self.cam_t = cam2world[:3, 3]
        with open(os.path.join(base_dir, "calibration", "Color.json")) as f:
            self.color_cam = json.load(f)

        kp_dir = os.path.join(base_dir, "keypoints_openpose", self.recording_name)
        frame_names, params, _, keypoints = self._read_frames(
            fitting_dir, None, lambda name: os.path.join(kp_dir, name + "_keypoints.json"), 0)
        joints_world, params_world = self._fk_world(params, self.cam_r, self.cam_t)
        joint_mask = np.load(
            os.path.join(base_dir, "mask_joint", self.recording_name, "mask_joint.npy")
        )[:, :JOINTS_NUM]

        self._cut_windows(frame_names, joints_world, params_world, keypoints, joint_mask)

    def _read_egobody(self, init_root: str, base_dir: str):
        row = next(r for r in _read_csv_rows(os.path.join(base_dir, "egobody_rohm_info.csv"))
                   if r["recording_name"] == self.recording_name)
        self.kinect_view = row["view"]  # NOT `self.view` — that would shadow the view() method
        self.body_idx = int(row["target_idx"])
        self.scene_name = row["scene_name"]
        self.gender_gt = row["target_gender"]
        interactee_idx = int(str(row["body_idx_fpv"]).split(" ")[0])
        self.scene_floor_height = EGOBODY_FLOOR_HEIGHT.get(self.scene_name)

        # data_splits.csv: one column per split, of unequal lengths (blank cells)
        splits = _read_csv_rows(os.path.join(base_dir, "data_splits.csv"))
        split = None
        for s in ("train", "val", "test"):
            if any(r.get(s) == self.recording_name for r in splits):
                split = s
        assert split is not None, f"{self.recording_name} not in any split"
        role = "interactee" if self.body_idx == interactee_idx else "camera_wearer"
        fitting_gt_root = os.path.join(
            base_dir, f"smplx_{role}_{split}", self.recording_name, f"body_idx_{self.body_idx}"
        )

        calib_dir = os.path.join(base_dir, "calibrations", self.recording_name)
        with open(os.path.join(calib_dir, "cal_trans", "kinect12_to_world",
                               self.scene_name + ".json")) as f:
            master2world = np.asarray(json.load(f)["trans"])
        if self.kinect_view != "master":
            sub_kinect = {"sub_1": 11, "sub_2": 13, "sub_3": 14, "sub_4": 15}[self.kinect_view]
            with open(os.path.join(calib_dir, "cal_trans",
                                   f"kinect_{sub_kinect}to12_color.json")) as f:
                sub2master = np.asarray(json.load(f)["trans"])
            cam2world = master2world @ sub2master
        else:
            cam2world = master2world
        self.cam_r = cam2world[:3, :3]
        self.cam_t = cam2world[:3, 3]
        with open(os.path.join(base_dir, "kinect_cam_params", f"kinect_{self.kinect_view}",
                               "Color.json")) as f:
            self.color_cam = json.load(f)

        fitting_dir = os.path.join(
            init_root, self.recording_name, f"body_idx_{self.body_idx}", "results"
        )
        kp_dir = os.path.join(base_dir, "keypoints_cleaned", self.recording_name, self.kinect_view)
        frame_names, params, params_gt, keypoints = self._read_frames(
            fitting_dir, os.path.join(fitting_gt_root, "results"),
            lambda name: os.path.join(kp_dir, name + "_keypoints.json"), self.body_idx)
        joints_world, params_world = self._fk_world(params, self.cam_r, self.cam_t)
        # the GT body lives in the MASTER kinect frame
        joints_world_gt, _ = self._fk_world(params_gt, master2world[:3, :3], master2world[:3, 3])
        joint_mask = np.load(
            os.path.join(base_dir, "mask_joint", self.recording_name, self.kinect_view, "mask_joint.npy")
        )[:, :JOINTS_NUM]

        self._cut_windows(
            frame_names, joints_world, params_world, keypoints, joint_mask, joints_world_gt
        )

    def _cut_windows(self, frame_names, joints_world, params_world, keypoints,
                     joint_mask, joints_world_gt=None):
        spans = overlapping_windows(len(joints_world), self.clip_len, self.overlap_len)
        t, j = self.clip_len, JOINTS_NUM

        def stack(a, empty_shape):
            return np.stack([a[s:e] for s, e in spans]) if spans else np.zeros((0,) + empty_shape)

        self.frame_name_list = [frame_names[s:e] for s, e in spans]
        self.joints_clip_world = stack(joints_world, (t, 22, 3))
        self.params_clip_world = {k: stack(params_world[k], (t, params_world[k].shape[-1]))
                                  for k in _PARAM_KEYS}
        self.keypoints_clips = stack(keypoints, (t, 22, 3))
        self.joint_mask_clips = stack(joint_mask, (t, j))
        self.joints_clip_world_gt = stack(joints_world_gt, (t, 22, 3)) if joints_world_gt is not None else None
        self.n_samples = len(spans)

    # ------------------------------------------------------------------
    def _create_body_repr(self):
        cano_fn = cano_seq_smplx if self.dataset == "prox" else cano_seq_smplx_egobody
        floor = self.scene_floor_height if self.use_scene_floor_height else None
        n, t = self.n_samples, self.clip_len
        self.cano_joints = np.zeros((n, t, JOINTS_NUM, 3))
        self.cano_params = {k: np.zeros((n, t, self.params_clip_world[k].shape[-1])) for k in _PARAM_KEYS}
        self.transf_matrix = np.zeros((n, 4, 4))
        for i in range(n):
            pos, cp, tf = cano_fn(
                self.joints_clip_world[i], {k: v[i] for k, v in self.params_clip_world.items()},
                preset_floor_height=floor, return_transf_mat=True,
            )
            self.cano_joints[i] = pos
            self.transf_matrix[i] = tf
            for k in _PARAM_KEYS:
                self.cano_params[k][i] = cp[k].reshape(t, -1)
        del self.params_clip_world  # only the canonical params are kept

        if n:
            self.repr_input = _chunked(
                _encode_fn, n, 64, self.device, self.cano_joints,
                self.cano_params["global_orient"], self.cano_params["transl"],
                self.cano_params["body_pose"], self.cano_params["betas"],
            ).astype(np.float32)
        else:
            self.repr_input = np.zeros((0, t - 1, 294), np.float32)

    # ------------------------------------------------------------------
    def view(self, task: str, repr_abs_only: bool | None = None) -> "VideoClipDataset":
        """Second task view sharing the same preprocessed recording arrays."""
        assert task in ("traj", "pose")
        v = copy.copy(self)
        v.task = task
        if repr_abs_only is not None:
            v.repr_abs_only = repr_abs_only
            v.traj_feat_dim = 13 if repr_abs_only else 22
        return v

    def __len__(self):
        return self.n_samples

    def __getitem__(self, index: int) -> dict:
        item = {}
        noisy = ((self.repr_input[index] - self.mean) / self.std).astype(np.float32)
        item["motion_repr_noisy"] = noisy
        item["noisy_joints"] = self.cano_joints[index].astype(np.float32)
        item["noisy_joints_scene_coord"] = self.joints_clip_world[index].astype(np.float32)
        if self.joints_clip_world_gt is not None:
            item["gt_joints_scene_coord"] = self.joints_clip_world_gt[index].astype(np.float32)
        item["transf_matrix"] = self.transf_matrix[index].astype(np.float32)
        item["cano_smplx_params_dict"] = {
            k: np.asarray(self.cano_params[k][index], np.float32) for k in _PARAM_KEYS
        }
        item["frame_name"] = self.frame_name_list[index]
        item["focal_length"] = np.asarray(
            [self.color_cam["f"][0], self.color_cam["f"][1]], np.float32
        )
        item["camera_center"] = np.asarray(
            [self.color_cam["c"][0], self.color_cam["c"][1]], np.float32
        )

        kp = self.keypoints_clips[index]
        if self.dataset == "prox":
            item["keypoints_2d"] = undistort_keypoints_prox(kp, self.color_cam).astype(np.float32)
        else:
            item["keypoints_2d"] = kp.astype(np.float32)

        conf_vis = (kp[:, :, -1] > KEYPOINT_CONF_THRESH).astype(np.float32)
        mask_joint_vis = conf_vis * self.joint_mask_clips[index]
        item["mask_joint_vis"] = mask_joint_vis.astype(np.float32)
        item["mask_vec_vis"] = expand_joint_visibility(mask_joint_vis).astype(np.float32)

        if self.task == "traj":
            if self.repr_abs_only:
                item["cond"] = gather_traj_abs(noisy)
            else:
                item["cond"] = noisy[:, : self.traj_feat_dim]
            item["control_cond"] = noisy[:, -self.pose_feat_dim :]
        return item

    def batches(self, batch_size: int, pad_last=False):
        """Stacked batch dicts in recording order; pad_last as
        AmassClipDataset.batches (the dict then carries '_valid'). The
        per-item params dicts and frame names stay lists."""
        skip_keys = {"cano_smplx_params_dict", "frame_name"}
        for s in range(0, self.n_samples, batch_size):
            idx = np.arange(s, min(s + batch_size, self.n_samples))
            valid = len(idx)
            if pad_last and valid < batch_size:
                pad_to = pad_tail_size(valid, batch_size, pad_last)
                idx = np.concatenate([idx, np.full(pad_to - valid, idx[-1])])
            items = [self[int(i)] for i in idx]
            out = {k: np.stack([it[k] for it in items]) for k in items[0] if k not in skip_keys}
            out["cano_smplx_params_dict"] = [it["cano_smplx_params_dict"] for it in items]
            out["frame_name"] = [it["frame_name"] for it in items]
            if pad_last:
                out["_valid"] = valid
            yield out
