"""AMASS clip dataset: preprocessed npys -> normalized 294-d repr clips.

The port of rohm_tpu/data/amass.py (reference
data_loaders/dataloader_amass.py:11-341). Noise synthesis is batched through
scipy in one call, with the same np.random.default_rng(seed) draws in the
same order as the JAX package (one seed, the same noise in both); the
noisy-joint FK and the repr encoding run through the port's torch
functions, chunked, under torch.no_grad(), on the dataset's device; the
per-epoch batch stream is served from packed fixed-shape numpy arrays.

Emitted item dict matches the reference __getitem__ (dataloader_amass.py:285-341):
  motion_repr_clean [144, 294] normalized
  motion_repr_noisy [144, 294] normalized (pose task: traj dims from clean)
  noisy_joints      [145, 22, 3] (only when input_noise)
  cond              [144, 13|22] (traj task only: noisy traj)
  control_cond      [144, 272]   (traj task only: clean local pose feats)
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R

from rohm_tpu_torch.body.model import SmplxModel, forward_joints
from rohm_tpu_torch.data.clips import divide_into_clips
from rohm_tpu_torch.reprs.canonicalize import cano_seq_smplx
from rohm_tpu_torch.reprs.encode import get_repr
from rohm_tpu_torch.reprs.schema import TRAJ_FEAT_DIM_FULL, gather_traj_abs
from rohm_tpu_torch.reprs.stats import compute_stats, load_stats, save_stats

PARAM_NAMES = ("global_orient", "transl", "body_pose", "betas")

# [T, 178] params layout written by preprocessing (reference
# preprocessing_amass.py:74, read back at dataloader_amass.py:145-149)
_PARAM_SLICES = {
    "global_orient": slice(0, 3),
    "transl": slice(3, 6),
    "betas": slice(6, 16),
    "body_pose": slice(16, 79),
}


def _euler_noise_rotvec(rotvec: np.ndarray, noise_deg: np.ndarray) -> np.ndarray:
    """Perturb axis-angle rotations by additive noise in 'zxy' Euler degrees.

    rotvec [..., 3]; noise_deg [..., 3]. One batched scipy call (the reference
    does this per clip, dataloader_amass.py:169-192).
    """
    shape = rotvec.shape
    ang = R.from_rotvec(rotvec.reshape(-1, 3)).as_euler("zxy", degrees=True)
    noisy = ang + noise_deg.reshape(-1, 3)
    return R.from_euler("zxy", noisy, degrees=True).as_rotvec().reshape(shape)


def _fk_fn(body_model, joints_num: int):
    """FK on f32 tensors (betas, global_orient, body_pose, transl) -> joints."""
    def fk(betas, global_orient, body_pose, transl):
        return forward_joints(body_model, betas, global_orient, body_pose, transl,
                              num_joints=joints_num)
    return fk


def _encode_fn(positions, global_orient, transl, body_pose, betas):
    return get_repr(positions, global_orient=global_orient, transl=transl,
                    body_pose=body_pose, betas=betas)


@torch.no_grad()
def _chunked(fn, n: int, chunk: int, device, *arrays) -> np.ndarray:
    """Apply fn over leading-dim chunks of numpy arrays (cast to f32 tensors
    on `device`) and concatenate the results on the host."""
    outs = []
    for s in range(0, n, chunk):
        parts = [torch.as_tensor(np.asarray(a[s : s + chunk]), dtype=torch.float32, device=device)
                 for a in arrays]
        outs.append(fn(*parts).cpu().numpy())
    return np.concatenate(outs, axis=0)


def model_fingerprint(body_model) -> str:
    """Content hash of the body model for disk-cache keys: cached FK outputs
    are functions of the model, and a synthetic-fallback cache must not be
    served after real SMPL-X weights appear. Models stamped at construction
    (SmplxModel.fingerprint) return that; otherwise the tensors are hashed."""
    import hashlib

    if getattr(body_model, "fingerprint", None) is not None:
        return body_model.fingerprint
    h = hashlib.sha1()
    for name in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights",
                 "j_template", "j_shapedirs"):
        a = getattr(body_model, name).detach().cpu().numpy()
        h.update(f"{name}{a.shape}{a.dtype}".encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _walk_fingerprint(h, root: str) -> None:
    """Feed path/size/mtime of every file under root into hash h, skipping
    cache dirs (a cache stored inside a fingerprinted tree must not invalidate
    itself by existing). The walk stays lazy so the prune applies."""
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in ("_repr_cache", "_stats_cache"))
        for fn in sorted(filenames):
            p = os.path.join(dirpath, fn)
            st = os.stat(p)
            h.update(f"{os.path.relpath(p, root)}:{st.st_size}:{st.st_mtime_ns}".encode())


class AmassClipDataset:
    """Packed AMASS clip dataset (see module docstring).

    Precomputes everything into [N, ...] arrays at construction;
    `__getitem__` only slices + normalizes. FK and the repr encoding run on
    `device` (default: the body model's device).
    """

    def __init__(
        self,
        body_model: SmplxModel,
        preprocessed_amass_root: str = "",
        amass_datasets: list[str] | None = None,
        split: str = "train",
        spacing: int = 1,
        repr_abs_only: bool = False,
        input_noise: bool = False,
        sep_noise: bool = False,
        noise_std_joint: float = 0.0,
        noise_std_smplx_global_rot: float = 0.0,
        noise_std_smplx_body_rot: float = 0.0,
        noise_std_smplx_trans: float = 0.0,
        noise_std_smplx_betas: float = 0.0,
        load_noise: bool = False,
        loaded_smplx_noise_dict: dict | None = None,
        task: str = "traj",
        clip_len: int = 145,
        joints_num: int = 22,
        logdir: str | None = None,
        seed: int = 0,
        fk_chunk: int = 64,
        clips: tuple[np.ndarray, np.ndarray] | None = None,
        disk_cache_dir: str | None = None,
        device: torch.device | str | None = None,
    ):
        assert task in ("traj", "pose"), f"bad task {task}"
        self.split = split
        self.task = task
        self.clip_len = clip_len
        self.joints_num = joints_num
        self.repr_abs_only = repr_abs_only
        self.input_noise = input_noise
        self.sep_noise = sep_noise
        self.logdir = logdir
        self.body_model = body_model
        self.device = torch.device(device) if device is not None else body_model.v_template.device
        self.traj_feat_dim = 13 if repr_abs_only else TRAJ_FEAT_DIM_FULL
        self.pose_feat_dim = 272
        self._rng = np.random.default_rng(seed)
        self.noise_std_params = {
            "global_orient": noise_std_smplx_global_rot,
            "transl": noise_std_smplx_trans,
            "body_pose": noise_std_smplx_body_rot,
            "betas": noise_std_smplx_betas,
        }
        self.noise_std_joint = noise_std_joint

        # --- optional on-disk cache of all derived arrays: the derived state
        # is deterministic given the tree + noise config + seed + body model
        # (+ the device type, whose FK rounds differently), so eval runs
        # can reuse it across processes. The file name carries its own tag
        # ("amass_torch_"): the JAX package caches under "amass_<key>" in the
        # same directory, and its arrays must never be read here.
        self._cache_path = None
        if disk_cache_dir is not None and clips is None and not sep_noise:
            key = self._disk_cache_key(
                preprocessed_amass_root, amass_datasets or [], split, spacing,
                clip_len, joints_num, seed, input_noise, load_noise,
                self.noise_std_params, noise_std_joint, loaded_smplx_noise_dict,
                model_fingerprint(body_model), self.device.type,
            )
            self._cache_path = os.path.join(disk_cache_dir, f"amass_torch_{key}.npz")
            if os.path.exists(self._cache_path):
                self._load_disk_cache(self._cache_path)
                self._finish_stats()
                return

        if clips is not None:
            joints_clips, params_clips = clips
        else:
            joints_clips, params_clips = self._load_clips(
                preprocessed_amass_root, amass_datasets or [], split, clip_len
            )
        joints_clips = joints_clips[::spacing]
        params_clips = params_clips[::spacing]
        self.n_samples = len(joints_clips)
        if self.n_samples == 0:
            # fail loudly here: downstream the empty tree surfaces as a
            # cryptic "need at least one array to concatenate" from the
            # chunked FK/encode
            raise ValueError(
                f"no {clip_len}-frame clips found under "
                f"{preprocessed_amass_root!r} (datasets={amass_datasets}, "
                f"split={split!r}) — missing/empty tree, wrong dataset_root, "
                "or every sequence shorter than clip_len"
            )

        # --- canonicalize every clip (host; cheap linear algebra per clip)
        cano_pos = np.empty((self.n_samples, clip_len, joints_num, 3))
        cano_params = {
            "global_orient": np.empty((self.n_samples, clip_len, 3)),
            "transl": np.empty((self.n_samples, clip_len, 3)),
            "body_pose": np.empty((self.n_samples, clip_len, 63)),
            "betas": np.empty((self.n_samples, clip_len, 10)),
        }
        for i in range(self.n_samples):
            p = params_clips[i]
            params_i = {k: np.ascontiguousarray(p[:, sl]) for k, sl in _PARAM_SLICES.items()}
            pos_i, cp_i = cano_seq_smplx(joints_clips[i][:, :joints_num], params_i)
            cano_pos[i] = pos_i
            for k in PARAM_NAMES:
                cano_params[k][i] = cp_i[k].reshape(clip_len, -1)
        self.joints_clean = cano_pos
        self.cano_params = cano_params

        # --- noise model (batched): Euler-space rot noise + FK noisy joints
        if input_noise and not sep_noise:
            noisy_params, self.smplx_noise_dict = self._make_noisy_params(
                cano_params, load_noise, loaded_smplx_noise_dict
            )
            self.noisy_params = noisy_params
            self.joints_noisy = _chunked(
                _fk_fn(body_model, joints_num),
                self.n_samples,
                fk_chunk,
                self.device,
                noisy_params["betas"],
                noisy_params["global_orient"],
                noisy_params["body_pose"],
                noisy_params["transl"],
            ).astype(np.float64)
        else:
            self.noisy_params = None
            self.joints_noisy = None

        # --- repr encoding: chunked over all clips
        self.repr_clean = self._encode(cano_pos, cano_params, fk_chunk)
        if self.joints_noisy is not None:
            self.repr_noisy = self._encode(self.joints_noisy, self.noisy_params, fk_chunk)
        else:
            self.repr_noisy = None

        if self._cache_path is not None:
            self._save_disk_cache(self._cache_path)
        self._finish_stats()

    def _finish_stats(self):
        """Normalization stats (train: compute+save; test: load)."""
        if self.split == "train":
            self.mean, self.std = compute_stats(self.repr_clean)
            if self.logdir is not None:
                save_stats(self.logdir, self.mean, self.std)
        else:
            assert self.logdir is not None, "test split needs logdir with saved stats"
            self.mean, self.std = load_stats(self.logdir)

    # ------------------------------------------------------------------
    @staticmethod
    def _disk_cache_key(root, datasets, split, spacing, clip_len, joints_num,
                        seed, input_noise, load_noise, noise_std_params,
                        noise_std_joint, loaded_noise, model_fp, device_type):
        """Fingerprint of everything the derived arrays depend on: config, the
        body model, and the file listing (path/size/mtime) of BOTH preprocessed
        trees (joints npys AND smplx-params npys — _load_clips reads both)."""
        import hashlib
        import json

        h = hashlib.sha1()
        cfg = dict(split=split, spacing=spacing, clip_len=clip_len,
                   joints_num=joints_num, seed=seed, input_noise=input_noise,
                   load_noise=load_noise, noise_std_joint=noise_std_joint,
                   model=model_fp, device=device_type,
                   stds={k: noise_std_params[k] for k in sorted(noise_std_params)})
        h.update(json.dumps(cfg, sort_keys=True).encode())
        for ds in sorted(datasets):
            for tree in ("pose_data_fps_30", "smpl_data_fps_30"):
                _walk_fingerprint(h, os.path.join(root, tree, ds))
        if load_noise and loaded_noise is not None:
            for k in sorted(loaded_noise):
                h.update(np.ascontiguousarray(loaded_noise[k]).tobytes())
        return h.hexdigest()[:16]

    def _save_disk_cache(self, path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {"joints_clean": self.joints_clean, "repr_clean": self.repr_clean}
        for k in PARAM_NAMES:
            payload[f"cano_{k}"] = self.cano_params[k]
        if self.repr_noisy is not None:
            payload["repr_noisy"] = self.repr_noisy
            payload["joints_noisy"] = self.joints_noisy
            for k in PARAM_NAMES:
                payload[f"noisy_{k}"] = self.noisy_params[k]
                payload[f"noise_{k}"] = self.smplx_noise_dict[k]
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)

    def _load_disk_cache(self, path):
        z = np.load(path)
        self.joints_clean = z["joints_clean"]
        self.repr_clean = z["repr_clean"]
        self.n_samples = len(self.repr_clean)
        self.cano_params = {k: z[f"cano_{k}"] for k in PARAM_NAMES}
        if "repr_noisy" in z:
            self.repr_noisy = z["repr_noisy"]
            self.joints_noisy = z["joints_noisy"]
            self.noisy_params = {k: z[f"noisy_{k}"] for k in PARAM_NAMES}
            self.smplx_noise_dict = {k: z[f"noise_{k}"] for k in PARAM_NAMES}
        else:
            self.repr_noisy = None
            self.joints_noisy = None
            self.noisy_params = None

    # ------------------------------------------------------------------
    @staticmethod
    def _load_clips(root, datasets, split, clip_len):
        """Read per-sequence npys and cut non-overlapping clips.

        Matches reference divide_clip (dataloader_amass.py:105-131): test split
        trims the first/last frame of every sequence before clipping.
        """
        joints_clips, params_clips = [], []
        for dataset_name in datasets:
            paths = sorted(
                glob.glob(os.path.join(root, "pose_data_fps_30", dataset_name, "*/*.npy"))
            )
            for path in paths:
                seq_joints = np.load(path)  # [T, 25, 3]
                seq_params = np.load(
                    path.replace(
                        os.path.join(root, "pose_data_fps_30"),
                        os.path.join(root, "smpl_data_fps_30"),
                    )
                )  # [T, 178]
                if split == "test":
                    seq_joints = seq_joints[1:-1]
                    seq_params = seq_params[1:-1]
                j, p = divide_into_clips(seq_joints, seq_params, clip_len)
                joints_clips.extend(j)
                params_clips.extend(p)
        if not joints_clips:
            return (
                np.zeros((0, clip_len, 25, 3)),
                np.zeros((0, clip_len, 178)),
            )
        return np.stack(joints_clips), np.stack(params_clips)

    def _make_noisy_params(self, cano_params, load_noise, loaded):
        """Gaussian noise on SMPL-X params; rotations perturbed in Euler space."""
        n, t = self.n_samples, self.clip_len
        noise = {}
        if load_noise:
            assert loaded is not None, "load_noise=True needs loaded_smplx_noise_dict"
            for k in PARAM_NAMES:
                noise[k] = np.asarray(loaded[k])[: n].reshape(
                    (n, t) + np.asarray(loaded[k]).shape[2:]
                )
        else:
            noise["transl"] = self._rng.normal(0.0, self.noise_std_params["transl"], (n, t, 3))
            noise["betas"] = self._rng.normal(0.0, self.noise_std_params["betas"], (n, t, 10))
            noise["global_orient"] = self._rng.normal(
                0.0, self.noise_std_params["global_orient"], (n, t, 3)
            )
            noise["body_pose"] = self._rng.normal(
                0.0, self.noise_std_params["body_pose"], (n, t, 21, 3)
            )
        noisy = {
            "transl": cano_params["transl"] + noise["transl"],
            "betas": cano_params["betas"] + noise["betas"],
            "global_orient": _euler_noise_rotvec(
                cano_params["global_orient"], noise["global_orient"]
            ),
            "body_pose": _euler_noise_rotvec(
                cano_params["body_pose"].reshape(n, t, 21, 3), noise["body_pose"]
            ).reshape(n, t, 63),
        }
        return noisy, noise

    def _encode(self, positions, params, chunk):
        return _chunked(
            _encode_fn,
            self.n_samples,
            chunk,
            self.device,
            positions,
            params["global_orient"],
            params["transl"],
            params["body_pose"],
            params["betas"],
        ).astype(np.float32)

    # ------------------------------------------------------------------
    def view(self, task: str, repr_abs_only: bool | None = None) -> "AmassClipDataset":
        """A second task view over the SAME preprocessed arrays.

        The reference constructs two full DataloaderAMASS objects for the
        pose/traj views of identical data (test_amass_full.py:93-127),
        repeating canonicalization, noise FK and encoding; a view shares them."""
        assert task in ("traj", "pose")
        import copy

        v = copy.copy(self)
        v.task = task
        if repr_abs_only is not None:
            v.repr_abs_only = repr_abs_only
            v.traj_feat_dim = 13 if repr_abs_only else TRAJ_FEAT_DIM_FULL
        return v

    def __len__(self) -> int:
        return self.n_samples

    def _norm(self, x):
        return ((x - self.mean) / self.std).astype(np.float32)

    def __getitem__(self, index: int) -> dict:
        item = {}
        clean = self.repr_clean[index]
        if self.input_noise:
            if self.sep_noise:
                # fresh noise per access: params + joints noised independently
                params = {k: self.cano_params[k][index].copy() for k in PARAM_NAMES}
                params["transl"] += self._rng.normal(
                    0.0, self.noise_std_params["transl"], params["transl"].shape
                )
                params["betas"] += self._rng.normal(
                    0.0, self.noise_std_params["betas"], params["betas"].shape
                )
                params["global_orient"] = _euler_noise_rotvec(
                    params["global_orient"],
                    self._rng.normal(0.0, self.noise_std_params["global_orient"], (self.clip_len, 3)),
                )
                params["body_pose"] = _euler_noise_rotvec(
                    params["body_pose"].reshape(self.clip_len, 21, 3),
                    self._rng.normal(0.0, self.noise_std_params["body_pose"], (self.clip_len, 21, 3)),
                ).reshape(self.clip_len, 63)
                pos_noisy = self.joints_clean[index] + self._rng.normal(
                    0.0, self.noise_std_joint, self.joints_clean[index].shape
                )
                noisy = _chunked(
                    _encode_fn, 1, 1, self.device, pos_noisy[None], params["global_orient"][None],
                    params["transl"][None], params["body_pose"][None], params["betas"][None],
                )[0]
                item["noisy_joints"] = pos_noisy.astype(np.float32)
            else:
                noisy = self.repr_noisy[index].copy()
                item["noisy_joints"] = self.joints_noisy[index].astype(np.float32)
            if self.task == "pose":
                # PoseNet conditions on the CLEAN trajectory at train time
                noisy[:, :TRAJ_FEAT_DIM_FULL] = clean[:, :TRAJ_FEAT_DIM_FULL]
        else:
            noisy = clean.copy()

        item["motion_repr_clean"] = self._norm(clean)
        item["motion_repr_noisy"] = self._norm(noisy)

        if self.task == "traj":
            mn = item["motion_repr_noisy"]
            if self.repr_abs_only:
                item["cond"] = gather_traj_abs(mn)
            else:
                item["cond"] = mn[:, :TRAJ_FEAT_DIM_FULL]
            item["control_cond"] = item["motion_repr_clean"][:, -self.pose_feat_dim :]
        return item

    # ------------------------------------------------------------------
    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = True, pad_last=False, pad_multiple: int = 1):
        """Yield stacked batch dicts of fixed shape.

        pad_last=True pads a short final batch to batch_size by repeating the
        last clip; pad_last="bucket" pads only to the next power of two
        (x pad_multiple) — a 7-clip tail behind bs=64 batches costs 8 clips
        of device compute, not 64. The
        dict carries '_valid' with the true count so callers can trim
        outputs. pad_last implies keeping the tail: honoring the
        (train-oriented) drop_last=True default would silently drop the very
        clips the caller asked to pad."""
        from rohm_tpu_torch.data.clips import pad_tail_size

        order = np.arange(self.n_samples)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        if pad_last:
            drop_last = False
        stop = self.n_samples - (self.n_samples % batch_size if drop_last else 0)
        for s in range(0, stop, batch_size):
            idx = order[s : s + batch_size]
            valid = len(idx)
            if pad_last and valid < batch_size:
                pad_to = pad_tail_size(valid, batch_size, pad_last, pad_multiple)
                idx = np.concatenate([idx, np.full(pad_to - valid, idx[-1])])
            items = [self[int(i)] for i in idx]
            out = {k: np.stack([it[k] for it in items]) for k in items[0]}
            if pad_last:
                out["_valid"] = valid
            yield out


def save_noise_dict(path: str, smplx_noise_dict: dict) -> None:
    """Persist a generated noise bank in the reference pkl format
    (dataloader_amass.py:238-245)."""
    out = {k: np.asarray(v) for k, v in smplx_noise_dict.items()}
    with open(path, "wb") as f:
        pickle.dump(out, f, protocol=2)


def load_noise_dict(path: str) -> dict:
    """Load a preset-noise pkl (reference test_amass_full.py:84-89)."""
    with open(path, "rb") as f:
        return pickle.load(f)
