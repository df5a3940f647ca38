"""Occlusion masks for the inference pipeline and the training curricula
(numpy, host side).

A copy of rohm_tpu/train/masking.py (the port never imports the JAX
package): the same functions consume the np.random.Generator in the same
order, so one seed gives the same masks in both packages. Masks are
multiplicative visibility masks (1 = visible / keep), built vectorized over
the batch instead of the reference's per-sample loops
(training_loop_posenet.py:113-202).

Index map (traj_feat_dim = 22):
  local_positions  dims traj+joint*3+k          (k<3)
  local_vel        dims traj+66+joint*3+k       (k<3)
  body_pose_6d     dims traj+132+(joint-1)*6+k  (k<6), joint>=1
  foot_contact     dims -4:-2 left (joints 7/10), -2: right (joints 8/11)
"""

from __future__ import annotations

import glob
import os

import numpy as np

from rohm_tpu_torch.reprs.schema import BODY_FEAT_DIM, REPR_DIM_DICT, REPR_LIST, TRAJ_FEAT_DIM_FULL

LOWER_BODY_JOINTS = np.array([1, 2, 4, 5, 7, 8, 10, 11])
UPPER_BODY_JOINTS = np.array([3, 6, 9, 12, 13, 14, 15, 16, 17, 18, 19, 20])
_WRIST_HAND_JOINTS = np.array([18, 19, 20, 21])  # always masked in partial upper scheme


def joint_mask_to_vec(masked_joints: np.ndarray, traj_feat_dim: int = TRAJ_FEAT_DIM_FULL) -> np.ndarray:
    """Expand per-joint masked flags [..., 22] bool (True = mask OUT) into a
    flat repr visibility mask [..., 294] float. Traj dims and betas stay
    visible; contact dims follow the foot joints."""
    masked = np.asarray(masked_joints, bool)
    vis = np.ones(masked.shape[:-1] + (BODY_FEAT_DIM,), np.float32)
    keep = (~masked).astype(np.float32)  # [..., 22]

    j3 = np.repeat(keep, 3, axis=-1)  # [..., 66]
    vis[..., traj_feat_dim : traj_feat_dim + 66] = j3
    vis[..., traj_feat_dim + 66 : traj_feat_dim + 132] = j3
    vis[..., traj_feat_dim + 132 : traj_feat_dim + 132 + 126] = np.repeat(keep[..., 1:], 6, axis=-1)
    left_masked = masked[..., 7] | masked[..., 10]
    right_masked = masked[..., 8] | masked[..., 11]
    vis[..., -4:-2] *= (~left_masked).astype(np.float32)[..., None]
    vis[..., -2:] *= (~right_masked).astype(np.float32)[..., None]
    return vis


def random_joint_mask(rng: np.random.Generator, batch_size: int) -> np.ndarray:
    """1-6 random joints per sample, with replacement, pelvis remapped to 1
    (reference training_loop_posenet.py:116-119). Returns [bs, 22] bool."""
    n = rng.integers(1, 7)
    ids = rng.integers(0, 22, size=(batch_size, n))
    ids[ids == 0] = 1
    masked = np.zeros((batch_size, 22), bool)
    np.put_along_axis(masked, ids, True, axis=-1)
    return masked


def lower_body_mask(batch_size: int) -> np.ndarray:
    masked = np.zeros((batch_size, 22), bool)
    masked[:, LOWER_BODY_JOINTS] = True
    return masked


def upper_body_mask(rng: np.random.Generator, batch_size: int) -> np.ndarray:
    """Upper-body scheme: 60% of batches mask a random 5-joint subset plus the
    wrists/hands, else the full upper body (training_loop_posenet.py:169-184).
    One draw for the whole batch, as in the reference."""
    if rng.uniform() < 0.6:
        sel = rng.choice(UPPER_BODY_JOINTS, size=5, replace=False)
        sel = np.union1d(sel, _WRIST_HAND_JOINTS)
    else:
        sel = UPPER_BODY_JOINTS
    masked = np.zeros((batch_size, 22), bool)
    masked[:, sel] = True
    return masked


def full_window_mask(
    rng: np.random.Generator,
    batch_size: int,
    clip_len: int,
    mask_len: int = 30,
    traj_feat_dim: int = TRAJ_FEAT_DIM_FULL,
) -> np.ndarray:
    """Zero the full pose part over a random 30-frame window per sample
    (training_loop_posenet.py:193-200). Returns [bs, T, 294] float."""
    start = rng.integers(0, clip_len - 1, size=batch_size)
    end = np.minimum(start + mask_len, clip_len)
    t = np.arange(clip_len)
    in_window = (t[None, :] >= start[:, None]) & (t[None, :] < end[:, None])  # [bs, T]
    vis = np.ones((batch_size, clip_len, BODY_FEAT_DIM), np.float32)
    vis[..., traj_feat_dim:] *= (~in_window).astype(np.float32)[..., None]
    return vis


def expand_joint_visibility(mask_clip: np.ndarray, clip_len: int | None = None) -> np.ndarray:
    """Expand a per-joint visibility clip [T, 22] (1 = visible) into the flat
    repr visibility vector [T, 294].

    Shared by the PROX training-mask bank (training_loop_posenet.py:80-95) and
    the video dataloader's mask_vec_vis (dataloader_video.py:467-484): traj +
    betas dims always visible; local_positions/local_vel follow all 22 joints;
    body_pose_6d follows joints 1..21; a contact pair is visible only if both
    joints of that foot are visible.
    """
    mask_clip = np.asarray(mask_clip, np.float32)
    t = mask_clip.shape[0] if clip_len is None else clip_len
    mask_clip = mask_clip[:t]
    parts = []
    for key in REPR_LIST:
        if key in ("local_positions", "local_vel"):
            parts.append(np.repeat(mask_clip, 3, axis=1))
        elif key == "smplx_body_pose_6d":
            parts.append(np.repeat(mask_clip[:, 1:], 6, axis=1))
        elif key == "foot_contact":
            fc = np.zeros((t, 4), np.float32)
            left = (mask_clip[:, 7] == 1) & (mask_clip[:, 10] == 1)
            right = (mask_clip[:, 8] == 1) & (mask_clip[:, 11] == 1)
            fc[left, 0:2] = 1.0
            fc[right, 2:4] = 1.0
            parts.append(fc)
        else:
            parts.append(np.ones((t, REPR_DIM_DICT[key]), np.float32))
    return np.concatenate(parts, axis=-1)


def build_prox_mask_bank(mask_root: str, clip_len: int, min_mask_ratio: float = 0.05) -> np.ndarray:
    """Load real PROX occlusion masks into a [M, T, 294] visibility bank
    (training_loop_posenet.py:65-98). Clips with <5% masked joints are skipped."""
    bank = []
    for mask_path in sorted(glob.glob(os.path.join(mask_root, "*", "mask_joint.npy"))):
        mask = np.load(mask_path)
        for i in range(len(mask) // clip_len):
            clip = mask[i * clip_len : (i + 1) * clip_len][:, :22]
            ratio = 1.0 - clip.sum() / clip.size
            if ratio >= min_mask_ratio:
                bank.append(expand_joint_visibility(clip))
    if not bank:
        return np.ones((0, clip_len, BODY_FEAT_DIM), np.float32)
    return np.stack(bank)


_SCHEME_PROBS = {
    "lower": {"prox": 0.7, "lower": 1.0},
    "lower+upper": {"prox": 0.5, "lower": 0.8, "upper": 1.0},
    "lower+full": {"prox": 0.5, "lower": 0.8, "full": 1.0},
    "lower+upper+full": {"prox": 0.5, "lower": 0.8, "upper": 0.9, "full": 1.0},
}


def posenet_train_cond_mask(
    rng: np.random.Generator,
    batch_size: int,
    clip_len: int,
    epoch: int,
    start_prox_mask_epoch: int,
    mask_scheme: str,
    prox_bank: np.ndarray | None,
    input_noise: bool,
    traj_feat_dim: int = TRAJ_FEAT_DIM_FULL,
) -> np.ndarray:
    """The full PoseNet masking curriculum -> [bs, T, 294] visibility mask.

    Early epochs: 1-6 random joints. Later: a mask_scheme-dependent mixture of
    {real prox masks, lower body, upper body, 30-frame full-pose window}
    (training_loop_posenet.py:113-202). Contact dims are zeroed whenever the
    condition is noisy.
    """
    if epoch <= start_prox_mask_epoch:
        vis = joint_mask_to_vec(random_joint_mask(rng, batch_size), traj_feat_dim)
        vis = np.broadcast_to(vis[:, None, :], (batch_size, clip_len, BODY_FEAT_DIM)).copy()
    else:
        probs = _SCHEME_PROBS[mask_scheme]
        p = rng.uniform()
        if "prox" in probs and p <= probs["prox"] and prox_bank is not None and len(prox_bank):
            idx = rng.permutation(len(prox_bank))[:batch_size]
            vis = prox_bank[idx][:, :clip_len].copy()
            if len(vis) < batch_size:  # bank smaller than batch: tile
                reps = -(-batch_size // len(vis))
                vis = np.tile(vis, (reps, 1, 1))[:batch_size]
        elif "lower" in probs and p <= probs["lower"]:
            vis = joint_mask_to_vec(lower_body_mask(batch_size), traj_feat_dim)
            vis = np.broadcast_to(vis[:, None, :], (batch_size, clip_len, BODY_FEAT_DIM)).copy()
            vis[..., -4:] = 0.0
        elif "upper" in probs and p <= probs["upper"]:
            vis = joint_mask_to_vec(upper_body_mask(rng, batch_size), traj_feat_dim)
            vis = np.broadcast_to(vis[:, None, :], (batch_size, clip_len, BODY_FEAT_DIM)).copy()
            vis[..., -4:] = 0.0
        else:
            vis = full_window_mask(rng, batch_size, clip_len, 30, traj_feat_dim)
            vis[..., -4:] = 0.0
    if input_noise:
        vis[..., -4:] = 0.0
    return vis


def posenet_eval_cond_mask(
    rng: np.random.Generator,
    batch_size: int,
    clip_len: int,
    input_noise: bool,
    traj_feat_dim: int = TRAJ_FEAT_DIM_FULL,
) -> np.ndarray:
    """Eval-during-training mask: always the 1-6-random-joints scheme
    (training_loop_posenet.py:227-245)."""
    vis = joint_mask_to_vec(random_joint_mask(rng, batch_size), traj_feat_dim)
    vis = np.broadcast_to(vis[:, None, :], (batch_size, clip_len, BODY_FEAT_DIM)).copy()
    if input_noise:
        vis[..., -4:] = 0.0
    return vis
