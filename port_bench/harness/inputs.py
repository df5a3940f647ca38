"""The benchmark's inputs, made in set-up from the seed: a synthetic SMPL-X
body, a pool of AMASS-like clips and what the AMASS evaluation feeds
`RohmPipeline.run_batch` for them.

Frozen copies of rohm_tpu_torch/body/model.py::synthetic_model (at SMPL-X's
published 10,475 vertices and 55 joints), data/synthetic.py's clip
generator (grounded: stance phases, so contact labels are not vacuous),
data/amass.py's noise model (Gaussian SMPL-X parameter noise, rotations in
'zxy' Euler degrees) and reprs/stats.py::compute_stats. Forward kinematics
and the 294-d encoding run through the reference's plain PyTorch on the
device, in bulk. Both the port and the reference get these arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.body import NUM_JOINTS, SMPLX_PARENTS, forward_joints, make_model
from reference.canonicalize import cano_seq_smplx
from reference.rotations import aa_to_rotmat, rotmat_to_aa
from reference.encode import get_repr
from reference.schema import BODY_FEAT_DIM, REPR_LIST, TRAJ_ABS_INDEX, TRAJ_FEAT_DIM_FULL, block_slice

PARAM_NAMES = ("global_orient", "transl", "body_pose", "betas")
# joints masked by the 'lower' scheme, and the upper-body ones (train/masking.py)
LOWER_BODY_JOINTS = np.array([1, 2, 4, 5, 7, 8, 10, 11])


def body_arrays(seed: int, num_verts: int = 10475) -> dict:
    """synthetic_model's arrays: joints on a random kinematic tree, vertices
    scattered around their joints, a near-interpolatory regressor, random
    shape and pose bases, skinning weights on each vertex's joint and its
    parent."""
    rng = np.random.default_rng(seed)
    base_joints = np.zeros((NUM_JOINTS, 3), np.float64)
    offsets = rng.normal(scale=0.08, size=(NUM_JOINTS, 3))
    offsets[:, 1] -= 0.05
    for j in range(1, NUM_JOINTS):
        base_joints[j] = base_joints[SMPLX_PARENTS[j]] + offsets[j]
    base_joints[0, 1] += 0.9
    owner = rng.integers(0, NUM_JOINTS, size=num_verts)
    v_template = base_joints[owner] + rng.normal(scale=0.05, size=(num_verts, 3))
    j_regressor = np.zeros((NUM_JOINTS, num_verts), np.float64)
    for j in range(NUM_JOINTS):
        mask = owner == j
        if mask.sum() == 0:
            mask[rng.integers(0, num_verts)] = True
        j_regressor[j, mask] = 1.0 / mask.sum()
    j_regressor += np.abs(rng.normal(scale=1e-3, size=j_regressor.shape))
    j_regressor /= j_regressor.sum(axis=1, keepdims=True)
    shapedirs = rng.normal(scale=0.01, size=(num_verts, 3, 10))
    posedirs = rng.normal(scale=1e-3, size=((NUM_JOINTS - 1) * 9, num_verts * 3)).astype(np.float32)
    lbs_w = np.zeros((num_verts, NUM_JOINTS), np.float64)
    lbs_w[np.arange(num_verts), owner] = 1.0
    lbs_w[np.arange(num_verts), np.maximum(SMPLX_PARENTS[owner], 0)] += 0.5
    lbs_w /= lbs_w.sum(axis=1, keepdims=True)
    return {"v_template": v_template, "shapedirs": shapedirs, "posedirs": posedirs,
            "j_regressor": j_regressor, "lbs_weights": lbs_w}


def _stance_time_warp(num_frames: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-frame speed factor dipping to ~0.02 in 12-frame holds every 17
    frames, and a matching 0.2 m pelvis dip."""
    w = np.ones(num_frames)
    z_dip = np.zeros(num_frames)
    period, ramp, flat = 17, 3, 6
    hold = 2 * ramp + flat
    for start in range(4, num_frames - hold, period):
        up = 0.5 - 0.5 * np.cos(np.linspace(0, np.pi, ramp + 1)[1:])
        prof = np.concatenate([up, np.ones(flat), up[::-1]])
        w[start:start + hold] = 1.0 - 0.98 * prof
        z_dip[start:start + hold] = 0.2 * prof
    return w, z_dip


def clip_params(num_frames: int, seed: int, walk_speed: float = 0.02) -> dict:
    """One grounded clip's SMPL-X parameters: low-frequency sinusoids per
    body dof (the torso damped), a slowly turning heading, a walking path
    that stops in each stance."""
    rng = np.random.default_rng(seed)
    w, z_dip = _stance_time_warp(num_frames)
    t = (np.cumsum(w) - w[0])[:, None]
    freqs = rng.uniform(0.02, 0.12, size=(1, 63))
    phases = rng.uniform(0, 2 * np.pi, size=(1, 63))
    amps = rng.uniform(0.05, 0.35, size=(1, 63))
    for j in (3, 6, 9, 12, 13, 14):
        amps[:, (j - 1) * 3:(j - 1) * 3 + 3] *= 0.15
    body_pose = amps * np.sin(2 * np.pi * freqs * t + phases)
    heading = 0.5 * np.sin(2 * np.pi * 0.01 * t[:, 0]) + rng.uniform(-np.pi, np.pi)
    tilt = 0.05 * np.sin(2 * np.pi * 0.03 * t[:, 0])
    global_orient = np.stack([np.full(num_frames, np.pi / 2) + tilt, np.zeros(num_frames), heading], axis=-1)
    step = walk_speed * np.stack([np.cos(heading), np.sin(heading)], axis=-1) * w[:, None]
    xy = np.cumsum(step, axis=0) + rng.normal(scale=1.0, size=(1, 2))
    z = 0.95 + 0.02 * np.sin(2 * np.pi * 0.07 * t[:, 0]) - z_dip
    transl = np.concatenate([xy, z[:, None]], axis=-1)
    betas = np.tile(rng.normal(scale=0.5, size=(1, 10)), (num_frames, 1))
    return {"global_orient": global_orient, "transl": transl, "body_pose": body_pose, "betas": betas}


def _rot_axis(angle: torch.Tensor, axis: int) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(angle), torch.zeros_like(angle)
    rows = {0: [[o, z, z], [z, c, -s], [z, s, c]], 1: [[c, z, s], [z, o, z], [-s, z, c]],
            2: [[c, -s, z], [s, c, z], [z, z, o]]}[axis]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def euler_noise_rotvec(rotvec: torch.Tensor, noise_deg: torch.Tensor) -> torch.Tensor:
    """Axis-angle rotations perturbed by additive Euler-angle noise in
    degrees, in scipy's extrinsic 'zxy' convention (R = Ry(c) Rx(b) Rz(a)),
    as data/amass.py's _euler_noise_rotvec does through scipy; batched
    on the device."""
    m = aa_to_rotmat(rotvec.double())
    b = torch.asin(torch.clamp(-m[..., 1, 2], -1.0, 1.0))
    a = torch.atan2(m[..., 1, 0], m[..., 1, 1])
    c = torch.atan2(m[..., 0, 2], m[..., 2, 2])
    n = torch.deg2rad(noise_deg.double())
    r = _rot_axis(c + n[..., 2], 1) @ _rot_axis(b + n[..., 1], 0) @ _rot_axis(a + n[..., 0], 2)
    return rotmat_to_aa(r).to(rotvec.dtype)


def compute_stats(repr_frames: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mean [294], std [294]); std shared within each block but the betas,
    contact labels left unnormalized."""
    flat = np.asarray(repr_frames, np.float64).reshape(-1, BODY_FEAT_DIM)
    mean = flat.mean(axis=0)
    std = flat.std(axis=0)
    for name in REPR_LIST:
        sl = block_slice(name)
        if name == "foot_contact":
            mean[sl] = 0.0
            std[sl] = 1.0
        elif name != "smplx_betas":
            std[sl] = std[sl].mean()
    std[std == 0.0] = 1.0
    return mean.astype(np.float32), std.astype(np.float32)


def lower_pose_mask(batch_size: int, frames: int) -> np.ndarray:
    """The 'lower' scheme's PoseNet condition mask [B, frames, 294]: the 8
    lower-body joints' position, velocity and rotation dims and the contact
    labels hidden; the trajectory and betas visible."""
    keep = np.ones(22, np.float32)
    keep[LOWER_BODY_JOINTS] = 0.0
    vis = np.ones(BODY_FEAT_DIM, np.float32)
    t = TRAJ_FEAT_DIM_FULL
    vis[t:t + 66] = np.repeat(keep, 3)
    vis[t + 66:t + 132] = np.repeat(keep, 3)
    vis[t + 132:t + 258] = np.repeat(keep[1:], 6)
    vis[-4:] = 0.0
    return np.broadcast_to(vis, (batch_size, frames, BODY_FEAT_DIM)).copy()


@torch.no_grad()
def make_pool(body, n_clips: int, clip_len: int, seed: int, noise: dict, device,
              chunk: int = 256) -> dict:
    """The evaluation's inputs for n_clips clips: traj_cond [N, T-1, 13],
    traj_clean and pose_noisy [N, T-1, 294] (normalized; the pose view's
    noisy repr keeps the clean trajectory), and the stats (mean, std).

    Each clip is canonicalized (floor at z = 0, frame 0's pelvis over the
    origin, facing y+), its parameters noised with the standard deviations
    of `noise`, and both versions encoded."""
    rng = np.random.default_rng(seed)
    clip_seeds = rng.integers(0, 2**31 - 1, size=n_clips)
    params = [clip_params(clip_len, int(s)) for s in clip_seeds]

    def fk(p):
        return torch.cat([forward_joints(
            body, *(torch.as_tensor(p[k][s:s + chunk], dtype=torch.float32, device=device)
                    for k in ("betas", "global_orient", "body_pose", "transl")), num_joints=22)
            for s in range(0, len(p["betas"]), chunk)]).cpu().numpy().astype(np.float64)

    stacked = {k: np.stack([p[k] for p in params]) for k in PARAM_NAMES}
    joints = fk(stacked)
    cano_pos = np.empty_like(joints)
    cano = {k: np.empty_like(stacked[k]) for k in PARAM_NAMES}
    for i in range(n_clips):
        pos_i, cp_i = cano_seq_smplx(joints[i], {k: stacked[k][i] for k in PARAM_NAMES})
        cano_pos[i] = pos_i
        for k in PARAM_NAMES:
            cano[k][i] = cp_i[k].reshape(clip_len, -1)

    shape = (n_clips, clip_len)

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    noisy = {
        "transl": cano["transl"] + rng.normal(0.0, noise["transl"], shape + (3,)),
        "betas": cano["betas"] + rng.normal(0.0, noise["betas"], shape + (10,)),
        "global_orient": euler_noise_rotvec(dev(cano["global_orient"]), dev(
            rng.normal(0.0, noise["global_orient_deg"], shape + (3,)))).cpu().numpy(),
        "body_pose": euler_noise_rotvec(dev(cano["body_pose"].reshape(shape + (21, 3))), dev(
            rng.normal(0.0, noise["body_pose_deg"], shape + (21, 3)))).reshape(shape + (63,)).cpu().numpy(),
    }
    noisy_pos = fk(noisy)

    def encode(pos, p):
        out = []
        for s in range(0, n_clips, chunk):
            t = {k: torch.as_tensor(v[s:s + chunk], dtype=torch.float32, device=device) for k, v in p.items()}
            out.append(get_repr(torch.as_tensor(pos[s:s + chunk], dtype=torch.float32, device=device),
                                global_orient=t["global_orient"], transl=t["transl"],
                                body_pose=t["body_pose"], betas=t["betas"]).cpu().numpy())
        return np.concatenate(out).astype(np.float32)

    repr_clean = encode(cano_pos, cano)
    repr_noisy = encode(noisy_pos, noisy)
    mean, std = compute_stats(repr_clean)
    clean_n = (repr_clean - mean) / std
    noisy_n = (repr_noisy - mean) / std
    pose_noisy = noisy_n.copy()
    pose_noisy[..., :TRAJ_FEAT_DIM_FULL] = clean_n[..., :TRAJ_FEAT_DIM_FULL]
    return {
        "traj_cond": np.ascontiguousarray(noisy_n[..., TRAJ_ABS_INDEX]),
        "traj_clean": clean_n.astype(np.float32),
        "pose_noisy": pose_noisy.astype(np.float32),
        "mean": mean, "std": std,
    }


def make_body(seed: int, device, num_verts: int = 10475):
    """The reference's body model on the device from the seed's arrays
    (drivers/recon.py builds the port's from the same arrays)."""
    arrays = body_arrays(seed, num_verts)
    return arrays, make_model(arrays, SMPLX_PARENTS, device)
