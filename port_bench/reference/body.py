"""SMPL-X in PyTorch: the body model the guided chain differentiates.

A frozen copy of rohm_tpu_torch/body/model.py's joints path. Skeleton joints depend only on the
shaped rest skeleton and the kinematic chain, so ``j_template =
J_regressor @ v_template`` and ``j_shapedirs = J_regressor @ shapedirs``
are precomputed once and `forward_joints` is a (..., 10) x (10, 55*3)
product plus a chain of 3x3 products, unrolled in Python (22 joints on the
guided path; up to 55). Everything is plain torch, so
autograd flows through it (skating guidance takes its gradient through
here on every guided step).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .rotations import aa_to_rotmat

NUM_BETAS = 10
NUM_BODY_JOINTS = 22  # pelvis + 21 body joints; all RoHM losses use these
NUM_JOINTS = 55  # full SMPL-X skeleton (body + jaw + eyes + 30 hand joints)

# Fixed SMPL-X kinematic tree (parent of joint i; -1 for pelvis root).
SMPLX_PARENTS = np.array(
    [
        -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
        18, 19,  # 22 body joints
        15, 15, 15,  # jaw, left eye, right eye
        20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,  # left hand
        21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53,  # right hand
    ],
    dtype=np.int32,
)


@dataclass(frozen=True)
class SmplxModel:
    """SMPL-X parameters as tensors on one device.

    Attributes with leading dimension V refer to the template mesh (10475 for
    real SMPL-X; smaller for synthetic models).
    """

    v_template: torch.Tensor  # [V, 3]
    shapedirs: torch.Tensor  # [V, 3, NUM_BETAS]
    posedirs: torch.Tensor  # [(NUM_JOINTS-1)*9, V*3] pose-blend basis
    j_regressor: torch.Tensor  # [NUM_JOINTS, V]
    lbs_weights: torch.Tensor  # [V, NUM_JOINTS]
    parents: tuple  # tuple[int], len NUM_JOINTS
    j_template: torch.Tensor  # [NUM_JOINTS, 3]
    j_shapedirs: torch.Tensor  # [NUM_JOINTS, 3, NUM_BETAS]
    faces: np.ndarray | None = None  # [F, 3] int (None for synthetic models)
    # content hash stamped at construction (dataset disk-cache keys)
    fingerprint: str | None = None

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]


def make_model(
    arrays: dict, parents, device, dtype=torch.float32, faces=None, fingerprint=None,
) -> SmplxModel:
    """Build the container from numpy arrays (v_template, shapedirs, posedirs,
    j_regressor, lbs_weights; optional precomputed j_template/j_shapedirs)."""
    t = {k: torch.tensor(np.asarray(v), dtype=dtype, device=device) for k, v in arrays.items()}
    if "j_template" not in t:
        t["j_template"] = t["j_regressor"] @ t["v_template"]
    if "j_shapedirs" not in t:
        t["j_shapedirs"] = torch.einsum("jv,vck->jck", t["j_regressor"], t["shapedirs"])
    return SmplxModel(parents=tuple(int(p) for p in parents), faces=faces,
                      fingerprint=fingerprint, **t)


def synthetic_model(num_verts: int = 512, seed: int = 0, device="cpu",
                    dtype=torch.float32) -> SmplxModel:
    """Deterministic synthetic SMPL-X-shaped model for tests and benchmarks.

    Same numpy generator as rohm_tpu.body.synthetic_model, so one seed gives
    the same arrays in both packages."""
    rng = np.random.default_rng(seed)
    base_joints = np.zeros((NUM_JOINTS, 3), np.float64)
    offsets = rng.normal(scale=0.08, size=(NUM_JOINTS, 3))
    offsets[:, 1] -= 0.05  # bias limbs downward a bit
    for j in range(1, NUM_JOINTS):
        base_joints[j] = base_joints[SMPLX_PARENTS[j]] + offsets[j]
    base_joints[0, 1] += 0.9  # pelvis above origin

    # scatter vertices around joints so the regressor is near-interpolatory
    owner = rng.integers(0, NUM_JOINTS, size=num_verts)
    v_template = base_joints[owner] + rng.normal(scale=0.05, size=(num_verts, 3))

    j_regressor = np.zeros((NUM_JOINTS, num_verts), np.float64)
    for j in range(NUM_JOINTS):
        mask = owner == j
        if mask.sum() == 0:  # guarantee nonempty support
            mask[rng.integers(0, num_verts)] = True
        j_regressor[j, mask] = 1.0 / mask.sum()
    j_regressor += np.abs(rng.normal(scale=1e-3, size=j_regressor.shape))
    j_regressor /= j_regressor.sum(axis=1, keepdims=True)

    shapedirs = rng.normal(scale=0.01, size=(num_verts, 3, NUM_BETAS))
    posedirs = rng.normal(scale=1e-3, size=((NUM_JOINTS - 1) * 9, num_verts * 3))

    lbs_w = np.zeros((num_verts, NUM_JOINTS), np.float64)
    lbs_w[np.arange(num_verts), owner] = 1.0
    parent_of_owner = np.maximum(SMPLX_PARENTS[owner], 0)
    lbs_w[np.arange(num_verts), parent_of_owner] += 0.5
    lbs_w /= lbs_w.sum(axis=1, keepdims=True)

    arrays = {
        "v_template": v_template, "shapedirs": shapedirs, "posedirs": posedirs,
        "j_regressor": j_regressor, "lbs_weights": lbs_w,
    }
    return make_model(arrays, SMPLX_PARENTS, device, dtype,
                      fingerprint=f"synthetic-{num_verts}-{seed}-{dtype}")


def _pose_rotmats(global_orient, body_pose, num_joints: int, global_orient_mat=None,
                  body_pose_mat=None) -> torch.Tensor:
    """Per-joint rotation matrices [..., num_joints, 3, 3]: the root and the
    21 body joints from axis-angle (or from the given matrices); joints 22
    and above (jaw, eyes, hands) are the identity, as RoHM zeroes them
    (flat_hand_mean=True)."""
    if global_orient_mat is not None and body_pose_mat is not None:
        rots = torch.cat([global_orient_mat[..., None, :, :], body_pose_mat], dim=-3)
    else:
        aa = torch.cat(
            [global_orient[..., None, :], body_pose.reshape(body_pose.shape[:-1] + (21, 3))],
            dim=-2,
        )
        rots = aa_to_rotmat(aa)
    rots = rots[..., :num_joints, :, :]
    if num_joints > NUM_BODY_JOINTS:
        eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
        rots = torch.cat([rots, eye.expand(rots.shape[:-3] + (num_joints - NUM_BODY_JOINTS, 3, 3))], dim=-3)
    return rots


def _kinematic_chain(rots: torch.Tensor, joints_rest: torch.Tensor, parents) -> tuple[list, list]:
    """The chain unrolled in Python: per joint its world rotation and posed
    position (lists of [..., 3, 3] and [..., 3]). A joint past the body's 22
    has an identity rotation, so it takes its parent's world rotation as it
    is (the product with the identity is exact)."""
    world_rots = [rots[..., 0, :, :]]
    world_pos = [joints_rest[..., 0, :]]
    for j in range(1, rots.shape[-3]):
        p = parents[j]
        rel = joints_rest[..., j, :] - joints_rest[..., p, :]
        world_rots.append(world_rots[p] @ rots[..., j, :, :] if j < NUM_BODY_JOINTS else world_rots[p])
        world_pos.append(world_pos[p] + (world_rots[p] @ rel[..., None])[..., 0])
    return world_rots, world_pos


def forward_joints(
    model: SmplxModel,
    betas: torch.Tensor,
    global_orient: torch.Tensor | None,
    body_pose: torch.Tensor | None,
    transl: torch.Tensor,
    num_joints: int = NUM_BODY_JOINTS,
    global_orient_mat: torch.Tensor | None = None,
    body_pose_mat: torch.Tensor | None = None,
) -> torch.Tensor:
    """Posed skeleton joints [..., num_joints, 3], num_joints <= 55.

    SMPL-X's skeleton joints are regressed from the shaped (not posed)
    template, so no vertex skinning is needed. Pass global_orient_mat
    [..., 3, 3] / body_pose_mat [..., 21, 3, 3] to skip the axis-angle
    conversion (the repr decode path and the bridge do).
    """
    if not 1 <= num_joints <= NUM_JOINTS:
        raise ValueError(f"num_joints must be in 1..{NUM_JOINTS}, got {num_joints}")
    joints_rest = model.j_template + torch.einsum("...k,jck->...jc", betas, model.j_shapedirs)
    joints_rest = joints_rest[..., :num_joints, :]
    rots = _pose_rotmats(global_orient, body_pose, num_joints, global_orient_mat, body_pose_mat)
    _, world_pos = _kinematic_chain(rots, joints_rest, model.parents)
    return torch.stack(world_pos, dim=-2) + transl[..., None, :]

