"""Repr schema bookkeeping (reference utils/other_utils.py:17-37).

A frozen copy of rohm_tpu_torch/reprs/schema.py (numpy only).

Per-frame layout, 294 dims total:

  offset  block                dims
  ------  -------------------  ----
      0   root_rot_angle          1   joint-based traj (abs)
      1   root_rot_angle_vel      1   joint-based traj (vel)
      2   root_l_pos              2   abs
      4   root_l_vel              2   vel
      6   root_height             1   abs
      7   smplx_rot_6d            6   smplx traj (abs)
     13   smplx_rot_vel           3   vel
     16   smplx_trans             3   abs
     19   smplx_trans_vel         3   vel
     22   local_positions        66   22*3
     88   local_vel              66
    154   smplx_body_pose_6d    126   21*6
    280   smplx_betas            10
    290   foot_contact            4   (l_ankle, l_toe, r_ankle, r_toe)
"""

from __future__ import annotations

import numpy as np

REPR_LIST = [
    "root_rot_angle",
    "root_rot_angle_vel",
    "root_l_pos",
    "root_l_vel",
    "root_height",
    "smplx_rot_6d",
    "smplx_rot_vel",
    "smplx_trans",
    "smplx_trans_vel",
    "local_positions",
    "local_vel",
    "smplx_body_pose_6d",
    "smplx_betas",
    "foot_contact",
]

REPR_DIM_DICT = {
    "root_rot_angle": 1,
    "root_rot_angle_vel": 1,
    "root_l_pos": 2,
    "root_l_vel": 2,
    "root_height": 1,
    "smplx_rot_6d": 6,
    "smplx_rot_vel": 3,
    "smplx_trans": 3,
    "smplx_trans_vel": 3,
    "local_positions": 22 * 3,
    "local_vel": 22 * 3,
    "smplx_body_pose_6d": 21 * 6,
    "smplx_betas": 10,
    "foot_contact": 4,
}

BODY_FEAT_DIM = sum(REPR_DIM_DICT.values())  # 294

_TRAJ_BLOCKS_FULL = [
    "root_rot_angle",
    "root_rot_angle_vel",
    "root_l_pos",
    "root_l_vel",
    "root_height",
    "smplx_rot_6d",
    "smplx_rot_vel",
    "smplx_trans",
    "smplx_trans_vel",
]
_TRAJ_BLOCKS_ABS = [
    "root_rot_angle",
    "root_l_pos",
    "root_height",
    "smplx_rot_6d",
    "smplx_trans",
]

TRAJ_FEAT_DIM_FULL = sum(REPR_DIM_DICT[k] for k in _TRAJ_BLOCKS_FULL)  # 22
TRAJ_FEAT_DIM_ABS = sum(REPR_DIM_DICT[k] for k in _TRAJ_BLOCKS_ABS)  # 13
POSE_FEAT_DIM = BODY_FEAT_DIM - TRAJ_FEAT_DIM_FULL  # 272

# indices of the abs-only traj dims inside the full 294/22-d layout
# ([0], [2:4], [6], [7:13], [16:19] — reference model/trajnet.py:293-297)
TRAJ_ABS_INDEX = np.array([0, 2, 3, 6, 7, 8, 9, 10, 11, 12, 16, 17, 18], dtype=np.int32)

# foot joints in contact-label order: l_ankle(7), l_toe(10), r_ankle(8), r_toe(11)
FOOT_JOINT_INDEX = np.array([7, 10, 8, 11], dtype=np.int32)

_OFFSETS = {}
_cur = 0
for _name in REPR_LIST:
    _OFFSETS[_name] = _cur
    _cur += REPR_DIM_DICT[_name]


def block_slice(name: str) -> slice:
    """Slice of block `name` within the flat 294-d axis."""
    start = _OFFSETS[name]
    return slice(start, start + REPR_DIM_DICT[name])


def split_repr(x) -> dict:
    """Split a flat [..., 294] repr into the named block dict."""
    return {name: x[..., block_slice(name)] for name in REPR_LIST}


def scatter_traj_abs(full_repr, traj_abs):
    """Write the 13 abs-only traj dims back into a full [..., >=22] repr.

    torch- and numpy-compatible (returns a copy); mirrors the scatter at
    reference test_amass_full.py:272-277 / model/trajnet.py:292-297.
    """
    if hasattr(full_repr, "clone"):  # torch tensor
        out = full_repr.clone()
        out[..., list(TRAJ_ABS_INDEX)] = traj_abs.to(out.dtype)
        return out
    out = full_repr.copy()
    out[..., TRAJ_ABS_INDEX] = traj_abs
    return out


def gather_traj_abs(full_repr):
    """Extract the 13 abs-only traj dims from a [..., >=22] repr."""
    return full_repr[..., TRAJ_ABS_INDEX]
