"""Batched, differentiable rotation conversions in PyTorch."""

from rohm_tpu_torch.geometry.rotations import (
    aa_to_quat,
    aa_to_rotmat,
    euler_to_quat,
    qbetween,
    qeuler,
    qfix,
    qinv,
    qmul,
    qnormalize,
    qrot,
    qslerp,
    quat_to_aa,
    quat_to_rotmat,
    rot6d_to_rotmat,
    rotmat_to_aa,
    rotmat_to_quat,
    rotmat_to_rot6d,
    skew_angular_velocity,
)

__all__ = [
    "aa_to_quat", "aa_to_rotmat", "euler_to_quat", "qbetween", "qeuler", "qfix", "qinv",
    "qmul", "qnormalize", "qrot", "qslerp",
    "quat_to_aa", "quat_to_rotmat", "rot6d_to_rotmat", "rotmat_to_aa",
    "rotmat_to_quat", "rotmat_to_rot6d", "skew_angular_velocity",
]
