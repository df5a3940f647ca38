"""Batched, differentiable rotation conversions in PyTorch.

A frozen copy of rohm_tpu_torch/geometry/rotations.py: what forward
kinematics, the repr encoder/decoder and the traj->pose bridge call. Every
function takes
arbitrary leading batch dimensions. Numerically sensitive branches keep the
JAX package's "double-where" pattern, so gradients stay finite at the branch
boundaries: test-time guidance differentiates rot6d -> rotmat -> SMPL-X
forward kinematics with torch.autograd.

Conventions:
- quaternions are (w, x, y, z), scalar first
- rot6d is the first two *columns* of R flattened row-major:
  [m00, m01, m10, m11, m20, m21]  == R[..., :2].reshape(..., 6)
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def _safe_sqrt(x: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """sqrt with clamped input; finite gradient at 0."""
    return torch.sqrt(torch.clamp(x, min=eps))


def _safe_div(num: torch.Tensor, den: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """num/den with |den| < eps nudged by +eps (kornia safe_zero_division)."""
    den = torch.where(den.abs() < eps, den + eps, den)
    return num / den


def _norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# ---------------------------------------------------------------------------
# quaternion algebra
# ---------------------------------------------------------------------------


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of unit quaternion(s), shape (..., 4)."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def qnormalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / _norm(q, eps)


def qmul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product q*r for (..., 4) tensors (w,x,y,z)."""
    qw, qx, qy, qz = q.unbind(-1)
    rw, rx, ry, rz = r.unbind(-1)
    w = qw * rw - qx * rx - qy * ry - qz * rz
    x = qw * rx + qx * rw + qy * rz - qz * ry
    y = qw * ry - qx * rz + qy * rw + qz * rx
    z = qw * rz + qx * ry - qy * rx + qz * rw
    return torch.stack([w, x, y, z], dim=-1)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    qvec = q[..., 1:]
    uv = _cross(qvec, v)
    uuv = _cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qbetween(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """Quaternion rotating v0 to v1 (shortest arc), shape (..., 3) -> (..., 4).

    Antiparallel inputs yield a zero quaternion before normalization; callers
    patch those frames (reprs/encode.py).
    """
    v = _cross(v0, v1)
    n0 = (v0 * v0).sum(-1, keepdim=True)
    n1 = (v1 * v1).sum(-1, keepdim=True)
    w = torch.sqrt(n0 * n1) + (v0 * v1).sum(-1, keepdim=True)
    return qnormalize(torch.cat([w, v], dim=-1))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalized quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    two_s = 2.0 / torch.clamp((q * q).sum(-1), min=1e-12)
    w, x, y, z = q.unbind(-1)
    tw, tx, ty, tz = two_s * w, two_s * x, two_s * y, two_s * z
    m = torch.stack(
        [
            1.0 - (ty * y + tz * z), tx * y - tz * w, tx * z + ty * w,
            tx * y + tz * w, 1.0 - (tx * x + tz * z), ty * z - tx * w,
            tx * z - ty * w, ty * z + tx * w, 1.0 - (tx * x + ty * y),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(m: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4) (w,x,y,z).

    Branchless Shepperd selection via nested `where`; all four branch values
    use a clamped sqrt so gradients stay finite.
    """
    flat = m.reshape(m.shape[:-2] + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = [flat[..., i : i + 1] for i in range(9)]
    trace = m00 + m11 + m22

    sq_w = _safe_sqrt(trace + 1.0, eps) * 2.0
    cand_w = torch.cat(
        [0.25 * sq_w, _safe_div(m21 - m12, sq_w), _safe_div(m02 - m20, sq_w), _safe_div(m10 - m01, sq_w)],
        dim=-1,
    )
    sq_x = _safe_sqrt(1.0 + m00 - m11 - m22, eps) * 2.0
    cand_x = torch.cat(
        [_safe_div(m21 - m12, sq_x), 0.25 * sq_x, _safe_div(m01 + m10, sq_x), _safe_div(m02 + m20, sq_x)],
        dim=-1,
    )
    sq_y = _safe_sqrt(1.0 + m11 - m00 - m22, eps) * 2.0
    cand_y = torch.cat(
        [_safe_div(m02 - m20, sq_y), _safe_div(m01 + m10, sq_y), 0.25 * sq_y, _safe_div(m12 + m21, sq_y)],
        dim=-1,
    )
    sq_z = _safe_sqrt(1.0 + m22 - m00 - m11, eps) * 2.0
    cand_z = torch.cat(
        [_safe_div(m10 - m01, sq_z), _safe_div(m02 + m20, sq_z), _safe_div(m12 + m21, sq_z), 0.25 * sq_z],
        dim=-1,
    )

    where_2 = torch.where(m11 > m22, cand_y, cand_z)
    where_1 = torch.where((m00 > m11) & (m00 > m22), cand_x, where_2)
    return torch.where(trace > 0.0, cand_w, where_1)


def quat_to_aa(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) -> axis-angle (..., 3) (kornia-compatible)."""
    w = q[..., 0:1]
    v = q[..., 1:]
    sin_sq = (v * v).sum(-1, keepdim=True)
    # double-where: keep sqrt's input away from 0 on the branch we discard
    safe_sin = torch.sqrt(torch.where(sin_sq > _EPS, sin_sq, torch.ones_like(sin_sq)))
    two_theta = 2.0 * torch.where(
        w < 0.0, torch.atan2(-safe_sin, -w), torch.atan2(safe_sin, w)
    )
    k = torch.where(sin_sq > _EPS, two_theta / safe_sin, torch.full_like(sin_sq, 2.0))
    return v * k


def aa_to_quat(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> quaternion (..., 4), stable near zero."""
    theta_sq = (aa * aa).sum(-1, keepdim=True)
    safe = theta_sq > _EPS
    theta = torch.sqrt(torch.where(safe, theta_sq, torch.ones_like(theta_sq)))
    half = 0.5 * theta
    w = torch.where(safe, torch.cos(half), 1.0 - theta_sq / 8.0)
    # sin(t/2)/t -> 1/2 as t -> 0
    k = torch.where(safe, torch.sin(half) / theta, 0.5 - theta_sq / 48.0)
    return torch.cat([w, aa * k], dim=-1)


def aa_to_rotmat(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3), Rodrigues formula
    R = I + sin(t)/t K + (1-cos(t))/t^2 K^2 with series fallbacks near t=0."""
    theta_sq = (aa * aa).sum(-1)[..., None, None]
    safe = theta_sq > _EPS
    theta_sq_safe = torch.where(safe, theta_sq, torch.ones_like(theta_sq))
    theta = torch.sqrt(theta_sq_safe)

    x, y, z = aa.unbind(-1)
    zeros = torch.zeros_like(x)
    k = torch.stack([zeros, -z, y, z, zeros, -x, -y, x, zeros], dim=-1).reshape(
        aa.shape[:-1] + (3, 3)
    )
    k2 = k @ k

    a = torch.where(safe, torch.sin(theta) / theta, 1.0 - theta_sq / 6.0)
    b = torch.where(safe, (1.0 - torch.cos(theta)) / theta_sq_safe, 0.5 - theta_sq / 24.0)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(k.shape)
    return eye + a * k + b * k2


def rotmat_to_aa(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3) via quaternion."""
    return quat_to_aa(rotmat_to_quat(m))


# ---------------------------------------------------------------------------
# 6-D rotation representation (Zhou et al. CVPR 2019, column layout)
# ---------------------------------------------------------------------------


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6-D rotation (..., 6) -> matrix (..., 3, 3), Gram-Schmidt on columns."""
    cols = x.reshape(x.shape[:-1] + (3, 2))
    a1 = cols[..., 0]
    a2 = cols[..., 1]
    b1 = a1 / _norm(a1, 1e-12)
    proj = (b1 * a2).sum(-1, keepdim=True)
    u2 = a2 - proj * b1
    b2 = u2 / _norm(u2, 1e-12)
    b3 = _cross(b1, b2)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_rot6d(m: torch.Tensor) -> torch.Tensor:
    """Matrix (..., 3, 3) -> 6-D representation (first two columns, row-major)."""
    return m[..., :2].reshape(m.shape[:-2] + (6,))


def skew_angular_velocity(rot_seq: torch.Tensor, drdt: torch.Tensor) -> torch.Tensor:
    """Angular velocity from rotation sequence + finite-difference dR/dt.

    w_mat = dRdt @ R^T is skew-symmetric; average the symmetric entries
    (reference utils/other_utils.py:243-277). Shapes (..., 3, 3) -> (..., 3).
    """
    w_mat = drdt @ rot_seq.transpose(-1, -2)
    w_x = (-w_mat[..., 1, 2] + w_mat[..., 2, 1]) / 2.0
    w_y = (w_mat[..., 0, 2] - w_mat[..., 2, 0]) / 2.0
    w_z = (-w_mat[..., 0, 1] + w_mat[..., 1, 0]) / 2.0
    return torch.stack([w_x, w_y, w_z], dim=-1)


# ---------------------------------------------------------------------------
# the rest of the quaternion library (rohm_tpu/geometry/rotations.py:253-351):
# Euler angles, sequence sign continuity, slerp. No pipeline calls them.
# ---------------------------------------------------------------------------


_AXIS_INDEX = {"x": 0, "y": 1, "z": 2}
