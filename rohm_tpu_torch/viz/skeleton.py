"""Skeleton topology + open3d geometry builders (reference utils/vis_util.py).

A copy of rohm_tpu/viz/skeleton.py (numpy; open3d imported where a builder
needs it)."""

from __future__ import annotations

import numpy as np

# 22-joint SMPL body limb topology (reference utils/other_utils.py:62-89)
LIMBS_BODY_SMPL = [
    (15, 12),
    (12, 13), (13, 16), (16, 18), (18, 20),  # left arm
    (12, 14), (14, 17), (17, 19), (19, 21),  # right arm
    (12, 9), (9, 6), (6, 3), (3, 0),  # spine
    (0, 1), (1, 4), (4, 7), (7, 10),  # left leg
    (0, 2), (2, 5), (5, 8), (8, 11),  # right leg
]

COLOR_VIS = (90 / 255, 135 / 255, 247 / 255)
COLOR_OCC = (219 / 255, 199 / 255, 123 / 255)
COLOR_GT = (1.0, 102 / 255, 102 / 255)
COLOR_CONTACT_ON = (0.0, 0.5, 0.0)
COLOR_CONTACT_OFF = (0.5, 0.0, 0.0)

FOOT_JOINTS_CONTACT_ORDER = [7, 10, 8, 11]


def _require_open3d():
    try:
        import open3d as o3d  # noqa: F401

        return o3d
    except ImportError as e:
        raise ImportError(
            "open3d is required for interactive visualization; install it or "
            "run with --visualize=False"
        ) from e


def _rotation_from_z(direction: np.ndarray) -> np.ndarray:
    """Rotation matrix taking +z onto `direction` (for bone arrows)."""
    d = direction / max(np.linalg.norm(direction), 1e-9)
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(z, d)
    c = float(z @ d)
    if np.linalg.norm(v) < 1e-9:
        return np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx * (1 / (1 + c))


def vis_skeleton(joints, limbs=LIMBS_BODY_SMPL, add_trans=None, mask_scheme=None,
                 cur_mask_joint_id=None, start=0, end=0, t=0,
                 color_occ=COLOR_OCC, color_vis=COLOR_VIS, color=None):
    """Bone arrows colored by visibility/occlusion (vis_util.py:11-56).

    `color` overrides the uniform color when mask_scheme is None (the
    reference drivers paint GT/noisy/rec skeletons red/green/blue,
    test_trajnet.py:271-298)."""
    o3d = _require_open3d()
    out = []
    for a, b in limbs:
        length = float(np.linalg.norm(joints[b] - joints[a]))
        arrow = o3d.geometry.TriangleMesh.create_arrow(
            cylinder_radius=0.03, cone_radius=0.001,
            cylinder_height=max(length, 1e-4), cone_height=0.001,
        )
        tf = np.eye(4)
        tf[:3, :3] = _rotation_from_z(joints[b] - joints[a])
        tf[:3, 3] = joints[a] + (add_trans if add_trans is not None else 0.0)
        arrow.transform(tf)
        if mask_scheme is None:
            arrow.paint_uniform_color(COLOR_GT if color is None else color)
        elif mask_scheme in ("lower", "upper", "video"):
            occluded = a in cur_mask_joint_id or b in cur_mask_joint_id
            arrow.paint_uniform_color(color_occ if occluded else color_vis)
        elif mask_scheme == "full":
            arrow.paint_uniform_color(color_occ if start <= t < end else color_vis)
        else:
            raise ValueError(f"mask_scheme {mask_scheme} not defined")
        arrow.compute_vertex_normals()
        out.append(arrow)
    return out


def vis_foot_contact(joints, contact_lbl, add_trans=None):
    """Green/red spheres on the 4 foot joints by contact label (vis_util.py:60-80)."""
    o3d = _require_open3d()
    out = []
    for k, j in enumerate(FOOT_JOINTS_CONTACT_ORDER):
        sphere = o3d.geometry.TriangleMesh.create_sphere(radius=0.05)
        pos = joints[j] + (add_trans if add_trans is not None else 0.0)
        sphere.translate(pos)
        on = contact_lbl[k] > 0.5
        sphere.paint_uniform_color(COLOR_CONTACT_ON if on else COLOR_CONTACT_OFF)
        sphere.compute_vertex_normals()
        out.append(sphere)
    return out


def body_mesh(verts, faces, color=COLOR_VIS):
    o3d = _require_open3d()
    mesh = o3d.geometry.TriangleMesh()
    mesh.vertices = o3d.utility.Vector3dVector(np.asarray(verts))
    mesh.triangles = o3d.utility.Vector3iVector(np.asarray(faces))
    mesh.paint_uniform_color(color)
    mesh.compute_vertex_normals()
    return mesh


def update_cam_extrinsic(cam_param, trans: np.ndarray):
    """open3d camera from a 4x4 world transform (other_utils.py:91-99)."""
    cam_r = trans[:-1, :-1].T
    cam_t = cam_r @ (-trans[:-1, -1:])
    mat = np.eye(4)
    mat[:3, :3] = cam_r
    mat[:3, 3:] = cam_t
    cam_param.extrinsic = mat
    return cam_param
