"""Offscreen rendering helpers (reference utils/render_util.py, pyrender/trimesh).

A copy of rohm_tpu/viz/render.py. Import of pyrender/trimesh is deferred so
the port never depends on GL; calling any builder without them installed
raises a clear error.
"""

from __future__ import annotations

import numpy as np

CONTACT_IDX = {7: 0, 10: 1, 8: 2, 11: 3}

# (r, g, b, a) material base colors (render_util.py:6-56)
COLOR_BODY_REC_VIS = (66 / 255, 149 / 255, 245 / 255, 1.0)
COLOR_BODY_REC_OCC = (212 / 255, 189 / 255, 102 / 255, 1.0)
COLOR_BODY_NOISY = (198 / 255, 226 / 255, 255 / 255, 1.0)
COLOR_BODY_GT = (1.0, 102 / 255, 102 / 255, 1.0)
COLOR_SKEL_VIS = (90 / 255, 135 / 255, 247 / 255, 1.0)
COLOR_SKEL_OCC = (219 / 255, 199 / 255, 123 / 255, 1.0)
COLOR_CONTACT_ON = (0.0, 139 / 255, 0.0, 1.0)
COLOR_CONTACT_OFF = (205 / 255, 0.0, 0.0, 1.0)


def _require():
    try:
        import pyrender
        import trimesh

        return pyrender, trimesh
    except ImportError as e:
        raise ImportError(
            "pyrender + trimesh are required for offscreen rendering; install "
            "them or run with --render=False"
        ) from e


def material(color):
    pyrender, _ = _require()
    return pyrender.MetallicRoughnessMaterial(
        metallicFactor=0.0, alphaMode="OPAQUE", baseColorFactor=color
    )


def create_render_cam(cam_x, cam_y, fx, fy):
    """Intrinsics camera + light, pose flipped into the GL convention
    (render_util.py:59-68)."""
    pyrender, _ = _require()
    camera_pose = np.eye(4) * np.array([1.0, -1.0, -1.0, 1.0]).reshape(-1, 1)
    camera = pyrender.camera.IntrinsicsCamera(fx=fx, fy=fy, cx=cam_x, cy=cam_y)
    light = pyrender.DirectionalLight(color=np.ones(3), intensity=3.0)
    return camera, camera_pose, light


def checkerboard_floor(trans, tile_width=0.5, length=25.0,
                       color0=(0.8, 0.9, 0.9), color1=(0.6, 0.7, 0.7)):
    """Checkerboard ground plane mesh, moved by inv(trans) (render_util.py:70-105)."""
    pyrender, trimesh = _require()
    radius = length / 2.0
    n = int(length / tile_width)
    vertices, faces, face_colors = [], [], []
    for i in range(n):
        for j in range(n):
            x0, y0 = -radius + j * tile_width, radius - i * tile_width
            quad = np.array([
                [x0, y0, 0.0], [x0, y0 - tile_width, 0.0],
                [x0 + tile_width, y0 - tile_width, 0.0], [x0 + tile_width, y0, 0.0],
            ])
            tri = np.array([[0, 1, 3], [1, 2, 3]]) + 4 * (i * n + j)
            c = color0 if (i + j) % 2 == 0 else color1
            vertices.append(quad)
            faces.append(tri)
            face_colors.append(np.array([c + (1.0,), c + (1.0,)]))
    ground = trimesh.Trimesh(
        vertices=np.concatenate(vertices),
        faces=np.concatenate(faces),
        face_colors=np.concatenate(face_colors),
        process=False,
    )
    ground.apply_transform(np.linalg.inv(trans))
    return pyrender.Mesh.from_trimesh(ground, smooth=False)


def create_scene(camera, camera_pose, light):
    pyrender, _ = _require()
    scene = pyrender.Scene(bg_color=[0, 0, 0, 0], ambient_light=(0.3, 0.3, 0.3))
    scene.add(camera, pose=camera_pose)
    scene.add(light, pose=camera_pose)
    return scene


def add_body_mesh(scene, verts, faces, color=COLOR_BODY_REC_VIS, vertex_alpha=None):
    """Add a body mesh; vertex_alpha ([V] in [0,1]) renders occluded parts
    translucent (eval_amass_full.py render path)."""
    pyrender, trimesh = _require()
    tm = trimesh.Trimesh(np.asarray(verts), np.asarray(faces), process=False)
    if vertex_alpha is not None:
        rgba = np.tile(np.asarray(color) * 255, (len(verts), 1))
        rgba[:, 3] = np.asarray(vertex_alpha) * 255
        tm.visual.vertex_colors = rgba.astype(np.uint8)
        mesh = pyrender.Mesh.from_trimesh(tm, smooth=False)
    else:
        mesh = pyrender.Mesh.from_trimesh(tm, material=material(color), smooth=False)
    scene.add(mesh, "body_mesh")
    return scene


def render_rgba(scene, width=1920, height=1080):
    pyrender, _ = _require()
    r = pyrender.OffscreenRenderer(viewport_width=width, viewport_height=height)
    color, _ = r.render(scene, flags=pyrender.RenderFlags.RGBA)
    r.delete()
    return color


def overlay_on_image(rgba: np.ndarray, image: np.ndarray) -> np.ndarray:
    """Alpha-composite a rendered RGBA frame over an RGB image
    (render_util.py:161-174)."""
    alpha = rgba[..., 3:4].astype(np.float64) / 255.0
    out = rgba[..., :3].astype(np.float64) * alpha + image[..., :3].astype(np.float64) * (1 - alpha)
    return out.astype(np.uint8)
