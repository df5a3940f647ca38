"""get_occlusion_mask — depth-test joint visibility masks for a PROX recording,
in PyTorch.

The port of rohm_tpu/cli/get_occlusion_mask.py (reference
utils/get_occlusion_mask.py:49-180): render the PROX scene's depth and each
frame's body depth with pyrender, project the 25 joints with the distorted
PROX color camera, and mark a joint occluded when the body's depth at its
pixel exceeds the scene's by more than 0.1 m. Writes mask_joint.npy
([T, 25], 1 = visible). The SMPL-X forward (`forward_vertices`) runs on the
device; the projection is OpenCV's model in float64 numpy
(`data.video.project_points_distorted`). pyrender and trimesh are imported
when the tool runs, and it raises ImportError where they are absent. Run:

    python -m rohm_tpu_torch.cli.get_occlusion_mask --prox_root=datasets/PROX \\
        --seq_name=MPH11_00034_01 --scene_name=MPH11 --device=0

`--device` is a CUDA index (default 0) or `cpu`; an index with no CUDA
device raises.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch

from rohm_tpu_torch.body.model import forward_vertices
from rohm_tpu_torch.cli.common import resolve_body_model, resolve_device
from rohm_tpu_torch.data.video import project_points_distorted
from rohm_tpu_torch.utils.config import ConfigParser

DEPTH_THRESH = 0.1
IMG_W, IMG_H = 1920, 1080
NUM_MASK_JOINTS = 25


def build_parser() -> ConfigParser:
    p = ConfigParser("RoHM occlusion mask tool (PyTorch)")
    p.add_argument("--prox_root", type=str, default="datasets/PROX")
    p.add_argument("--init_body_path", type=str, default="data/init_motions/init_prox_rgb")
    p.add_argument("--body_model_path", type=str, default="data/body_models/smplx_model")
    p.add_argument("--seq_name", type=str, default="MPH11_00034_01")
    p.add_argument("--scene_name", type=str, default="MPH11")
    p.add_argument("--save_mask_path", type=str, default="datasets/PROX/mask_joint")
    p.add_argument("--max_frames", type=int, default=0)
    p.add_argument("--device", type=str, default="0")
    return p


def depth_test(uv: np.ndarray, depth_scene: np.ndarray, depth_body: np.ndarray) -> np.ndarray:
    """Per joint 1 (visible) or 0 (occluded) from its integer pixel uv
    [J, 2]: occluded where the scene has depth there and the body lies more
    than DEPTH_THRESH behind it; joints outside the image stay visible."""
    mask = np.ones(len(uv))
    for j, (x, y) in enumerate(uv):
        if 0 <= x < IMG_W and 0 <= y < IMG_H:
            if depth_scene[y][x] != 0 and depth_body[y][x] - depth_scene[y][x] > DEPTH_THRESH:
                mask[j] = 0
    return mask


def main(argv=None) -> np.ndarray:
    """Write and return the recording's mask [T, 25]."""
    import pyrender
    import trimesh

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    body = resolve_body_model(args.body_model_path, device)

    with open(os.path.join(args.prox_root, "cam2world", args.scene_name + ".json")) as f:
        cam2world = np.array(json.load(f))
    with open(os.path.join(args.prox_root, "calibration", "Color.json")) as f:
        color_cam = json.load(f)

    camera = pyrender.camera.IntrinsicsCamera(fx=1060.53, fy=1060.38, cx=951.30, cy=536.77)
    camera_pose = np.eye(4) * np.array([1.0, -1.0, -1.0, 1.0]).reshape(-1, 1)
    light = pyrender.DirectionalLight(color=np.ones(3), intensity=2.0)

    static_scene = trimesh.load(os.path.join(args.prox_root, "scenes", args.scene_name + ".ply"))
    static_scene.apply_transform(np.linalg.inv(cam2world))

    def render_depth(mesh):
        scene = pyrender.Scene()
        scene.add(camera, pose=camera_pose)
        scene.add(light, pose=camera_pose)
        scene.add(mesh, "mesh")
        r = pyrender.OffscreenRenderer(viewport_width=IMG_W, viewport_height=IMG_H)
        _, depth = r.render(scene)
        r.delete()
        return depth

    depth_scene = render_depth(pyrender.Mesh.from_trimesh(static_scene))

    results_dir = os.path.join(args.init_body_path, args.seq_name, "results")
    frames = sorted(os.listdir(results_dir))
    if args.max_frames:
        frames = frames[: args.max_frames]
    seq_mask = []
    for frame in frames:
        with open(os.path.join(results_dir, frame, "000.pkl"), "rb") as f:
            p = pickle.load(f)
        params = [np.asarray(p[k]).reshape(1, -1)[:, :n]
                  for k, n in (("betas", 10), ("global_orient", 3), ("body_pose", 63), ("transl", 3))]
        with torch.no_grad():
            verts, joints = forward_vertices(
                body, *(torch.as_tensor(a, dtype=torch.float32, device=device) for a in params))
        verts = verts[0].cpu().numpy()
        joints = joints[0, :NUM_MASK_JOINTS].cpu().numpy()
        if body.faces is None:
            # a body model without a face table: its convex hull as the depth proxy
            body_tm = trimesh.Trimesh(verts, process=False).convex_hull
        else:
            body_tm = trimesh.Trimesh(verts, body.faces, process=False)
        depth_body = render_depth(pyrender.Mesh.from_trimesh(body_tm))
        uv = project_points_distorted(joints, color_cam).astype(int)
        seq_mask.append(depth_test(uv, depth_scene, depth_body))

    out_dir = os.path.join(args.save_mask_path, args.seq_name)
    os.makedirs(out_dir, exist_ok=True)
    mask = np.asarray(seq_mask)
    np.save(os.path.join(out_dir, "mask_joint.npy"), mask)
    print(f"saved {len(seq_mask)}-frame mask to {out_dir}/mask_joint.npy")
    return mask


if __name__ == "__main__":
    main()
