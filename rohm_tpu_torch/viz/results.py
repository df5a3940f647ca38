"""Result-pickle visualization entry (reference eval_amass_full.py:150-396).

The port of rohm_tpu/viz/results.py: the saved reprs decode to SMPL-X
vertices through the port's `recover_from_repr` on the body model's device;
open3d, pyrender and PIL are imported where an entry point needs them."""

from __future__ import annotations

import numpy as np
import torch

from rohm_tpu_torch.viz.skeleton import (
    COLOR_GT,
    COLOR_VIS,
    LIMBS_BODY_SMPL,
    vis_foot_contact,
    vis_skeleton,
)


def decode_vertices(rec: np.ndarray, body_model) -> np.ndarray:
    """One clip's saved repr [T, 294] -> SMPL-X vertices [T, V, 3] (numpy),
    decoded on the body model's device."""
    from rohm_tpu_torch.reprs import recover_from_repr, split_repr

    d = split_repr(torch.as_tensor(np.asarray(rec, np.float32), device=body_model.v_template.device))
    with torch.no_grad():
        _, verts = recover_from_repr(d, mode="smplx_params", body_model=body_model, return_verts=True)
    return verts.cpu().numpy()


def animate_skeletons(sequences: list, colors: list, contact=None, fps: int = 30,
                      spacing: float = 1.5) -> None:
    """Open3d side-by-side skeleton animation (reference test_trajnet.py:265-328
    / test_posenet.py:267-358). sequences: list of [T, 22, 3] arrays shown with
    x-offsets `spacing * i`; contact: optional [T, 4] labels for the last one."""
    import time

    import open3d as o3d

    vis = o3d.visualization.Visualizer()
    vis.create_window()
    t_len = min(len(s) for s in sequences)
    for t in range(t_len):
        vis.clear_geometries()
        for i, (seq, color) in enumerate(zip(sequences, colors)):
            off = np.array([spacing * i, 0.0, 0.0])
            for g in vis_skeleton(seq[t], LIMBS_BODY_SMPL, add_trans=off, color=color):
                vis.add_geometry(g)
            if contact is not None and i == len(sequences) - 1:
                for g in vis_foot_contact(seq[t], contact[t], add_trans=off):
                    vis.add_geometry(g)
        vis.poll_events()
        vis.update_renderer()
        time.sleep(1.0 / fps)
    vis.destroy_window()


def render_prox_overlay(saved_data: dict, body_model, recording_dir: str,
                        color_cam: dict, save_path: str,
                        render_interval: int = 100) -> None:
    """Overlay reconstructed bodies on the original PROX RGB frames
    (reference eval_prox_egobody.py:372-451): decode vertices, map back to
    scene coords, render in the camera, alpha-composite onto the frame."""
    import os

    from PIL import Image

    from rohm_tpu_torch.viz.render import (
        COLOR_BODY_REC_VIS,
        add_body_mesh,
        create_render_cam,
        create_scene,
        overlay_on_image,
        render_rgba,
    )

    assert body_model.faces is not None, "rendering needs a body model with faces"
    rec = saved_data["motion_repr_rec_list"]
    transf = saved_data["trans_scene2cano_list"]
    frame_names = saved_data.get("frame_name_list")
    camera, camera_pose, light = create_render_cam(
        color_cam["c"][0], color_cam["c"][1], color_cam["f"][0], color_cam["f"][1]
    )
    os.makedirs(save_path, exist_ok=True)
    for idx in range(0, len(rec), max(render_interval, 1)):
        verts = decode_vertices(rec[idx], body_model)  # [T, V, 3] canonical
        inv = np.linalg.inv(transf[idx])
        verts_scene = verts @ inv[:3, :3].T + inv[:3, 3]
        for t in range(0, verts.shape[0], 10):
            scene = create_scene(camera, camera_pose, light)
            add_body_mesh(scene, verts_scene[t], body_model.faces, COLOR_BODY_REC_VIS)
            rgba = render_rgba(scene, 1920, 1080)
            out = rgba
            if frame_names is not None:
                img_path = os.path.join(recording_dir, frame_names[idx][t] + ".jpg")
                if os.path.exists(img_path):
                    img = np.asarray(Image.open(img_path))
                    out = overlay_on_image(rgba, img)
            Image.fromarray(out[..., :3] if out.shape[-1] == 4 else out).save(
                os.path.join(save_path, f"clip{idx:04d}_frame{t:04d}.png")
            )


def occluded_vertex_alpha(body_model, mask_scheme: str, alpha_occ: float = 0.45):
    """Per-vertex alpha marking occluded body parts (reference
    eval_amass_full.py render path): a vertex is 'occluded' when its dominant
    LBS joint belongs to the mask scheme's joint set."""
    from rohm_tpu_torch.evals.metrics import LOWER_BODY, UPPER_BODY

    if mask_scheme not in ("lower", "upper"):
        return None
    occ = LOWER_BODY if mask_scheme == "lower" else UPPER_BODY
    owner = np.argmax(torch.as_tensor(body_model.lbs_weights).cpu().numpy(), axis=-1)  # [V]
    alpha = np.ones(len(owner))
    alpha[np.isin(owner, occ)] = alpha_occ
    return alpha


def render_amass_results(saved_data: dict, body_model, save_path: str,
                         render_interval: int = 100, width: int = 1280,
                         height: int = 720) -> None:
    """Offscreen pyrender of reconstructed bodies over a checkerboard floor
    (reference eval_amass_full.py:278-396): decode SMPL-X vertices from the
    saved reprs, render every render_interval-th clip frame-by-frame to PNGs.
    Occluded body parts render translucent via per-vertex alpha when the
    mask scheme is 'lower'/'upper'."""
    import os

    from PIL import Image

    from rohm_tpu_torch.viz.render import (
        COLOR_BODY_REC_VIS,
        add_body_mesh,
        checkerboard_floor,
        create_render_cam,
        create_scene,
        render_rgba,
    )

    assert body_model.faces is not None, "rendering needs a body model with faces"
    rec = saved_data["motion_repr_rec_list"]
    camera, camera_pose, light = create_render_cam(width / 2, height / 2, 1000.0, 1000.0)
    os.makedirs(save_path, exist_ok=True)
    cam_shift = np.eye(4)
    cam_shift[:3, 3] = [0.0, -3.0, 1.2]  # step back and up, z-up world
    vertex_alpha = occluded_vertex_alpha(body_model, saved_data.get("mask_scheme", ""))

    for idx in range(0, len(rec), max(render_interval, 1)):
        verts = decode_vertices(rec[idx], body_model)
        for t in range(0, verts.shape[0], 10):
            scene = create_scene(camera, camera_pose @ np.linalg.inv(cam_shift), light)
            scene.add(checkerboard_floor(np.eye(4)))
            add_body_mesh(scene, verts[t], body_model.faces, COLOR_BODY_REC_VIS,
                          vertex_alpha=vertex_alpha)
            rgba = render_rgba(scene, width, height)
            Image.fromarray(rgba).save(
                os.path.join(save_path, f"clip{idx:04d}_frame{t:04d}.png")
            )


def visualize_amass_results(saved_data: dict, render: bool = False,
                            vis_interval: int = 100, fps: int = 30,
                            body_model=None, render_save_path: str = "render_imgs") -> None:
    """Open3d animation of clean vs reconstructed skeletons (+ contact
    spheres), one clip every vis_interval; render=True switches to offscreen
    pyrender output (eval_amass_full.py:150-396)."""
    if render:
        assert body_model is not None, "render=True needs a body model"
        render_amass_results(saved_data, body_model, render_save_path, vis_interval)
        return
    import time

    import open3d as o3d

    clean = saved_data["rec_ric_data_clean_list"]
    rec = saved_data["rec_ric_data_rec_list_from_smpl"]
    contact = saved_data["motion_repr_rec_list"][:, :, -4:]
    for idx in range(0, len(clean), max(vis_interval, 1)):
        vis = o3d.visualization.Visualizer()
        vis.create_window()
        for t in range(clean.shape[1]):
            vis.clear_geometries()
            for g in vis_skeleton(clean[idx, t], LIMBS_BODY_SMPL, color=COLOR_GT):
                vis.add_geometry(g)
            for g in vis_skeleton(rec[idx, t], LIMBS_BODY_SMPL, add_trans=np.array([1.5, 0, 0]),
                                  color=COLOR_VIS):
                vis.add_geometry(g)
            for g in vis_foot_contact(rec[idx, t], contact[idx, t], add_trans=np.array([1.5, 0, 0])):
                vis.add_geometry(g)
            vis.poll_events()
            vis.update_renderer()
            time.sleep(1.0 / fps)
        vis.destroy_window()
