"""eval_prox_egobody — metrics over saved test_prox_egobody result pickles.

The port of rohm_tpu/cli/eval_prox_egobody.py: the same recording lists,
metric names and printf formats (reference eval_prox_egobody.py). Results
are mapped back to scene coords through the inverse canonicalization
transform; skating is axis-aware (z-up PROX, y-up EgoBody); ||acc||
(PROX) or the accel error (EgoBody); G-MPJPE/MPJPE/vis/occ against
EgoBody's GT; ground penetration against the per-scene floor heights.
Run:

    python -m rohm_tpu_torch.cli.eval_prox_egobody --dataset=prox \\
        --saved_data_dir=<dir of the pickles> [--recording_list=a,b] [--stitch_save_dir=<dir>]

`--visualize` animates the input and reconstructed skeletons in scene
coords with open3d; `--render` overlays the decoded bodies on the
recording's RGB frames with pyrender (`rohm_tpu_torch.viz`; each raises
ImportError where its library is absent). `--via_server=True` relays the
run to the resident server (rohm_tpu_torch/serve).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from rohm_tpu_torch.data.video import EGOBODY_FLOOR_HEIGHT, PROX_FLOOR_HEIGHT
from rohm_tpu_torch.evals.metrics import (
    accel_error,
    accel_magnitude,
    egobody_mpjpe_set,
    ground_penetration_fixed_floor,
    skating_ratio_fixed_floor,
)
from rohm_tpu_torch.evals.stitch import stitch_windows
from rohm_tpu_torch.utils.config import ConfigParser

# test-split recordings (reference eval_prox_egobody.py:56-69)
PROX_TEST_RECORDINGS = [
    "MPH1Library_00034_01", "N0Sofa_00034_01", "N0Sofa_00034_02", "N0Sofa_00141_01",
    "N0Sofa_00145_01", "N3Library_00157_01", "N3Library_00157_02", "N3Library_03301_01",
    "N3Library_03301_02", "N3Library_03375_01", "N3Library_03375_02", "N3Library_03403_01",
    "N3Library_03403_02", "N3Office_00034_01", "N3Office_00139_01", "N3Office_00150_01",
    "N3Office_00153_01", "N3Office_00159_01", "N3Office_03301_01",
]
EGOBODY_TEST_RECORDINGS = [
    "recording_20210907_S02_S01_01", "recording_20210907_S03_S04_01",
    "recording_20210929_S05_S16_01", "recording_20210929_S05_S16_04",
    "recording_20211004_S19_S06_01", "recording_20211004_S19_S06_02",
    "recording_20211004_S19_S06_03", "recording_20211004_S12_S20_01",
    "recording_20211004_S12_S20_02", "recording_20211004_S12_S20_03",
    "recording_20220315_S21_S30_03", "recording_20220315_S21_S30_05",
    "recording_20220318_S32_S31_01", "recording_20220318_S32_S31_02",
    "recording_20220318_S34_S33_01", "recording_20220318_S33_S34_01",
    "recording_20220318_S33_S34_02", "recording_20220415_S36_S35_02",
    "recording_20220415_S35_S36_02",
]


def build_parser() -> ConfigParser:
    p = ConfigParser("RoHM PROX/EgoBody evaluation (PyTorch)")
    p.add_argument("--device", type=str, default="0")
    p.add_argument("--body_model_path", type=str, default="data/body_models/smplx_model")
    p.add_argument("--dataset", type=str, default="egobody")
    p.add_argument("--dataset_root", type=str, default="")
    p.add_argument("--saved_data_dir", type=str, default="")
    p.add_argument("--recording_name", type=str, default="all")
    p.add_argument("--visualize", type=bool, default=False)
    p.add_argument("--vis_option", type=str, default="mesh")
    p.add_argument("--vis_interval", type=int, default=1)
    p.add_argument("--render", type=bool, default=False)
    p.add_argument("--render_interval", type=int, default=100)
    p.add_argument("--render_save_path", type=str, default="render_imgs")
    # extension: recording list override for synthetic-data runs
    p.add_argument("--recording_list", type=str, default="")
    # extension: export each recording's windows stitched into one
    # continuous scene-coord sequence (crossfaded overlap) as npz
    p.add_argument("--stitch_save_dir", type=str, default="")
    p.add_argument("--via_server", type=bool, default=False)
    return p


def _to_scene(joints_cano: np.ndarray, transf: np.ndarray) -> np.ndarray:
    """Map [n, T, 22, 3] canonical joints back to scene coords via the inverse
    per-clip transform (eval_prox_egobody.py:178-182)."""
    out = np.empty_like(joints_cano)
    for i in range(len(joints_cano)):
        inv = np.linalg.inv(transf[i])
        out[i] = joints_cano[i] @ inv[:3, :3].T + inv[:3, 3]
    return out


def evaluate_recording(saved_data: dict, dataset: str) -> dict:
    """Per-recording raw metric arrays (before the pooling over recordings)."""
    rec_scene = _to_scene(saved_data["rec_ric_data_rec_list_from_smpl"], saved_data["trans_scene2cano_list"])
    recording_name = saved_data["recording_name"]
    if dataset == "prox":
        ground = PROX_FLOOR_HEIGHT[recording_name.split("_")[0]]
        up = 2
    else:
        # per-scene preset floor height, via the scene_name stored in the
        # result pickle (reference eval_prox_egobody.py:256-264); pickles
        # without it fall back to the GT joints' minimum
        up = 1
        scene = saved_data.get("scene_name", "")
        ground = EGOBODY_FLOOR_HEIGHT.get(scene)
        if ground is None and scene:
            print(f"[WARN] no preset floor height for scene '{scene}'")

    out = {}
    clip_len = rec_scene.shape[1]
    # n_clips weights the pooling: the reference pools per-clip arrays over
    # ALL recordings before one mean (eval_prox_egobody.py:453-490)
    out["n_clips"] = int(len(rec_scene))
    if dataset == "egobody":
        gt_scene = saved_data["joints_gt_scene_coord_list"][:, :clip_len]
        if ground is None:
            ground = float(gt_scene[..., up].min())
        mask = saved_data["mask_joint_vis_list"][:, :clip_len]
        out["mpjpe_set"] = egobody_mpjpe_set(gt_scene, rec_scene, mask)
        # vis/occ pooled weights: the reference's final vis/occ numbers are
        # global sum(l*mask)/sum(mask) over all recordings (:486-490)
        out["vis_sum"] = float(mask.sum())
        out["occ_sum"] = float((1 - mask).sum())
        out["acc_error"] = accel_error(gt_scene, rec_scene)
    out["acc_mag"] = accel_magnitude(rec_scene)
    out["skating"] = skating_ratio_fixed_floor(rec_scene, ground, up)
    out["pene_freq"], out["pene_dist"] = ground_penetration_fixed_floor(rec_scene, ground, up)
    return out


def stitch_recording(saved_data: dict, stitch_save_dir: str) -> str:
    """Crossfade the recording's overlapping windows into one continuous
    scene-coordinate sequence and save <stitch_save_dir>/<recording>.npz
    with 'joints_rec' / 'joints_input' [T_total, 22, 3]."""
    rec_scene = _to_scene(saved_data["rec_ric_data_rec_list_from_smpl"], saved_data["trans_scene2cano_list"])
    inp_scene = saved_data["joints_input_scene_coord_list"]
    length = rec_scene.shape[1]
    # input-frame stride between windows, recorded by test_prox_egobody
    # (clip_len - window_size); pickles without it fall back to no overlap
    stride = min(int(saved_data.get("window_stride", length)), length)
    out_path = os.path.join(stitch_save_dir, f"{saved_data['recording_name']}.npz")
    os.makedirs(stitch_save_dir, exist_ok=True)
    np.savez(
        out_path,
        joints_rec=stitch_windows(rec_scene, stride),
        joints_input=stitch_windows(inp_scene[:, :length], stride),
    )
    print(f"[eval_prox_egobody] stitched sequence -> {out_path}")
    return out_path


def visualize_recording(saved_data: dict, args) -> None:
    """Open3d skeleton animation of input vs reconstruction in scene coords,
    one clip every vis_interval (reference eval_prox_egobody.py:312-370)."""
    from rohm_tpu_torch.viz.results import animate_skeletons
    from rohm_tpu_torch.viz.skeleton import COLOR_GT, COLOR_VIS

    rec_scene = _to_scene(
        saved_data["rec_ric_data_rec_list_from_smpl"],
        saved_data["trans_scene2cano_list"],
    )
    inp = saved_data["joints_input_scene_coord_list"]
    contact = saved_data["motion_repr_rec_list"][..., -4:]
    for idx in range(0, len(rec_scene), max(args.vis_interval, 1)):
        t_len = rec_scene.shape[1]
        animate_skeletons(
            [inp[idx][:t_len], rec_scene[idx]],
            [COLOR_GT, COLOR_VIS],
            contact=contact[idx],
        )


def render_recording(saved_data: dict, args, body_model) -> None:
    """Overlay reconstructions on the recording's RGB frames (reference
    eval_prox_egobody.py:372-451); intrinsics come from the result pickle."""
    from rohm_tpu_torch.viz.results import render_prox_overlay

    color_cam = saved_data.get("color_cam") or {
        "f": [1000.0, 1000.0], "c": [960.0, 540.0]
    }
    recording_dir = os.path.join(
        args.dataset_root, "recordings", saved_data["recording_name"], "Color"
    )
    render_prox_overlay(
        saved_data, body_model, recording_dir, color_cam,
        os.path.join(args.render_save_path, saved_data["recording_name"]),
        render_interval=args.render_interval,
    )


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from rohm_tpu_torch.cli.common import maybe_via_server

    handled, result = maybe_via_server("eval_prox_egobody", args, argv)
    if handled:
        return result
    if args.recording_list:
        recordings = [r for r in args.recording_list.split(",") if r]
    elif args.recording_name != "all":
        recordings = [args.recording_name]
    else:
        recordings = PROX_TEST_RECORDINGS if args.dataset == "prox" else EGOBODY_TEST_RECORDINGS

    body_model = None
    if args.render:
        from rohm_tpu_torch.cli.common import resolve_body_model, resolve_device

        body_model = resolve_body_model(args.body_model_path, resolve_device(args.device))

    per_rec = []
    for name in recordings:
        path = os.path.join(args.saved_data_dir, f"{name}.pkl")
        if not os.path.exists(path):
            print(f"[WARN] missing result pickle {path}, skipping")
            continue
        with open(path, "rb") as f:
            saved = pickle.load(f)
        per_rec.append(evaluate_recording(saved, args.dataset))
        if args.stitch_save_dir:
            stitch_recording(saved, args.stitch_save_dir)
        if args.visualize:
            visualize_recording(saved, args)
        if args.render:
            render_recording(saved, args, body_model)

    assert per_rec, "no result pickles found"
    # clip-count-weighted pooling == the reference's concatenate-then-mean
    # over all recordings (eval_prox_egobody.py:453-490)
    w = np.array([m["n_clips"] for m in per_rec], np.float64)

    def pooled(get):
        return float(np.sum([get(m) * m["n_clips"] for m in per_rec]) / w.sum())

    agg = {}
    print("\n --------------- evaluation metrics -------------")
    agg["skating"] = pooled(lambda m: m["skating"])
    print("skating score: {:0.3f}".format(agg["skating"]))
    if args.dataset == "prox":
        agg["acc_mag"] = pooled(lambda m: m["acc_mag"])
        print("||acc|| (m/s^2): {:0.2f}".format(agg["acc_mag"]))
    else:
        agg["acc_error"] = pooled(lambda m: m["acc_error"])
        print("acc errors (m/s^2): {:0.2f}".format(agg["acc_error"]))
    agg["pene_freq"] = pooled(lambda m: m["pene_freq"])
    agg["pene_dist"] = pooled(lambda m: m["pene_dist"])
    print("ground_pene_freq score (%): {:0.2f}".format(agg["pene_freq"] * 100))
    print("ground_pene_dist score (mm): {:0.2f}".format(-agg["pene_dist"] * 1000))
    if args.dataset == "egobody":
        for k in ("gmpjpe", "mpjpe"):
            agg[k] = pooled(lambda m, k=k: m["mpjpe_set"][k])
        # vis/occ: global weighted sums (reference :486-490)
        vis_w = sum(m["vis_sum"] for m in per_rec)
        occ_w = sum(m["occ_sum"] for m in per_rec)
        agg["mpjpe_vis"] = float(
            sum(m["mpjpe_set"]["mpjpe_vis"] * m["vis_sum"] for m in per_rec) / max(vis_w, 1.0)
        )
        agg["mpjpe_occ"] = float(
            sum(m["mpjpe_set"]["mpjpe_occ"] * m["occ_sum"] for m in per_rec) / max(occ_w, 1.0)
        )
        print("-------------- gmpjpe/mpjpe/mpjpe-vis/mpjpe-occ (mm) --------------")
        print("{:0.2f} / {:0.2f} / {:0.2f} / {:0.2f}".format(
            agg["gmpjpe"] * 1000, agg["mpjpe"] * 1000,
            agg["mpjpe_vis"] * 1000, agg["mpjpe_occ"] * 1000))
    return agg


if __name__ == "__main__":
    main()
