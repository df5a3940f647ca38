"""eval_amass_full — metrics over a saved test_amass_full result pickle.

The port of rohm_tpu/cli/eval_amass_full.py: the same metric names and
printf formats (reference eval_amass_full.py:18-147). Run:

    python -m rohm_tpu_torch.cli.eval_amass_full --saved_data_path=<pkl>

`--visualize` animates clean and reconstructed skeletons with open3d;
`--render` writes offscreen pyrender frames of the decoded SMPL-X bodies
(`rohm_tpu_torch.viz`; each raises ImportError where its library is
absent). `--via_server=True` relays the run to the resident server
(rohm_tpu_torch/serve).
"""

from __future__ import annotations

import pickle

import numpy as np

from rohm_tpu_torch.evals.metrics import (
    accel_error,
    contact_label_accuracy,
    ground_penetration,
    mpjpe_global,
    mpjpe_masked,
    skating_ratio,
)
from rohm_tpu_torch.utils.config import ConfigParser


def build_parser() -> ConfigParser:
    p = ConfigParser("RoHM AMASS evaluation (PyTorch)")
    p.add_argument("--saved_data_path", type=str,
                   default="data/test_results_release/results_amass_full/test_amass_full.pkl")
    p.add_argument("--mask_scheme", type=str, default="lower")
    p.add_argument("--traj_mask_ratio", type=float, default=0.0)
    p.add_argument("--visualize", type=bool, default=False)
    p.add_argument("--render", type=bool, default=False)
    p.add_argument("--body_model_path", type=str, default="data/body_models/smplx_model")
    p.add_argument("--via_server", type=bool, default=False)
    return p


def evaluate(saved_data: dict, mask_scheme: str, traj_mask_ratio: float = 0.0) -> dict:
    """Compute the full AMASS metric dict from a result pickle."""
    clean = saved_data["rec_ric_data_clean_list"]
    rec = saved_data["rec_ric_data_rec_list_from_smpl"]
    repr_clean = saved_data["motion_repr_clean_list"]
    repr_rec = saved_data["motion_repr_rec_list"]

    m = {}
    m["mpjpe_global_mm"] = mpjpe_global(clean, rec) * 1000
    if mask_scheme in ("lower", "upper", "full"):
        vis, occ = mpjpe_masked(clean, rec, mask_scheme, traj_mask_ratio)
        m["mpjpe_global_vis_mm"], m["mpjpe_global_occ_mm"] = vis * 1000, occ * 1000
    m["contact_lbl_acc"] = contact_label_accuracy(repr_clean, repr_rec)
    m["skating_gt_ratio"] = skating_ratio(clean)
    m["skating_rec_ratio"] = skating_ratio(rec, joints_for_floor=clean)
    m["accel_error_ms2"] = accel_error(clean, rec)
    freq, dist = ground_penetration(rec, floor_joints=clean)
    m["ground_pene_freq_pct"] = freq * 100
    m["ground_pene_dist_mm"] = dist * 1000
    return m


def main(argv=None):
    args = build_parser().parse_args(argv)
    from rohm_tpu_torch.cli.common import maybe_via_server

    handled, result = maybe_via_server("eval_amass_full", args, argv)
    if handled:
        return result
    with open(args.saved_data_path, "rb") as f:
        saved_data = pickle.load(f)
    print(args.saved_data_path)
    mask_scheme = saved_data.get("mask_scheme", args.mask_scheme)

    m = evaluate(saved_data, mask_scheme, args.traj_mask_ratio)
    print("mpjpe_global (mm): {:0.1f}".format(m["mpjpe_global_mm"]))
    if "mpjpe_global_vis_mm" in m:
        print("mpjpe_global_vis / occ (mm): {:0.1f} / {:0.1f}".format(
            m["mpjpe_global_vis_mm"], m["mpjpe_global_occ_mm"]))
    print("contact_lbl_acc: {:0.2f}".format(m["contact_lbl_acc"]))
    print("skating_gt_ratio: {:0.3f}".format(m["skating_gt_ratio"]))
    print("skating_rec_ratio: {:0.3f}".format(m["skating_rec_ratio"]))
    print("accel_error (m/s^2): {:0.1f}".format(m["accel_error_ms2"]))
    print("ground_pene_freq score (%): {:0.2f}".format(m["ground_pene_freq_pct"]))
    print("ground_pene_dist score (mm): {:0.2f}".format(m["ground_pene_dist_mm"]))

    if args.visualize or args.render:
        from rohm_tpu_torch.cli.common import resolve_body_model
        from rohm_tpu_torch.viz import visualize_amass_results

        # the decode for --render runs on the CPU: the renderer reads host arrays
        body = resolve_body_model(args.body_model_path, "cpu") if args.render else None
        visualize_amass_results(saved_data, render=args.render, body_model=body)
    return m


if __name__ == "__main__":
    main()
