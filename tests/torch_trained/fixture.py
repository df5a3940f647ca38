"""The trained fixture: JAX-trained tiny TrajNet, TrajControl and PoseNet,
their normalisation stats, the AMASS tree they were trained and evaluated
on, one evaluation batch and the JAX pipeline's metrics on it.

`build_fixture.py` (beside this file) makes every file here with the JAX
package on the CPU. This module reads them with numpy alone, so the port's
card runs (`chip_smoke.py`'s trained phase) use it as well as the tests.

Files:
  trajcontrol.npz, posenet.npz  flattened flax params, the `.npz` that
      both packages' `load_pretrained` read. TrajControl's file is also
      TrajNet's: its backbone is the trained TrajNet, frozen while the
      ControlNet branch trained, and both loaders skip the keys a model
      does not use
  AMASS_mean.pkl, AMASS_std.pkl  the stats, beside PoseNet's checkpoint
      where both CLIs look for them
  tree.npz  the test tree's sequences (joints [N, 83, 25, 3], params
      [N, 83, 178]): the test split trims one frame at each end, so each
      sequence is one 81-frame clip
  batch.npz  what both CLIs hand `run_batch` for the tree's one batch of
      N_CLIPS clips (--seed=0, --load_noise=False), per config
  meta.json  seeds, widths, steps, planted frames, contact margins and the
      JAX metrics of each config on the batch with `preset_noise(N_CLIPS)`
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

FIXTURE_DIR = Path(__file__).resolve().parent
ROOT = FIXTURE_DIR.parents[1]
CLIP_LEN = 81  # the shortest clip that holds the CLI's infill window at frame 65
N_CLIPS = 8
LATENT_DIM, MID_DIM = 64, 64  # PoseNet ff 1024, 8 layers, 4 heads (dh = 16)
STEPS_TRAJ, STEPS_POSE, SAMPLE_ITER = 100, 1000, 2
NOISE_SEED = 2026
# test datasets of the CLIs (AMASS_TEST_DATASETS) -> sequences each
DATASETS = {"TCDHands": 3, "TotalCapture": 3, "SFU": 2}
CONFIGS = {
    "flagship": "cfg_files/test_cfg/amass_occ_0.1_noise_3.yaml",
    "legs": "cfg_files/test_cfg/amass_occ_leg_noise_3.yaml",
}
CHECKPOINTS = {"trajnet": "trajcontrol.npz", "trajcontrol": "trajcontrol.npz", "posenet": "posenet.npz"}
# eval_amass_full's metrics of both configs
METRICS = ("mpjpe_global_mm", "mpjpe_global_vis_mm", "mpjpe_global_occ_mm", "contact_lbl_acc", "skating_gt_ratio",
           "skating_rec_ratio", "accel_error_ms2", "ground_pene_freq_pct", "ground_pene_dist_mm")
# the bounds the trained tests and chip_smoke.py's trained phase hold: the
# port's metrics against the JAX package's, rel or abs (the bound of
# tests/test_e2e_parity_trained.py's metric gate) ...
JAX_REL, JAX_ABS = 1e-2, 1e-6
# ... and a kernel mode's against the plain mode's (the JAX round's budgets,
# tests/test_e2e_parity_trained.py::test_fused_modes_metric_budget_trained)


def mode_budget(metric: str) -> float:
    return 2e-2 if metric.startswith("mpjpe") else 8e-2


# run_batch's array inputs, in its order
BATCH_INPUTS = ("traj_cond", "traj_clean", "pose_noisy", "pose_mask", "traj_mask")


def checkpoint(name: str) -> str:
    return str(FIXTURE_DIR / CHECKPOINTS[name])


def meta() -> dict:
    with open(FIXTURE_DIR / "meta.json") as f:
        return json.load(f)


def config(name: str) -> dict:
    """The test config's YAML as a dict."""
    import yaml

    with open(ROOT / CONFIGS[name]) as f:
        return yaml.safe_load(f)


def cli_argv(name: str, tree, save_root, n: int = N_CLIPS) -> list:
    """test_amass_full's flags (both packages) for the first batch of n
    clips of the fixture's tree, config `name`, on the fixture's weights;
    the port also takes --device and --fused_posenet. Without a noise file
    (data/eval_noise_smplx/) both CLIs draw the input noise from --seed,
    so --load_noise=False only says so."""
    return [
        f"--config={ROOT / CONFIGS[name]}", f"--dataset_root={tree}", f"--clip_len={CLIP_LEN}",
        f"--batch_size={n}", "--max_batches=1", f"--mid_dim={MID_DIM}", f"--latent_dim={LATENT_DIM}",
        "--load_noise=False", "--seed=0", f"--save_root={save_root}",
        f"--model_path_trajnet={checkpoint('trajnet')}",
        f"--model_path_trajnet_control={checkpoint('trajcontrol')}",
        f"--model_path_posenet={checkpoint('posenet')}",
    ]


def eval_argv(name: str, pkl) -> list:
    """eval_amass_full's flags for a pickle of config `name` (the window of
    the 'full' scheme's occluded MPJPE is the YAML's traj_mask_ratio)."""
    return [f"--saved_data_path={pkl}", f"--traj_mask_ratio={config(name)['traj_mask_ratio']}"]


def port_pipeline(name: str, fused_posenet=False, device="cpu"):
    """The port's RohmPipeline of config `name` on the fixture's weights and
    stats, built as test_amass_full builds it (the synthetic SMPL-X body of
    a host without body-model files)."""
    from types import SimpleNamespace

    import torch

    from rohm_tpu_torch.body.model import synthetic_model
    from rohm_tpu_torch.cli.common import build_posenet, build_trajnet, load_or_init
    from rohm_tpu_torch.diffusion.schedule import make_schedule
    from rohm_tpu_torch.pipeline import RohmPipeline
    from rohm_tpu_torch.reprs.stats import load_stats

    args = SimpleNamespace(mid_dim=MID_DIM, latent_dim=LATENT_DIM)
    models = {
        "trajnet": build_trajnet(args, 13, False), "trajcontrol": build_trajnet(args, 13, True),
        "posenet": build_posenet(args),
    }
    models = {k: load_or_init(m, checkpoint(k)).to(device).eval() for k, m in models.items()}
    mean, std = load_stats(str(FIXTURE_DIR))
    cfg = config(name)
    return RohmPipeline(
        **models, sched_traj=make_schedule("cosine", STEPS_TRAJ, device=device),
        sched_pose=make_schedule("cosine", STEPS_POSE, device=device), body_model=synthetic_model(device=device),
        mean=torch.as_tensor(mean, device=device), std=torch.as_tensor(std, device=device),
        repr_abs_only=cfg["repr_abs_only"], traj_feat_dim=13, sample_iter=cfg["sample_iter"],
        early_stop=cfg["early_stop"], grad_type="amass" if cfg["cond_fn_with_grad"] else None,
        mask_scheme=cfg["mask_scheme"], input_noise=cfg["input_noise"], infill_traj=cfg["infill_traj"],
        iter2_cond_noisy_pose=cfg["iter2_cond_noisy_pose"], iter2_cond_noisy_traj=cfg["iter2_cond_noisy_traj"],
        fused_posenet=fused_posenet)


def port_metrics(pipe, pose, b: dict, name: str) -> dict:
    """The port's eval_amass_full metrics of a port pipeline's output `pose`
    on fixture.batch's arrays `b`, decoded as test_amass_full decodes them."""
    import torch

    from rohm_tpu_torch.cli.eval_amass_full import evaluate
    from rohm_tpu_torch.cli.test_amass_full import make_pickle_decoders

    decode_rec, _ = make_pickle_decoders(pipe.body_model, CLIP_LEN - 2)
    clean = torch.as_tensor(b["pose_clean"], device=pose.device)
    out = decode_rec(pose, clean, pipe.mean, pipe.std)
    saved = dict(zip(("motion_repr_clean_list", "motion_repr_rec_list", "rec_ric_data_clean_list",
                      "rec_ric_data_rec_list_from_abs_traj", "rec_ric_data_rec_list_from_smpl"),
                     (a.cpu().numpy() for a in out)))
    cfg = config(name)
    return {k: float(v) for k, v in evaluate(saved, cfg["mask_scheme"], cfg["traj_mask_ratio"]).items()}


def write_tree(root, src=FIXTURE_DIR) -> None:
    """Write tree.npz's sequences as a preprocessed AMASS tree
    (pose_data_fps_30/ + smpl_data_fps_30/), DATASETS in order."""
    tree = np.load(Path(src) / "tree.npz")
    i = 0
    for dataset, n_seqs in DATASETS.items():
        for s in range(n_seqs):
            for sub, key in (("pose_data_fps_30", "joints"), ("smpl_data_fps_30", "params")):
                d = os.path.join(root, sub, dataset, f"seq{s:03d}")
                os.makedirs(d, exist_ok=True)
                np.save(os.path.join(d, "motion.npy"), tree[key][i])
            i += 1


def batch(config: str, n: int = N_CLIPS, src=FIXTURE_DIR) -> dict:
    """The first `n` clips of the batch of `config`: BATCH_INPUTS (the
    trajectory condition with the infill window applied), and pose_clean,
    the clean pose view that the pickle decodes (the traj view's clean
    repr: the two views share it)."""
    z = np.load(Path(src) / "batch.npz")
    out = {k: z[k][:n] for k in ("traj_clean", "pose_noisy")}
    out["pose_clean"] = out["traj_clean"]
    out["traj_mask"] = z[f"{config}_traj_mask"][:n]
    out["pose_mask"] = z[f"{config}_pose_mask"][:n]
    out["traj_cond"] = z["traj_cond"][:n] * out["traj_mask"][..., None]
    return out


def preset_noise(n: int) -> dict:
    """`run_batch(preset_noise=)` for n clips: each clip's draws come from its
    own generator (seeded [NOISE_SEED, clip]), so the first n clips of a
    larger batch get the same noise."""
    t = CLIP_LEN - 1
    per_clip = {  # key -> (shape without the batch dim, where the batch dim goes)
        "traj_init": ((SAMPLE_ITER, t, 13), 1),
        "traj_step": ((SAMPLE_ITER, STEPS_TRAJ, t, 13), 2),
        "pose_init": ((SAMPLE_ITER, t - 1, 294), 1),
        "pose_step": ((SAMPLE_ITER, STEPS_POSE, t - 1, 294), 2),
    }
    out = {k: np.empty(shape[:axis] + (n,) + shape[axis:], np.float32) for k, (shape, axis) in per_clip.items()}
    for i in range(n):
        rng = np.random.default_rng([NOISE_SEED, i])
        for k, (shape, axis) in per_clip.items():
            np.moveaxis(out[k], axis, 0)[i] = rng.standard_normal(shape, np.float32)
    return out


def metric_gaps(got: dict, want: dict, rel, abs_tol: float = 1e-6) -> list:
    """The metrics of `got` off `want` by more than rel (a number, or a
    function of the metric's name) of |want| and more than abs_tol; nan
    agrees with nan alone. Returns (name, got, want) triples."""
    bad = []
    for k, w in want.items():
        g = got[k]
        if np.isnan(w) or np.isnan(g):
            if not (np.isnan(w) and np.isnan(g)):
                bad.append((k, g, w))
            continue
        r = rel(k) if callable(rel) else rel
        if abs(g - w) > r * abs(w) and abs(g - w) > abs_tol:
            bad.append((k, g, w))
    return bad
