"""test_trajnet — TrajNet (or TrajControl) alone on the AMASS test split, with
root-trajectory diagnostics, in PyTorch.

The port of rohm_tpu/cli/test_trajnet.py: the same flags and YAML semantics
(reference test_trajnet.py, infill masking :139-149), the same 15 error and
jitter means and the same printed lines (:332-366). Run:

    python -m rohm_tpu_torch.cli.test_trajnet --synthetic_data=True \\
        --model_path=<run dir>/model000100000.npz --device=0

`--device` is a CUDA index (default 0) or `cpu`; an index with no CUDA
device raises. `--trajcontrol` builds the TrajControl net and passes it the
batch's control condition; `--infill_traj` zeroes a random window of the
trajectory condition. TrajNet has no kernel of `ops/`: the chain is plain
PyTorch.
`--visualize` animates the first clip of each batch with open3d
(`rohm_tpu_torch.viz`); `--via_server=True` relays the run to the resident
server (rohm_tpu_torch/serve).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rohm_tpu_torch.cli.common import (
    AMASS_TEST_DATASETS,
    amass_stats_dir,
    build_trajnet,
    load_eval_noise,
    load_or_init,
    maybe_via_server,
    resolve_body_model,
    resolve_device,
)
from rohm_tpu_torch.data import AmassClipDataset, write_synthetic_amass
from rohm_tpu_torch.diffusion.schedule import make_schedule
from rohm_tpu_torch.models.losses import merge_traj_output
from rohm_tpu_torch.reprs import recover_from_repr, scatter_traj_abs, split_repr
from rohm_tpu_torch.train.masking import traj_infill_mask
from rohm_tpu_torch.train.steps import make_trajnet_sampler
from rohm_tpu_torch.utils.config import ConfigParser

FPS = 30
ERROR_KEYS = (
    "root_rot", "x_abs", "y_abs", "z_abs", "x_rel", "y_rel", "z_rel",
    "x_smpl", "y_smpl", "z_smpl", "jitter_clean", "jitter_noisy",
    "jitter_abs", "jitter_rel", "jitter_smpl",
)


def build_parser() -> ConfigParser:
    p = ConfigParser("RoHM TrajNet test (PyTorch)")
    p.add_argument("--device", type=str, default="0")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--diffusion_steps", type=int, default=100)
    p.add_argument("--noise_schedule", type=str, default="cosine")
    p.add_argument("--timestep_respacing_eval", type=str, default="")
    p.add_argument("--sigma_small", type=bool, default=True)
    p.add_argument("--body_model_path", type=str, default="data/body_models/smplx_model")
    p.add_argument("--dataset_root", type=str, default="datasets/AMASS_smplx_preprocessed")
    p.add_argument("--clip_len", type=int, default=145)
    p.add_argument("--repr_abs_only", type=bool, default=True)
    p.add_argument("--trajcontrol", type=bool, default=False)
    p.add_argument("--model_path", type=str, default="")
    p.add_argument("--input_noise", type=bool, default=True)
    p.add_argument("--noise_std_smplx_global_rot", type=float, default=1)
    p.add_argument("--noise_std_smplx_body_rot", type=float, default=1)
    p.add_argument("--noise_std_smplx_trans", type=float, default=0.01)
    p.add_argument("--noise_std_smplx_betas", type=float, default=0.1)
    p.add_argument("--load_noise", type=bool, default=False)
    p.add_argument("--load_noise_level", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--infill_traj", type=bool, default=False)
    p.add_argument("--max_infill_ratio", type=float, default=0.1)
    p.add_argument("--visualize", type=bool, default=False)
    # extensions of the reference's CLI, as in the JAX package's
    p.add_argument("--synthetic_data", type=bool, default=False)
    p.add_argument("--mid_dim", type=int, default=512)
    p.add_argument("--max_batches", type=int, default=0)
    p.add_argument("--allow_missing_ckpt", type=bool, default=False)
    p.add_argument("--via_server", type=bool, default=False)
    return p


def _jitter(p: np.ndarray) -> np.ndarray:
    """Third finite difference of a [B, T, 3] path, in m/s^3."""
    return np.linalg.norm((p[:, 3:] - 3 * p[:, 2:-1] + 3 * p[:, 1:-2] - p[:, :-3]) * FPS**3, axis=-1)


def main(argv=None) -> dict:
    """The whole test run; prints the errors and returns their means by name
    (ERROR_KEYS; radians, meters, m/s^3)."""
    args = build_parser().parse_args(argv)
    handled, result = maybe_via_server("test_trajnet", args, argv)
    if handled:
        return result
    device = resolve_device(args.device)
    # full f32 products and convolutions, as the pipeline runs them (cuDNN
    # takes f32 convolutions in TF32 by default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    body = resolve_body_model(args.body_model_path, device)

    if args.synthetic_data and not os.path.isdir(os.path.join(args.dataset_root, "pose_data_fps_30")):
        write_synthetic_amass(
            args.dataset_root, body,
            datasets={name: 1 for name in AMASS_TEST_DATASETS},
            seq_len=args.clip_len + 4,
        )

    loaded_noise = load_eval_noise(args)
    data_kw = dict(
        body_model=body, preprocessed_amass_root=args.dataset_root,
        amass_datasets=AMASS_TEST_DATASETS, clip_len=args.clip_len, seed=args.seed,
        disk_cache_dir=os.path.join(args.dataset_root, "_repr_cache"), device=device,
    )
    stats_dir = amass_stats_dir(args.model_path, data_kw)
    test_dataset = AmassClipDataset(
        split="test", task="traj", repr_abs_only=args.repr_abs_only, logdir=stats_dir,
        input_noise=args.input_noise,
        noise_std_smplx_global_rot=args.noise_std_smplx_global_rot,
        noise_std_smplx_body_rot=args.noise_std_smplx_body_rot,
        noise_std_smplx_trans=args.noise_std_smplx_trans,
        noise_std_smplx_betas=args.noise_std_smplx_betas,
        load_noise=args.load_noise, loaded_smplx_noise_dict=loaded_noise, **data_kw,
    )
    mean = torch.as_tensor(test_dataset.mean, device=device)
    std = torch.as_tensor(test_dataset.std, device=device)
    traj_feat_dim = test_dataset.traj_feat_dim

    model = build_trajnet(args, traj_feat_dim, args.trajcontrol, seed=args.seed)
    model = load_or_init(model, args.model_path, allow_missing=args.allow_missing_ckpt,
                         name="trajnet").to(device).eval()
    sched = make_schedule(args.noise_schedule, args.diffusion_steps, args.timestep_respacing_eval,
                          device=device)
    sampler = make_trajnet_sampler(model, sched, traj_feat_dim)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    def decode(repr_dn, mode):
        return recover_from_repr(split_repr(repr_dn), mode=mode, body_model=body)

    errs = {k: [] for k in ERROR_KEYS}
    for step, batch in enumerate(test_dataset.batches(args.batch_size, shuffle=False, drop_last=False)):
        if args.max_batches and step >= args.max_batches:
            break
        cond = batch["cond"].copy()
        bs, clip_len = cond.shape[:2]
        if args.infill_traj:
            cond = cond * traj_infill_mask(rng, bs, clip_len, args.max_infill_ratio)[..., None]
        cc = batch.get("control_cond") if args.trajcontrol else None
        with torch.no_grad():
            val_output = sampler(torch.as_tensor(cond, device=device), generator,
                                 None if cc is None else torch.as_tensor(cc, device=device))
            clean_n = torch.as_tensor(batch["motion_repr_clean"], device=device)
            cond_full = torch.as_tensor(batch["cond"], device=device)
            rec_n = merge_traj_output(clean_n, val_output, args.repr_abs_only)
            if args.repr_abs_only:
                noisy_n = scatter_traj_abs(clean_n, cond_full)
            else:
                noisy_n = torch.cat([cond_full, clean_n[..., traj_feat_dim:]], dim=-1)
            clean, rec, noisy = (x * std + mean for x in (clean_n, rec_n, noisy_n))
            joints = {tag: decode(x, mode) for tag, x, mode in (
                ("clean", clean, "smplx_params"), ("noisy", noisy, "smplx_params"),
                ("abs", rec, "joint_abs_traj"), ("rel", rec, "joint_rel_traj"),
                ("smpl", rec, "smplx_params"))}
        roots = {tag: j[:, :, 0].cpu().numpy() for tag, j in joints.items()}
        clean_np, rec_np = clean.cpu().numpy(), rec.cpu().numpy()

        errs["root_rot"].append(np.abs(rec_np[..., 0] * 2 - clean_np[..., 0] * 2))
        for tag in ("abs", "rel", "smpl"):
            d = np.abs(roots[tag] - roots["clean"])
            errs[f"x_{tag}"].append(d[..., 0])
            errs[f"y_{tag}"].append(d[..., 1])
            errs[f"z_{tag}"].append(d[..., 2])
            errs[f"jitter_{tag}"].append(_jitter(roots[tag]))
        errs["jitter_clean"].append(_jitter(roots["clean"]))
        errs["jitter_noisy"].append(_jitter(roots["noisy"]))

        if args.visualize:
            from rohm_tpu_torch.viz import animate_skeletons
            from rohm_tpu_torch.viz.skeleton import COLOR_GT, COLOR_OCC, COLOR_VIS

            # [red GT] [yellow noisy] [blue rec] (reference test_trajnet.py:265-328)
            animate_skeletons(
                [joints[tag][0].cpu().numpy() for tag in ("clean", "noisy", "smpl")],
                [COLOR_GT, COLOR_OCC, COLOR_VIS],
            )

    results = {k: float(np.concatenate(v).mean()) for k, v in errs.items() if v}
    print("root_rot_err_rec (deg): {:0.3f}".format(np.rad2deg(results["root_rot"])))
    for tag in ("abs", "rel", "smpl"):
        print("root x/y/z err from {} (mm): {:0.1f} / {:0.1f} / {:0.1f}".format(
            tag, results[f"x_{tag}"] * 1000, results[f"y_{tag}"] * 1000, results[f"z_{tag}"] * 1000))
        print("root jitter from {} (m/s^3): {:0.1f}".format(tag, results[f"jitter_{tag}"]))
    print("root jitter clean/noisy (m/s^3): {:0.1f} / {:0.1f}".format(
        results["jitter_clean"], results["jitter_noisy"]))
    return results


if __name__ == "__main__":
    main()
