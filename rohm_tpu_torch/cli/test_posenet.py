"""test_posenet — PoseNet alone on the AMASS test split, with the ground-truth
trajectory in the condition, in PyTorch.

The port of rohm_tpu/cli/test_posenet.py: the same flags and YAML semantics
(reference test_posenet.py, mask schemes :142-172), the same printed MPJPE
and the same result pickle (name, keys, protocol 2). Run:

    python -m rohm_tpu_torch.cli.test_posenet --synthetic_data=True \\
        --model_path=<run dir>/model000100000.npz --fused_posenet=True --device=0

`--device` is a CUDA index (default 0) or `cpu`; an index with no CUDA
device raises. `--fused_posenet=True` runs every denoising step through the
f32 kernel chain that replaces K1 (`make_posenet_sampler(fused=True)`);
False runs the PoseNet module. `--cond_fn_with_grad` adds the skating
guidance through SMPL-X, `--early_stop` stops the chain 20 steps early.
`--visualize` animates the first clip of each batch with open3d
(`rohm_tpu_torch.viz`); `--via_server=True` relays the run to the resident
server (rohm_tpu_torch/serve).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from rohm_tpu_torch.cli.common import (
    AMASS_TEST_DATASETS,
    amass_stats_dir,
    build_posenet,
    load_eval_noise,
    load_or_init,
    maybe_via_server,
    resolve_body_model,
    resolve_device,
)
from rohm_tpu_torch.data import AmassClipDataset, write_synthetic_amass
from rohm_tpu_torch.diffusion.schedule import make_schedule
from rohm_tpu_torch.evals.metrics import mpjpe_global
from rohm_tpu_torch.models.guidance import amass_guidance
from rohm_tpu_torch.pipeline import amass_eval_pose_mask
from rohm_tpu_torch.reprs import recover_from_repr, split_repr
from rohm_tpu_torch.reprs.schema import REPR_DIM_DICT, REPR_LIST
from rohm_tpu_torch.train.steps import make_posenet_sampler
from rohm_tpu_torch.utils.config import ConfigParser

EARLY_STOP_STEPS = 20  # --early_stop: 980 of 1000 steps (reference _posenet.py:624-626)


def build_parser() -> ConfigParser:
    p = ConfigParser("RoHM PoseNet test (PyTorch)")
    p.add_argument("--device", type=str, default="0")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--diffusion_steps", type=int, default=1000)
    p.add_argument("--noise_schedule", type=str, default="cosine")
    p.add_argument("--timestep_respacing_eval", type=str, default="")
    p.add_argument("--sigma_small", type=bool, default=True)
    p.add_argument("--body_model_path", type=str, default="data/body_models/smplx_model")
    p.add_argument("--dataset_root", type=str, default="datasets/AMASS_smplx_preprocessed")
    p.add_argument("--clip_len", type=int, default=145)
    p.add_argument("--model_path", type=str, default="")
    p.add_argument("--input_noise", type=bool, default=True)
    p.add_argument("--noise_std_smplx_global_rot", type=float, default=3)
    p.add_argument("--noise_std_smplx_body_rot", type=float, default=2)
    p.add_argument("--noise_std_smplx_trans", type=float, default=0.01)
    p.add_argument("--noise_std_smplx_betas", type=float, default=0.2)
    p.add_argument("--load_noise", type=bool, default=False)
    p.add_argument("--load_noise_level", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--mask_scheme", type=str, default="lower")
    p.add_argument("--cond_fn_with_grad", type=bool, default=False)
    p.add_argument("--early_stop", type=bool, default=False)
    p.add_argument("--save_results", type=bool, default=False)
    p.add_argument("--save_root", type=str, default="test_results/results_posenet")
    p.add_argument("--visualize", type=bool, default=False)
    # extensions of the reference's CLI, as in the JAX package's
    p.add_argument("--synthetic_data", type=bool, default=False)
    p.add_argument("--latent_dim", type=int, default=512)
    p.add_argument("--max_batches", type=int, default=0)
    p.add_argument("--fused_posenet", type=bool, default=False)
    p.add_argument("--allow_missing_ckpt", type=bool, default=False)
    p.add_argument("--via_server", type=bool, default=False)
    return p


def result_filename(args) -> str:
    """The reference's pickle name (test_posenet.py)."""
    return f"test_posenet_mask_{args.mask_scheme}_grad_{args.cond_fn_with_grad}_seed_{args.seed}.pkl"


def main(argv=None) -> float:
    """The whole test run; prints and returns the global MPJPE (m)."""
    args = build_parser().parse_args(argv)
    handled, result = maybe_via_server("test_posenet", args, argv)
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
        split="test", task="pose", repr_abs_only=False, logdir=stats_dir,
        input_noise=args.input_noise,
        noise_std_smplx_global_rot=args.noise_std_smplx_global_rot,
        noise_std_smplx_body_rot=args.noise_std_smplx_body_rot,
        noise_std_smplx_trans=args.noise_std_smplx_trans,
        noise_std_smplx_betas=args.noise_std_smplx_betas,
        load_noise=args.load_noise, loaded_smplx_noise_dict=loaded_noise, **data_kw,
    )
    mean = torch.as_tensor(test_dataset.mean, device=device)
    std = torch.as_tensor(test_dataset.std, device=device)

    model = build_posenet(args, seed=args.seed)  # random init where no checkpoint is given
    model = load_or_init(model, args.model_path, allow_missing=args.allow_missing_ckpt,
                         name="posenet").to(device).eval()
    sched = make_schedule(args.noise_schedule, args.diffusion_steps, args.timestep_respacing_eval,
                          device=device)
    guidance = amass_guidance(mean, std, body) if args.cond_fn_with_grad else ()
    sampler = make_posenet_sampler(
        model, sched, guidance=guidance,
        early_stop_steps=EARLY_STOP_STEPS if args.early_stop else 0,
        fused=args.fused_posenet,
    )
    generator = torch.Generator(device=device).manual_seed(args.seed)

    def joints(repr_dn):
        return recover_from_repr(split_repr(repr_dn), mode="smplx_params", body_model=body)

    out = {k: [] for k in ("clean", "rec", "noisy", "repr_clean", "repr_rec")}
    for step, batch in enumerate(test_dataset.batches(args.batch_size, shuffle=False, drop_last=False)):
        if args.max_batches and step >= args.max_batches:
            break
        bs, clip_len = batch["motion_repr_noisy"].shape[:2]
        vis = amass_eval_pose_mask(args.mask_scheme, bs, clip_len, rng=rng)
        cond = torch.as_tensor(batch["motion_repr_noisy"] * vis, device=device)
        with torch.no_grad():  # the guidance takes its own gradients
            val_output = sampler(cond, generator)
            clean = torch.as_tensor(batch["motion_repr_clean"], device=device) * std + mean
            rec = val_output * std + mean
            decoded = {"clean": joints(clean), "rec": joints(rec), "repr_clean": clean, "repr_rec": rec}
            if args.input_noise:
                noisy = torch.as_tensor(batch["motion_repr_noisy"], device=device) * std + mean
                decoded["noisy"] = joints(noisy)
        for k, v in decoded.items():
            out[k].append(v.cpu().numpy())
        if args.visualize:
            from rohm_tpu_torch.viz import animate_skeletons
            from rohm_tpu_torch.viz.skeleton import COLOR_GT, COLOR_VIS

            animate_skeletons(
                [out["clean"][-1][0], out["rec"][-1][0]], [COLOR_GT, COLOR_VIS],
                contact=(out["repr_rec"][-1][0, :, -4:] > 0.5).astype(float),
            )

    clean, rec = np.concatenate(out["clean"]), np.concatenate(out["rec"])
    mpjpe = mpjpe_global(clean, rec)
    print("mpjpe_global (mm): {:0.1f}".format(mpjpe * 1000))

    if args.save_results:
        os.makedirs(args.save_root, exist_ok=True)
        save_data = {
            "mask_scheme": args.mask_scheme,
            "repr_name_list": REPR_LIST,
            "repr_dim_dict": REPR_DIM_DICT,
            "rec_ric_data_clean_list": clean,
            "rec_ric_data_rec_list_from_smpl": rec,
            "motion_repr_clean_list": np.concatenate(out["repr_clean"]),
            "motion_repr_rec_list": np.concatenate(out["repr_rec"]),
        }
        if out["noisy"]:
            save_data["rec_ric_data_noisy_list"] = np.concatenate(out["noisy"])
        pkl_path = os.path.join(args.save_root, result_filename(args))
        with open(pkl_path, "wb") as f:
            pickle.dump(save_data, f, protocol=2)
        print(f"results saved to {pkl_path}")
    return mpjpe


if __name__ == "__main__":
    main()
