"""test_amass_full — the full RoHM pipeline on AMASS (TrajNet + TrajControl +
PoseNet, iterative, guided), in PyTorch.

The port of rohm_tpu/cli/test_amass_full.py: the same flags and YAML
semantics (reference test_amass_full.py:20-73), the same mask drawing and
the same result pickle (keys, config-encoded filename, protocol 5). Run:

    python -m rohm_tpu_torch.cli.test_amass_full --config cfg_files/test_cfg/amass_occ_leg_noise_3.yaml \\
        --synthetic_data=True --fused_posenet=int8 --device=0

`--device` is a CUDA index (default 0) or `cpu`; an index with no CUDA
device raises. `--fused_posenet` False/True/bf16/int8/int8qa/f32 picks the
PoseNet path (False: the plain module; the rest: hand-written kernels).

`--data_parallel=True` splits every batch over one process per card
(cli/common.py::run_data_parallel: alone it uses every visible card; under
torchrun each rank joins the launcher's group): each rank runs its rows
through the pipeline, the tail batch pads to a multiple of the ranks, and
rank 0 writes the same pickle as a single-process run. With one card (or
--device=cpu) it runs as a mesh of one rank.

`--via_server=True` relays the run to the resident server
(rohm_tpu_torch/serve), which keeps the models, the pipeline with its
kernels' prepared weights and the pickle decoders between runs of one
configuration (`_WARM`); outside --data_parallel a direct call in one
process keeps them the same way.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

from rohm_tpu_torch.cli.common import (
    AMASS_TEST_DATASETS,
    PhaseTimer,
    build_posenet,
    build_trajnet,
    amass_stats_dir,
    keep_in_flight,
    load_eval_noise,
    load_or_init,
    maybe_via_server,
    rank_zero_first,
    resolve_body_model,
    resolve_device,
    run_data_parallel,
)
from rohm_tpu_torch.data import AmassClipDataset, write_synthetic_amass
from rohm_tpu_torch.diffusion.schedule import make_schedule
from rohm_tpu_torch.pipeline import RohmPipeline, amass_eval_pose_mask
from rohm_tpu_torch.reprs import recover_from_repr, split_repr
from rohm_tpu_torch.reprs.schema import REPR_DIM_DICT, REPR_LIST, TRAJ_FEAT_DIM_FULL
from rohm_tpu_torch.utils.config import ConfigParser, fused_mode


def build_parser() -> ConfigParser:
    p = ConfigParser("RoHM full AMASS test (PyTorch)")
    p.add_argument("--device", type=str, default="0")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--diffusion_steps_posenet", type=int, default=1000)
    p.add_argument("--diffusion_steps_trajnet", type=int, default=100)
    p.add_argument("--noise_schedule", type=str, default="cosine")
    p.add_argument("--timestep_respacing_eval", type=str, default="")
    p.add_argument("--sigma_small", type=bool, default=True)
    p.add_argument("--body_model_path", type=str, default="data/body_models/smplx_model")
    p.add_argument("--dataset_root", type=str, default="datasets/AMASS_smplx_preprocessed")
    p.add_argument("--clip_len", type=int, default=145)
    p.add_argument("--repr_abs_only", type=bool, default=True)
    p.add_argument("--model_path_trajnet", type=str, default="")
    p.add_argument("--model_path_trajnet_control", type=str, default="")
    p.add_argument("--model_path_posenet", type=str, default="")
    p.add_argument("--input_noise", type=bool, default=True)
    p.add_argument("--noise_std_smplx_global_rot", type=float, default=3)
    p.add_argument("--noise_std_smplx_body_rot", type=float, default=3)
    p.add_argument("--noise_std_smplx_trans", type=float, default=0.03)
    p.add_argument("--noise_std_smplx_betas", type=float, default=0.1)
    p.add_argument("--load_noise", type=bool, default=True)
    p.add_argument("--load_noise_level", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--cond_fn_with_grad", type=bool, default=True)
    p.add_argument("--infill_traj", type=bool, default=False)
    p.add_argument("--traj_mask_ratio", type=float, default=0.1)
    p.add_argument("--mask_scheme", type=str, default="full")
    p.add_argument("--save_root", type=str, default="test_results/results_amass_full")
    p.add_argument("--sample_iter", type=int, default=2)
    p.add_argument("--iter2_cond_noisy_traj", type=bool, default=True)
    p.add_argument("--iter2_cond_noisy_pose", type=bool, default=True)
    p.add_argument("--early_stop", type=bool, default=False)
    # extensions of the JAX package's CLI
    p.add_argument("--synthetic_data", type=bool, default=False)
    p.add_argument("--mid_dim", type=int, default=512)
    p.add_argument("--latent_dim", type=int, default=512)
    p.add_argument("--max_batches", type=int, default=0)
    p.add_argument("--fused_posenet", type=fused_mode, default=False)
    p.add_argument("--data_parallel", type=bool, default=False)
    p.add_argument("--allow_missing_ckpt", type=bool, default=False)
    p.add_argument("--via_server", type=bool, default=False)
    return p


# The resident warm path: models + pipeline + pickle decoders survive
# between runs in one process, keyed by every config field that affects
# them (checkpoint and stats mtimes included, so retraining invalidates).
_WARM: dict = {}


def _warm_key(args, stats_dir: str, body) -> tuple:
    def _mtime(p):
        return os.path.getmtime(p) if p and os.path.exists(p) else None

    cfg = {
        k: v for k, v in sorted(vars(args).items())
        if k not in ("save_root", "max_batches", "via_server")
    }
    return (
        tuple(cfg.items()), stats_dir,
        _mtime(args.model_path_trajnet), _mtime(args.model_path_trajnet_control),
        _mtime(args.model_path_posenet), getattr(body, "fingerprint", None),
        # stats travel with the checkpoint but can be regenerated beside an
        # unchanged model file; a warm pipeline with stale mean/std would
        # silently disagree with the freshly built dataset's stats
        _mtime(os.path.join(stats_dir, "AMASS_mean.pkl")),
        _mtime(os.path.join(stats_dir, "AMASS_std.pkl")),
    )


def make_pickle_decoders(body, t_out: int):
    """Batch decoders for the result pickle (reference :386-441), plain torch
    on the device of their inputs."""

    @torch.no_grad()
    def decode_rec(val_pose, clean_pose, mean, std):
        repr_clean = clean_pose[:, :t_out] * std + mean
        repr_rec = val_pose * std + mean
        return (
            repr_clean,
            repr_rec,
            recover_from_repr(split_repr(repr_clean), mode="smplx_params", body_model=body),
            recover_from_repr(split_repr(repr_rec), mode="joint_abs_traj"),
            recover_from_repr(split_repr(repr_rec), mode="smplx_params", body_model=body),
        )

    @torch.no_grad()
    def decode_noisy(noisy, mean, std):
        dn = noisy[:, :t_out] * std + mean
        return dn, recover_from_repr(split_repr(dn), mode="smplx_params", body_model=body)

    return decode_rec, decode_noisy


def result_filename(args) -> str:
    """Config-encoded pickle name, identical to reference test_amass_full.py:455-462."""
    name = f"test_amass_full_grad_{args.cond_fn_with_grad}_mask_{args.mask_scheme}"
    if args.input_noise and args.load_noise:
        name += f"_noise_{args.load_noise_level}"
    if args.infill_traj:
        name += f"_infill_traj_{args.traj_mask_ratio}"
    name += (
        f"_iter_{args.sample_iter}_iter2trajnoisy_{args.iter2_cond_noisy_traj}"
        f"_iter2posenoisy_{args.iter2_cond_noisy_pose}_earlystop_{args.early_stop}"
        f"_seed_{args.seed}.pkl"
    )
    return name


def run(argv=None) -> tuple[str, dict | None]:
    """The whole test run; returns the result pickle's path and the
    phase-timing dict (seconds) that it also prints (None for a run relayed
    to the server, which prints it there)."""
    args = build_parser().parse_args(argv)
    handled, result = maybe_via_server("test_amass_full", args, argv)
    if handled:
        return result, None
    if args.data_parallel:
        return run_data_parallel(run_rank, args)
    return run_rank(args, None)


def run_rank(args, mesh) -> tuple[str, dict]:
    """`run` on parsed args, as one rank of `mesh` (None: one process)."""
    _phase = PhaseTimer()
    main_rank = mesh is None or mesh.rank == 0
    if mesh is not None and args.batch_size % mesh.size:
        raise ValueError(f"batch_size {args.batch_size} must divide the {mesh.size}-rank mesh")
    device = mesh.device if mesh is not None else resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    body = resolve_body_model(args.body_model_path, device)
    t0 = _phase("body_model_load", t0)

    with rank_zero_first(mesh):
        if args.synthetic_data and not os.path.isdir(
            os.path.join(args.dataset_root, "pose_data_fps_30")
        ):
            write_synthetic_amass(
                args.dataset_root, body,
                datasets={name: 1 for name in AMASS_TEST_DATASETS},
                seq_len=args.clip_len + 4,
            )

    loaded_noise = load_eval_noise(args)

    noise_kw = dict(
        input_noise=args.input_noise,
        noise_std_smplx_global_rot=args.noise_std_smplx_global_rot,
        noise_std_smplx_body_rot=args.noise_std_smplx_body_rot,
        noise_std_smplx_trans=args.noise_std_smplx_trans,
        noise_std_smplx_betas=args.noise_std_smplx_betas,
        load_noise=args.load_noise,
        loaded_smplx_noise_dict=loaded_noise,
    )
    common_kw = dict(
        body_model=body, preprocessed_amass_root=args.dataset_root,
        amass_datasets=AMASS_TEST_DATASETS, clip_len=args.clip_len, seed=args.seed,
        disk_cache_dir=os.path.join(args.dataset_root, "_repr_cache"), device=device,
    )
    t0 = time.perf_counter()
    # twin views of the same data (reference test_amass_full.py:93-127); the
    # stats travel with the PoseNet checkpoint
    with rank_zero_first(mesh):
        stats_dir = amass_stats_dir(args.model_path_posenet, common_kw)
        test_pose_dataset = AmassClipDataset(
            split="test", task="pose", repr_abs_only=False, logdir=stats_dir, **common_kw, **noise_kw
        )
    # traj view shares the pose view's preprocessed arrays (same data)
    test_traj_dataset = test_pose_dataset.view("traj", repr_abs_only=args.repr_abs_only)
    mean, std = test_pose_dataset.mean, test_pose_dataset.std
    traj_feat_dim = test_traj_dataset.traj_feat_dim
    t0 = _phase("dataset_build", t0)

    torch.manual_seed(args.seed)  # random init where no checkpoint is given
    # a mesh is made and closed per run: a pipeline bound to it is not kept
    warm_key = _warm_key(args, stats_dir, body) if mesh is None else None
    warm = _WARM.get(warm_key) if warm_key is not None else None
    if warm is None:
        models = {}
        for name, path, make in (
            ("trajnet", args.model_path_trajnet, lambda: build_trajnet(args, traj_feat_dim, False)),
            ("trajcontrol", args.model_path_trajnet_control, lambda: build_trajnet(args, traj_feat_dim, True)),
            ("posenet", args.model_path_posenet, lambda: build_posenet(args)),
        ):
            model = load_or_init(make(), path, allow_missing=args.allow_missing_ckpt, name=name)
            models[name] = model.to(device).eval()
        pipeline = RohmPipeline(
            trajnet=models["trajnet"], trajcontrol=models["trajcontrol"], posenet=models["posenet"],
            sched_traj=make_schedule(args.noise_schedule, args.diffusion_steps_trajnet,
                                     args.timestep_respacing_eval, device=device),
            sched_pose=make_schedule(args.noise_schedule, args.diffusion_steps_posenet,
                                     args.timestep_respacing_eval, device=device),
            body_model=body, mean=torch.as_tensor(mean, device=device), std=torch.as_tensor(std, device=device),
            repr_abs_only=args.repr_abs_only, traj_feat_dim=traj_feat_dim,
            sample_iter=args.sample_iter, early_stop=args.early_stop,
            grad_type="amass" if args.cond_fn_with_grad else None,
            mask_scheme=args.mask_scheme, input_noise=args.input_noise,
            infill_traj=args.infill_traj,
            iter2_cond_noisy_pose=args.iter2_cond_noisy_pose,
            iter2_cond_noisy_traj=args.iter2_cond_noisy_traj,
            fused_posenet=args.fused_posenet, mesh=mesh,
        )
        decoders = make_pickle_decoders(body, args.clip_len - 2)
        if warm_key is not None:
            _WARM.clear()  # keep at most one configuration's device memory
            _WARM[warm_key] = (pipeline, decoders)
    else:
        print("[test_amass_full] warm hit: reusing resident models + pipeline")
        pipeline, decoders = warm
    decode_rec, decode_noisy = decoders
    mean_d, std_d = pipeline.mean, pipeline.std
    t0 = _phase("model_init", t0)

    out = {
        "rec_ric_data_clean_list": [], "rec_ric_data_noisy_list": [],
        "rec_ric_data_rec_list_from_abs_traj": [], "rec_ric_data_rec_list_from_smpl": [],
        "motion_repr_clean_list": [], "motion_repr_noisy_list": [], "motion_repr_rec_list": [],
    }
    generator = torch.Generator(device=device).manual_seed(args.seed)
    t_repr = args.clip_len - 1  # 144
    mask_len = int(args.traj_mask_ratio * 145)

    # entry key -> reference pickle key (test_amass_full.py:443-454)
    pickle_key = {
        "motion_repr_clean": "motion_repr_clean_list",
        "motion_repr_rec": "motion_repr_rec_list",
        "motion_repr_noisy": "motion_repr_noisy_list",
        "rec_ric_data_clean": "rec_ric_data_clean_list",
        "rec_ric_data_noisy": "rec_ric_data_noisy_list",
        "rec_ric_data_rec_from_abs_traj": "rec_ric_data_rec_list_from_abs_traj",
        "rec_ric_data_rec_from_smpl": "rec_ric_data_rec_list_from_smpl",
    }

    def drain(entry):
        valid = entry.pop("valid")
        for k, v in entry.items():
            out[pickle_key[k]].append(v.cpu().numpy()[:valid])

    pending = []
    # the tail bucket stays divisible by the mesh (rohm_tpu/cli/test_amass_full.py:330-341)
    batch_kw = dict(shuffle=False, drop_last=False, pad_last="bucket",
                    pad_multiple=mesh.size if mesh is not None else 1)
    pose_batches = test_pose_dataset.batches(args.batch_size, **batch_kw)
    traj_batches = test_traj_dataset.batches(args.batch_size, **batch_kw)
    for step, (bp, bt) in enumerate(zip(pose_batches, traj_batches)):
        if args.max_batches and step >= args.max_batches:
            break
        t0 = time.perf_counter()
        valid = bp.pop("_valid")
        bt.pop("_valid")
        bs = bp["motion_repr_clean"].shape[0]
        traj_cond = bt["cond"].copy()

        traj_mask = np.ones((bs, t_repr), np.float32)
        if args.infill_traj:
            start = np.full(bs, 65)
            end = np.minimum(start + mask_len, t_repr)
            t_idx = np.arange(t_repr)
            inside = (t_idx[None] >= start[:, None]) & (t_idx[None] < end[:, None])
            traj_mask = (~inside).astype(np.float32)
            traj_cond = traj_cond * traj_mask[..., None]

        if args.mask_scheme == "full" and not args.infill_traj:
            # the reference redraws the random 30-frame window INSIDE each
            # inference iteration (test_amass_full.py:360-368): one mask per
            # iteration, stacked on a leading dim
            pose_mask = np.stack([
                amass_eval_pose_mask("full", bs, t_repr - 1, window_len=30, rng=rng)
                for _ in range(args.sample_iter)
            ])
        else:
            pose_mask = amass_eval_pose_mask(
                args.mask_scheme, bs, t_repr - 1,
                window_start=np.full(bs, 65) if args.infill_traj else None,
                window_len=mask_len if args.infill_traj else 30,
                rng=None if args.infill_traj else rng,
            )

        t0 = _phase("batch_host_prep", t0)
        val_pose, _ = pipeline.run_batch(
            traj_cond, bt["motion_repr_clean"], bp["motion_repr_noisy"],
            pose_mask, traj_mask, generator,
        )
        if not main_rank:  # the global batch is on every rank; rank 0 writes it
            continue
        entry = {"valid": valid}
        clean = torch.as_tensor(bp["motion_repr_clean"], device=device)
        (
            entry["motion_repr_clean"], entry["motion_repr_rec"],
            entry["rec_ric_data_clean"], entry["rec_ric_data_rec_from_abs_traj"],
            entry["rec_ric_data_rec_from_smpl"],
        ) = decode_rec(val_pose, clean, mean_d, std_d)
        if args.input_noise:
            noisy = bp["motion_repr_noisy"].copy()
            noisy[:, :, :TRAJ_FEAT_DIM_FULL] = bt["motion_repr_noisy"][:, :, :TRAJ_FEAT_DIM_FULL]
            entry["motion_repr_noisy"], entry["rec_ric_data_noisy"] = decode_noisy(
                torch.as_tensor(noisy, device=device), mean_d, std_d
            )
        keep_in_flight(pending, entry, drain)
        t0 = _phase("batch_dispatch", t0)
        print(f"[test_amass_full] batch {step}: dispatched")

    t0 = time.perf_counter()
    for entry in pending:
        drain(entry)
    t0 = _phase("device_wait_and_collect", t0)

    pkl_path = os.path.join(args.save_root, result_filename(args))
    if not main_rank:
        return pkl_path, _phase.summary()
    t0 = time.perf_counter()
    os.makedirs(args.save_root, exist_ok=True)
    save_data = {
        "mask_scheme": args.mask_scheme,
        "repr_name_list": REPR_LIST,
        "repr_dim_dict": REPR_DIM_DICT,
    }
    for k, v in out.items():
        if v:
            save_data[k] = np.concatenate(v, axis=0)
    with open(pkl_path, "wb") as f:
        # protocol 5, as the JAX package writes it; loaders are
        # protocol-agnostic (pickle.load)
        pickle.dump(save_data, f, protocol=5)
    t0 = _phase("result_pickle_write", t0)
    timing = _phase.summary()
    print(f"[test_amass_full] timing (s): {timing}")
    print(f"results saved to {pkl_path}")
    return pkl_path, timing


def main(argv=None) -> str:
    return run(argv)[0]


if __name__ == "__main__":
    main()
