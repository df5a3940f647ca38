"""test_prox_egobody — the full RoHM pipeline on video data (PROX / EgoBody),
in PyTorch.

The port of rohm_tpu/cli/test_prox_egobody.py: the same flags and YAML
semantics (reference test_prox_egobody.py:20-73), the same save directory,
pickle name and keys (:356-393: per recording, with the scene<->cano
transforms). Guidance is the 'prox' stack: 2-D keypoint reprojection plus
foot skating, both through the SMPL-X body, differentiated with autograd
inside the sampling loop. Run:

    python -m rohm_tpu_torch.cli.test_prox_egobody --config cfg_files/test_cfg/prox_rgb.yaml \\
        --fused_posenet=bf16 --device=0

The PoseNet checkpoint's directory must hold the AMASS training stats
(AMASS_mean.pkl / AMASS_std.pkl). Checkpoints are `.npz` flax params or
torch state_dicts (the reference's released weights). `--device` is a CUDA
index (default 0) or `cpu`; `--fused_posenet` False/True/bf16/int8/int8qa/
f32 picks the PoseNet path. `--data_parallel=True` splits every batch over
one process per card as test_amass_full does (the 'prox' guidance takes its
losses over the global batch); rank 0 writes the pickle. `--via_server=True`
relays the run to the resident server (rohm_tpu_torch/serve).
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

from rohm_tpu_torch.cli.common import (
    PhaseTimer,
    build_posenet,
    build_trajnet,
    keep_in_flight,
    load_or_init,
    maybe_via_server,
    rank_zero_first,
    resolve_body_model,
    resolve_device,
    run_data_parallel,
)
from rohm_tpu_torch.data.video import VideoClipDataset
from rohm_tpu_torch.diffusion.schedule import make_schedule
from rohm_tpu_torch.pipeline import RohmPipeline
from rohm_tpu_torch.reprs import recover_from_repr, split_repr
from rohm_tpu_torch.reprs.schema import REPR_DIM_DICT, REPR_LIST
from rohm_tpu_torch.utils.config import ConfigParser, fused_mode


def build_parser() -> ConfigParser:
    p = ConfigParser("RoHM PROX/EgoBody test (PyTorch)")
    p.add_argument("--device", type=str, default="0")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--diffusion_steps_posenet", type=int, default=1000)
    p.add_argument("--diffusion_steps_trajnet", type=int, default=100)
    p.add_argument("--noise_schedule", type=str, default="cosine")
    p.add_argument("--timestep_respacing_eval", type=str, default="")
    p.add_argument("--sigma_small", type=bool, default=True)
    p.add_argument("--body_model_path", type=str, default="data/body_models/smplx_model")
    p.add_argument("--dataset", type=str, default="egobody")
    p.add_argument("--dataset_root", type=str, default="")
    p.add_argument("--init_root", type=str, default="data/init_motions/init_prox_rgb")
    p.add_argument("--clip_len", type=int, default=145)
    p.add_argument("--repr_abs_only", type=bool, default=True)
    p.add_argument("--model_path_trajnet", type=str, default="")
    p.add_argument("--model_path_trajnet_control", type=str, default="")
    p.add_argument("--model_path_posenet", type=str, default="")
    p.add_argument("--batch_size", type=int, default=20)
    p.add_argument("--cond_fn_with_grad", type=bool, default=True)
    p.add_argument("--save_root", type=str, default="test_results/results_egobody")
    p.add_argument("--sample_iter", type=int, default=2)
    p.add_argument("--iter2_cond_noisy_traj", type=bool, default=False)
    p.add_argument("--iter2_cond_noisy_pose", type=bool, default=False)
    p.add_argument("--early_stop", type=bool, default=True)
    p.add_argument("--window_size", type=int, default=2)
    p.add_argument("--recording_name", type=str, default="recording_20211004_S12_S20_01")
    p.add_argument("--use_scene_floor_height", type=bool, default=True)
    # extensions of the reference CLI (as in the JAX package's)
    p.add_argument("--mid_dim", type=int, default=512)
    p.add_argument("--latent_dim", type=int, default=512)
    p.add_argument("--max_batches", type=int, default=0)
    p.add_argument("--fused_posenet", type=fused_mode, default=False)
    p.add_argument("--data_parallel", type=bool, default=False)
    p.add_argument("--allow_missing_ckpt", type=bool, default=False)
    p.add_argument("--via_server", type=bool, default=False)
    return p


def save_dir_name(args) -> str:
    """Config-encoded result directory (reference test_prox_egobody.py:356-362)."""
    return (
        f"test_{args.dataset}_grad_{args.cond_fn_with_grad}_iter_{args.sample_iter}"
        f"_iter2trajnoisy_{args.iter2_cond_noisy_traj}_iter2posenoisy_{args.iter2_cond_noisy_pose}"
        f"_earlystop_{args.early_stop}_seed_{args.seed}"
    )


def run(argv=None) -> tuple[str, dict | None]:
    """The whole test run; returns the result pickle's path and the
    phase-timing dict (seconds, host clock) that it also prints (None for a
    run relayed to the server, which prints it there)."""
    args = build_parser().parse_args(argv)
    handled, result = maybe_via_server("test_prox_egobody", args, argv)
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
    t0 = time.perf_counter()
    body = resolve_body_model(args.body_model_path, device)
    t0 = _phase("body_model_load", t0)

    stats_dir = os.path.dirname(args.model_path_posenet) if args.model_path_posenet else None
    if not (stats_dir and os.path.exists(os.path.join(stats_dir, "AMASS_mean.pkl"))):
        raise FileNotFoundError(
            "video testing needs AMASS train stats next to the PoseNet checkpoint "
            "(reference couples them: dataloader_video.py:405-414)"
        )

    with rank_zero_first(mesh):  # rank 0 writes the derived-array cache
        test_pose_dataset = VideoClipDataset(
            task="pose", repr_abs_only=False, body_model=body, dataset=args.dataset,
            init_root=args.init_root, base_dir=args.dataset_root, recording_name=args.recording_name,
            use_scene_floor_height=args.use_scene_floor_height, overlap_len=args.window_size,
            clip_len=args.clip_len, logdir=stats_dir, device=device,
            disk_cache_dir=os.path.join(args.dataset_root, "_repr_cache") if args.dataset_root else None,
        )
    test_traj_dataset = test_pose_dataset.view("traj", repr_abs_only=args.repr_abs_only)
    mean, std = test_pose_dataset.mean, test_pose_dataset.std
    traj_feat_dim = test_traj_dataset.traj_feat_dim
    t_repr = args.clip_len - 1
    t0 = _phase("dataset_build", t0)

    torch.manual_seed(args.seed)  # random init where no checkpoint is given
    models = {}
    for name, path, make in (
        ("trajnet", args.model_path_trajnet, lambda: build_trajnet(args, traj_feat_dim, False)),
        ("trajcontrol", args.model_path_trajnet_control, lambda: build_trajnet(args, traj_feat_dim, True)),
        ("posenet", args.model_path_posenet, lambda: build_posenet(args)),
    ):
        model = load_or_init(make(), path, allow_missing=args.allow_missing_ckpt, name=name)
        models[name] = model.to(device).eval()
    mean_d = torch.as_tensor(mean, device=device)
    std_d = torch.as_tensor(std, device=device)
    pipeline = RohmPipeline(
        trajnet=models["trajnet"], trajcontrol=models["trajcontrol"], posenet=models["posenet"],
        sched_traj=make_schedule(args.noise_schedule, args.diffusion_steps_trajnet,
                                 args.timestep_respacing_eval, device=device),
        sched_pose=make_schedule(args.noise_schedule, args.diffusion_steps_posenet,
                                 args.timestep_respacing_eval, device=device),
        body_model=body, mean=mean_d, std=std_d,
        repr_abs_only=args.repr_abs_only, traj_feat_dim=traj_feat_dim,
        sample_iter=args.sample_iter, early_stop=args.early_stop,
        grad_type="prox" if args.cond_fn_with_grad else None,
        mask_scheme="video",  # real visibility masks from the data
        input_noise=True,
        iter2_cond_noisy_pose=args.iter2_cond_noisy_pose,
        iter2_cond_noisy_traj=args.iter2_cond_noisy_traj,
        fused_posenet=args.fused_posenet, mesh=mesh,
    )
    t0 = _phase("model_init", t0)

    @torch.no_grad()
    def decode_batch(val_pose, pose_noisy):
        noisy = pose_noisy[:, : t_repr - 1] * std_d + mean_d
        rec = val_pose * std_d + mean_d
        return {
            "motion_repr_noisy_list": noisy,
            "motion_repr_rec_list": rec,
            "rec_ric_data_noisy_list": recover_from_repr(split_repr(noisy), mode="smplx_params", body_model=body),
            "rec_ric_data_rec_list_from_abs_traj": recover_from_repr(split_repr(rec), mode="joint_abs_traj"),
            "rec_ric_data_rec_list_from_smpl": recover_from_repr(split_repr(rec), mode="smplx_params",
                                                                 body_model=body),
        }

    out = {
        "trans_scene2cano_list": [], "rec_ric_data_noisy_list": [],
        "rec_ric_data_rec_list_from_abs_traj": [], "rec_ric_data_rec_list_from_smpl": [],
        "joints_input_scene_coord_list": [], "joints_gt_scene_coord_list": [],
        "motion_repr_rec_list": [], "motion_repr_noisy_list": [], "mask_joint_vis_list": [],
    }
    frame_names = []
    generator = torch.Generator(device=device).manual_seed(args.seed)
    cam_r = test_pose_dataset.cam_r.astype(np.float32)
    cam_t = test_pose_dataset.cam_t.astype(np.float32)

    def drain(entry):
        v, bp = entry.pop("valid"), entry.pop("bp")
        frame_names.extend(bp["frame_name"][:v])
        out["trans_scene2cano_list"].append(bp["transf_matrix"][:v])
        out["joints_input_scene_coord_list"].append(bp["noisy_joints_scene_coord"][:v])
        if args.dataset == "egobody":
            out["joints_gt_scene_coord_list"].append(bp["gt_joints_scene_coord"][:v])
        out["mask_joint_vis_list"].append(bp["mask_joint_vis"][:v, : t_repr - 1])
        for k, t in entry.items():
            out[k].append(t.cpu().numpy()[:v])

    pending = []
    pad_multiple = mesh.size if mesh is not None else 1
    pose_batches = test_pose_dataset.batches(args.batch_size, pad_last="bucket", pad_multiple=pad_multiple)
    traj_batches = test_traj_dataset.batches(args.batch_size, pad_last="bucket", pad_multiple=pad_multiple)
    for step, (bp, bt) in enumerate(zip(pose_batches, traj_batches)):
        if args.max_batches and step >= args.max_batches:
            break
        t0 = time.perf_counter()
        valid = bp.pop("_valid")
        bt.pop("_valid")
        # mask_vec_vis[:, :-2] masks the T-2=143-frame PoseNet condition
        # (test_prox_egobody.py:306-309)
        pose_mask = bp["mask_vec_vis"][:, : t_repr - 1].copy()
        pose_mask[..., -4:] = 0.0
        guidance_data = {
            "transf_matrix": bp["transf_matrix"], "cam_r": cam_r, "cam_t": cam_t,
            "focal_length": bp["focal_length"], "camera_center": bp["camera_center"],
            "keypoints_2d": bp["keypoints_2d"],
        }
        t0 = _phase("batch_host_prep", t0)
        val_pose, _ = pipeline.run_batch(
            bt["cond"], bt["motion_repr_noisy"], bp["motion_repr_noisy"],
            pose_mask, np.ones(bt["cond"].shape[:2], np.float32), generator,
            guidance_data=guidance_data,
        )
        if not main_rank:  # the global batch is on every rank; rank 0 writes it
            continue
        entry = {"valid": valid, "bp": bp,
                 **decode_batch(val_pose, torch.as_tensor(bp["motion_repr_noisy"], device=device))}
        keep_in_flight(pending, entry, drain)
        t0 = _phase("batch_dispatch", t0)
        print(f"[test_prox_egobody] batch {step}: dispatched")

    t0 = time.perf_counter()
    for entry in pending:
        drain(entry)
    t0 = _phase("device_wait_and_collect", t0)

    save_dir = os.path.join(args.save_root, save_dir_name(args))
    pkl_path = os.path.join(save_dir, f"{args.recording_name}.pkl")
    if not main_rank:
        return pkl_path, _phase.summary()
    save_data = {
        "repr_name_list": REPR_LIST,
        "repr_dim_dict": REPR_DIM_DICT,
        "recording_name": args.recording_name,
        "frame_name_list": frame_names,
        # the scene name travels with the results so eval can use the
        # per-scene preset floor height (reference eval_prox_egobody.py:256-264)
        "scene_name": getattr(test_pose_dataset, "scene_name", ""),
        "color_cam": getattr(test_pose_dataset, "color_cam", None),
        # input-frame stride between consecutive windows (for stitching)
        "window_stride": args.clip_len - args.window_size,
    }
    if args.dataset == "egobody":
        save_data["gender_gt"] = test_pose_dataset.gender_gt
    for k, v in out.items():
        if v:
            save_data[k] = np.concatenate(v, axis=0)

    os.makedirs(save_dir, exist_ok=True)
    with open(pkl_path, "wb") as f:
        pickle.dump(save_data, f, protocol=2)
    t0 = _phase("result_pickle_write", t0)
    timing = _phase.summary()
    print(f"[test_prox_egobody] timing (s): {timing}")
    print(f"results saved to {pkl_path}")
    return pkl_path, timing


def main(argv=None) -> str:
    return run(argv)[0]


if __name__ == "__main__":
    main()
