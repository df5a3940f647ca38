"""train_trajnet — TrajNet and TrajControl training, in PyTorch.

The port of rohm_tpu/cli/train_trajnet.py: the same flags and YAML
semantics (reference train_trajnet.py:16-79) and the same run directory:
`<save_dir>/<id>/` with params.json, a run_*.log, the AMASS_mean/std
pickles and the checkpoints `model{step:09d}.npz` (flattened flax params,
which the JAX package's `load_pretrained` and the port's
`--model_path_trajnet`, `--model_path_trajnet_control` and
`--pretrained_backbone_path` read). Run, vanilla then the TrajControl
fine-tune from its checkpoint:

    python -m rohm_tpu_torch.cli.train_trajnet \\
        --config cfg_files/train_cfg/trajnet_train_vanilla_stage1.yaml --device=0
    python -m rohm_tpu_torch.cli.train_trajnet \\
        --config cfg_files/train_cfg/trajnet_ft_trajcontrol.yaml --device=0 \\
        --pretrained_backbone_path=runs/<id>/model000450000.npz

`--device` is a CUDA index (default 0) or `cpu`; an index with no CUDA
device raises. With `--trajcontrol`, everything outside the ControlNet
branch is frozen (train/state.py). `--model_dtype=bfloat16` runs TrajNet in
bf16 (parameters and checkpoints stay f32). `--data_parallel=True` splits
every batch over one process per card (alone it uses every visible card;
under torchrun each rank joins the launcher's group): the gradients are
summed over ranks and rank 0 writes the run directory.
"""

from __future__ import annotations

import os

import torch

from rohm_tpu_torch.cli.common import (
    AMASS_TEST_DATASETS,
    AMASS_TRAIN_DATASETS,
    bootstrap_trajcontrol,
    build_trajnet,
    load_pretrained,
    model_dtype,
    open_run_dir,
    rank_zero_first,
    resolve_body_model,
    resolve_device,
    run_data_parallel,
)
from rohm_tpu_torch.data import AmassClipDataset, write_synthetic_amass
from rohm_tpu_torch.diffusion.schedule import make_schedule
from rohm_tpu_torch.train.loop import TrainLoopTrajNet
from rohm_tpu_torch.train.state import trajcontrol_frozen_mask
from rohm_tpu_torch.utils.config import ConfigParser


def build_parser() -> ConfigParser:
    p = ConfigParser("RoHM TrajNet training (PyTorch)")
    p.add_argument("--device", type=str, default="0")
    p.add_argument("--diffusion_steps", type=int, default=100)
    p.add_argument("--noise_schedule", type=str, default="cosine")
    p.add_argument("--timestep_respacing_eval", type=str, default="")
    p.add_argument("--sigma_small", type=bool, default=True)
    p.add_argument("--body_model_path", type=str, default="data/body_models/smplx_model")
    p.add_argument("--dataset_root", type=str, default="datasets/AMASS_smplx_preprocessed")
    p.add_argument("--task", type=str, default="traj")
    p.add_argument("--clip_len", type=int, default=145)
    p.add_argument("--repr_abs_only", type=bool, default=True)
    p.add_argument("--trajcontrol", type=bool, default=False)
    p.add_argument("--load_pretrained_backbone", type=bool, default=False)
    p.add_argument("--pretrained_backbone_path", type=str, default="")
    p.add_argument("--load_pretrained_model", type=bool, default=False)
    p.add_argument("--pretrained_model_path", type=str, default="")
    p.add_argument("--input_noise", type=bool, default=True)
    p.add_argument("--noise_std_smplx_global_rot", type=float, default=3)
    p.add_argument("--noise_std_smplx_body_rot", type=float, default=2)
    p.add_argument("--noise_std_smplx_trans", type=float, default=0.02)
    p.add_argument("--noise_std_smplx_betas", type=float, default=0.2)
    for w, d in [
        ("weight_loss_root_rec_repr", 1.0),
        ("weight_loss_root_pos_global", 100.0),
        ("weight_loss_root_vel_global", 1000.0),
        ("weight_loss_root_rot_vel_from_abs_traj", 1.0),
        ("weight_loss_root_smplx_transl_vel", 1000.0),
        ("weight_loss_root_smplx_rot_vel", 1.0),
        ("weight_loss_root_smooth", 0.0),
        ("weight_loss_root_rot_cos_smooth_from_abs_traj", 0.0),
    ]:
        p.add_argument(f"--{w}", type=float, default=d)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--model_dtype", type=str, default="float32")  # float32 | bfloat16
    p.add_argument("--debug", type=bool, default=False)
    p.add_argument("--max_infill_ratio", type=float, default=0.1)
    p.add_argument("--mask_prob", type=float, default=0.4)
    p.add_argument("--start_infill_epoch", type=int, default=10**20)
    p.add_argument("--save_dir", type=str, default="runs")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--log_interval", type=int, default=25000)
    p.add_argument("--save_interval", type=int, default=25000)
    p.add_argument("--num_steps", type=int, default=10**9)
    # extensions of the reference CLI, as in the JAX package
    p.add_argument("--synthetic_data", type=bool, default=False)
    p.add_argument("--mid_dim", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_parallel", type=bool, default=False)
    p.add_argument("--save_optimizer", type=bool, default=False)
    p.add_argument("--resume_from", type=str, default="")
    return p


def main(argv=None) -> TrainLoopTrajNet | str:
    """The training run. Returns the loop; a run that spawned one process
    per card (`--data_parallel=True` alone on several cards) returns rank
    0's run directory."""
    args = build_parser().parse_args(argv)
    model_dtype(args)  # an unknown --model_dtype fails before any run directory
    if args.data_parallel:
        return run_data_parallel(main_rank, args)
    return main_rank(args, None)


def main_rank(args, mesh) -> TrainLoopTrajNet:
    """`main` on parsed args, as one rank of `mesh` (None: one process)."""
    device = mesh.device if mesh is not None else resolve_device(args.device)
    # cuDNN runs f32 convolutions in TF32 by default, which keeps ~3 digits:
    # the U-Net trains in full f32, as the pipeline samples it
    torch.backends.cudnn.allow_tf32 = False
    logdir, logger, writer = open_run_dir(args, mesh)
    is_main = mesh is None or mesh.rank == 0

    body = resolve_body_model(args.body_model_path, device)
    train_sets = AMASS_TRAIN_DATASETS if not args.debug else ["HumanEva"]
    test_sets = AMASS_TEST_DATASETS if not args.debug else ["TCDHands"]
    with rank_zero_first(mesh):
        if args.synthetic_data and not os.path.isdir(
            os.path.join(args.dataset_root, "pose_data_fps_30")
        ):
            logger.info("generating synthetic AMASS tree at %s", args.dataset_root)
            write_synthetic_amass(
                args.dataset_root, body,
                datasets={name: 2 for name in train_sets + test_sets},
                seq_len=2 * args.clip_len + 4,
            )

    noise_kw = dict(
        input_noise=args.input_noise,
        noise_std_smplx_global_rot=args.noise_std_smplx_global_rot,
        noise_std_smplx_body_rot=args.noise_std_smplx_body_rot,
        noise_std_smplx_trans=args.noise_std_smplx_trans,
        noise_std_smplx_betas=args.noise_std_smplx_betas,
    )
    # rank 0 first: it writes the derived-array cache and the stats that
    # the test split reads from the run directory
    with rank_zero_first(mesh):
        train_dataset = AmassClipDataset(
            body_model=body, preprocessed_amass_root=args.dataset_root,
            amass_datasets=train_sets, split="train", repr_abs_only=args.repr_abs_only,
            task=args.task, clip_len=args.clip_len, logdir=logdir if is_main else None,
            seed=args.seed, device=device,
            **noise_kw,
        )
        test_dataset = AmassClipDataset(
            body_model=body, preprocessed_amass_root=args.dataset_root,
            amass_datasets=test_sets, split="test", spacing=2,
            repr_abs_only=args.repr_abs_only, task=args.task, clip_len=args.clip_len,
            logdir=logdir, seed=args.seed + 1, device=device, **noise_kw,
        )

    traj_feat_dim = train_dataset.traj_feat_dim
    model = build_trajnet(args, traj_feat_dim, args.trajcontrol, seed=args.seed)
    if args.load_pretrained_model:
        load_pretrained(model, args.pretrained_model_path)
        logger.info("loaded checkpoint from %s", args.pretrained_model_path)
    trainable = None
    if args.trajcontrol:
        if args.load_pretrained_backbone:
            if args.load_pretrained_model:
                raise ValueError("for TrajControl finetune, cannot set both load_pretrained_backbone "
                                 "and load_pretrained_model")
            backbone = build_trajnet(args, traj_feat_dim, False, seed=args.seed)
            load_pretrained(backbone, args.pretrained_backbone_path)
            model.load_state_dict(bootstrap_trajcontrol(model.state_dict(), backbone.state_dict()), strict=True)
            logger.info("bootstrapped ControlNet from %s", args.pretrained_backbone_path)
        trainable = trajcontrol_frozen_mask(model)
    model = model.to(device)

    sched_train = make_schedule(args.noise_schedule, args.diffusion_steps, "", device=device)
    sched_eval = make_schedule(args.noise_schedule, args.diffusion_steps,
                               args.timestep_respacing_eval, device=device)
    weights = {k: getattr(args, k) for k in vars(args) if k.startswith("weight_loss_")}

    loop = TrainLoopTrajNet(
        model=model, sched_train=sched_train, sched_eval=sched_eval,
        train_dataset=train_dataset, test_dataset=test_dataset, body_model=body,
        loss_weights=weights, logdir=logdir, device=device, batch_size=args.batch_size,
        lr=args.lr, weight_decay=args.weight_decay, num_steps=args.num_steps,
        log_interval=args.log_interval, save_interval=args.save_interval,
        start_infill_epoch=args.start_infill_epoch, mask_prob=args.mask_prob,
        max_infill_ratio=args.max_infill_ratio, repr_abs_only=args.repr_abs_only,
        trajcontrol=args.trajcontrol, trainable=trainable, writer=writer,
        seed=args.seed, run_logger=logger, save_optimizer=args.save_optimizer, mesh=mesh,
    )
    if args.resume_from:
        loop.restore(args.resume_from)
    loop.run_loop()
    loop.save()
    return loop


if __name__ == "__main__":
    main()
