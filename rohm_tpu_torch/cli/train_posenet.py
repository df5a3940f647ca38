"""train_posenet — PoseNet training, in PyTorch.

The port of rohm_tpu/cli/train_posenet.py: the same flags and YAML
semantics (reference train_posenet.py:16-70; repr_abs_only forced False for
PoseNet, :87) and the same run directory: `<save_dir>/<id>/` with
params.json, a run_*.log, the AMASS_mean/std pickles and the checkpoints
`model{step:09d}.npz` (flattened flax params, which the JAX package's
`load_pretrained` and the port's test CLI read). Run:

    python -m rohm_tpu_torch.cli.train_posenet --config cfg_files/train_cfg/posenet_train_stage1.yaml \\
        --fused_train=bfloat16 --device=0

`--device` is a CUDA index (default 0) or `cpu`; an index with no CUDA
device raises. `--fused_train` "" trains the plain module under autograd;
"bfloat16" / "float32" run the encoder layers through the hand-written CUDA
forward and backward kernels with that GEMM operand mode.
`--model_dtype=bfloat16` runs the module in bf16 (parameters and
checkpoints stay f32); the fused path ignores it, as in the JAX package,
while the eval during training samples the bf16 module.
`--data_parallel=True` splits every batch over one process per card (alone
it uses every visible card; under torchrun each rank joins the launcher's
group): the gradients are summed over ranks and rank 0 writes the run
directory.
"""

from __future__ import annotations

import os

from rohm_tpu_torch.cli.common import (
    AMASS_TEST_DATASETS,
    AMASS_TRAIN_DATASETS,
    build_posenet,
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
from rohm_tpu_torch.train.loop import TrainLoopPoseNet
from rohm_tpu_torch.train.masking import build_prox_mask_bank
from rohm_tpu_torch.utils.config import ConfigParser


def build_parser() -> ConfigParser:
    p = ConfigParser("RoHM PoseNet training (PyTorch)")
    p.add_argument("--device", type=str, default="0")
    p.add_argument("--diffusion_steps", type=int, default=1000)
    p.add_argument("--noise_schedule", type=str, default="cosine")
    p.add_argument("--timestep_respacing_eval", type=str, default="")
    p.add_argument("--sigma_small", type=bool, default=True)
    p.add_argument("--body_model_path", type=str, default="data/body_models/smplx_model")
    p.add_argument("--dataset_root", type=str, default="datasets/AMASS_smplx_preprocessed")
    p.add_argument("--task", type=str, default="pose")
    p.add_argument("--clip_len", type=int, default=145)
    p.add_argument("--load_pretrained_model", type=bool, default=False)
    p.add_argument("--pretrained_model_path", type=str, default="")
    p.add_argument("--input_noise", type=bool, default=True)
    p.add_argument("--noise_std_smplx_global_rot", type=float, default=3)
    p.add_argument("--noise_std_smplx_body_rot", type=float, default=2)
    p.add_argument("--noise_std_smplx_trans", type=float, default=0.01)
    p.add_argument("--noise_std_smplx_betas", type=float, default=0.2)
    for w, d in [
        ("weight_loss_rec_repr_full_body", 1.0),
        ("weight_loss_repr_foot_contact_mse", 1.0),
        ("weight_loss_joint_pos_global", 100.0),
        ("weight_loss_joint_vel_global", 1000.0),
        ("weight_loss_joint_smooth", 0.0),
        ("weight_loss_foot_skating", 0.0),
    ]:
        p.add_argument(f"--{w}", type=float, default=d)
    p.add_argument("--start_skating_loss_epoch", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--model_dtype", type=str, default="float32")  # float32 | bfloat16
    # "" (the plain module under autograd) | "bfloat16" | "float32": the
    # encoder layers through the CUDA training kernels with that GEMM dtype
    p.add_argument("--fused_train", type=str, default="")
    p.add_argument("--debug", type=bool, default=False)
    p.add_argument("--start_prox_mask_epoch", type=int, default=500)
    p.add_argument("--mask_scheme", type=str, default="lower")
    p.add_argument("--save_dir", type=str, default="runs")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--log_interval", type=int, default=25000)
    p.add_argument("--save_interval", type=int, default=25000)
    p.add_argument("--num_steps", type=int, default=10**9)
    # extensions of the reference CLI, as in the JAX package
    p.add_argument("--synthetic_data", type=bool, default=False)
    p.add_argument("--latent_dim", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_parallel", type=bool, default=False)
    p.add_argument("--save_optimizer", type=bool, default=False)
    p.add_argument("--resume_from", type=str, default="")
    return p


def main(argv=None) -> TrainLoopPoseNet | str:
    """The training run. Returns the loop; a run that spawned one process
    per card (`--data_parallel=True` alone on several cards) returns rank
    0's run directory."""
    args = build_parser().parse_args(argv)
    model_dtype(args)  # an unknown --model_dtype fails before any run directory
    if args.data_parallel:
        return run_data_parallel(main_rank, args)
    return main_rank(args, None)


def main_rank(args, mesh) -> TrainLoopPoseNet:
    """`main` on parsed args, as one rank of `mesh` (None: one process)."""
    device = mesh.device if mesh is not None else resolve_device(args.device)
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
    # repr_abs_only forced False for PoseNet (reference train_posenet.py:87)
    # rank 0 first: it writes the derived-array cache and the stats that
    # the test split reads from the run directory
    with rank_zero_first(mesh):
        train_dataset = AmassClipDataset(
            body_model=body, preprocessed_amass_root=args.dataset_root,
            amass_datasets=train_sets, split="train", repr_abs_only=False,
            task="pose", clip_len=args.clip_len, logdir=logdir if is_main else None,
            seed=args.seed, device=device,
            **noise_kw,
        )
        test_dataset = AmassClipDataset(
            body_model=body, preprocessed_amass_root=args.dataset_root,
            amass_datasets=test_sets, split="test", spacing=2, repr_abs_only=False,
            task="pose", clip_len=args.clip_len, logdir=logdir, seed=args.seed + 1, device=device,
            **noise_kw,
        )

    model = build_posenet(args, seed=args.seed)
    if args.load_pretrained_model:
        load_pretrained(model, args.pretrained_model_path)
        logger.info("loaded checkpoint from %s", args.pretrained_model_path)
    model = model.to(device)

    # real PROX occlusion masks as the training-mask bank
    # (training_loop_posenet.py:65-98); root is <dataset_root>/../PROX/mask_joint
    prox_mask_root = os.path.join(os.path.dirname(args.dataset_root.rstrip("/")), "PROX", "mask_joint")
    prox_bank = None
    if os.path.isdir(prox_mask_root):
        prox_bank = build_prox_mask_bank(prox_mask_root, args.clip_len)
        logger.info("loaded %d PROX mask clips", len(prox_bank))

    sched_train = make_schedule(args.noise_schedule, args.diffusion_steps, "", device=device)
    sched_eval = make_schedule(args.noise_schedule, args.diffusion_steps,
                               args.timestep_respacing_eval, device=device)
    weights = {k: getattr(args, k) for k in vars(args) if k.startswith("weight_loss_")}

    loop = TrainLoopPoseNet(
        model=model, sched_train=sched_train, sched_eval=sched_eval,
        train_dataset=train_dataset, test_dataset=test_dataset, body_model=body,
        loss_weights=weights, logdir=logdir, device=device, batch_size=args.batch_size,
        lr=args.lr, weight_decay=args.weight_decay, num_steps=args.num_steps,
        log_interval=args.log_interval, save_interval=args.save_interval,
        input_noise=args.input_noise, start_prox_mask_epoch=args.start_prox_mask_epoch,
        start_skating_loss_epoch=args.start_skating_loss_epoch,
        mask_scheme=args.mask_scheme, prox_mask_bank=prox_bank, writer=writer,
        seed=args.seed, run_logger=logger, save_optimizer=args.save_optimizer, mesh=mesh,
        fused_train=args.fused_train,
    )
    if args.resume_from:
        loop.restore(args.resume_from)
    loop.run_loop()
    loop.save()
    return loop


if __name__ == "__main__":
    main()
