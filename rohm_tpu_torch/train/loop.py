"""The TrajNet and PoseNet training loops.

The port of rohm_tpu/train/loop.py (`_CheckpointMixin`, `TrainLoopTrajNet`,
`TrainLoopPoseNet`; reference train/training_loop_trajnet.py:16-153 and
training_loop_posenet.py:15-303): the same epochs and batches
(`batches(seed=epoch)`), the same masking curricula drawn from the same
numpy generator (TrajNet's infill windows from start_infill_epoch;
PoseNet's PROX masks after start_prox_mask_epoch and its skating loss from
start_skating_loss_epoch), the eval during training every log_interval
steps and the checkpoints every save_interval steps. Timesteps, noise and
dropout masks come from one torch.Generator on the training device, seeded
like the numpy generator. Both epoch loops keep the JAX loop's extra step
when num_steps is a multiple of the batches per epoch
(rohm_tpu/train/loop.py:167-187).

Data parallelism (`mesh`, rohm_tpu/train/loop.py:113-145): every rank
builds the same global batch from the same loaders, curricula and numpy
generator and keeps its rows; the steps draw at the global batch and sum
the gradients (train/steps.py), so every rank holds the same parameters.
The eval during training samples each rank's rows and gathers them before
the metrics. Only rank 0 logs, writes TensorBoard and saves checkpoints,
with a barrier after each save.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from rohm_tpu_torch.diffusion.schedule import DiffusionSchedule
from rohm_tpu_torch.models.losses import posenet_losses, trajnet_losses
from rohm_tpu_torch.parallel.mesh import DataMesh, barrier, gather_rows, shard_batch, shard_rows
from rohm_tpu_torch.train.checkpoint import checkpoint_step, load_checkpoint, save_checkpoint
from rohm_tpu_torch.train.masking import posenet_eval_cond_mask, posenet_train_cond_mask, traj_infill_mask
from rohm_tpu_torch.train.state import TrainState, create_train_state
from rohm_tpu_torch.train.steps import (
    make_posenet_sampler,
    make_posenet_train_step,
    make_trajnet_sampler,
    make_trajnet_train_step,
)

logger = logging.getLogger("rohm_tpu_torch.train")


def _log_losses(writer, logger_, tag, losses, step, epoch):
    for key, val in losses.items():
        v = float(val)
        if writer is not None:
            writer.add_scalar(f"{tag}/{key}", v, step)
        logger_.info(f"[Step {step:d}/ Epoch {epoch:d}] [{tag}]  {key}: {v:.10f}")


class _CheckpointMixin:
    """Save/restore of the train loops (rohm_tpu/train/loop.py:49-82)."""

    last_losses: dict = None  # most recent train-step loss dict (tests/monitoring)

    def save(self) -> str | None:
        """Rank 0 writes model{step:09d}.npz and returns its path (None on
        the other ranks); every rank waits for the write."""
        path = None
        if self.is_main:
            path = save_checkpoint(
                self.logdir, self.step, self.state.model,
                optimizer=self.state.optimizer if self.save_optimizer else None,
            )
            self.logger.info("[*] model saved")
        barrier(self.mesh)
        return path

    def restore(self, ckpt_path: str):
        """Resume params (+ optimizer state when the checkpoint has it) from a
        model{step:09d}.npz or a JAX trainer's model{step:09d} orbax
        directory; the step resumes from the checkpoint's name."""
        if load_checkpoint(ckpt_path, self.state.model, self.state.optimizer):
            self.logger.info("restored params + optimizer state from %s", ckpt_path)
        else:
            self.logger.info("restored params (no optimizer state) from %s", ckpt_path)
        step = checkpoint_step(ckpt_path)
        if step is not None:
            self.step = self.state.step = step


class _TrainLoop(_CheckpointMixin):
    """The epoch loop and the eval during training that both loops share
    (rohm_tpu/train/loop.py:160-202, 290-329). A loop supplies
    `_train_batch(batch, epoch) -> loss dict` (one optimizer step on a
    loader batch) and `_eval_sample(batch, epoch) -> output` (the reverse
    chain on a test batch, this rank's rows under a mesh)."""

    mesh: DataMesh | None = None

    @property
    def is_main(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _rows(self, a: np.ndarray) -> torch.Tensor:
        """This rank's rows of a global batch array, on the device."""
        return self._to_device(shard_rows(a, self.mesh))

    def _log(self, tag, losses, epoch):
        if self.is_main:
            _log_losses(self.writer, self.logger, tag, losses, self.step, epoch)

    def run_loop(self):
        # batches() drops a short tail, so a batch_size larger than the
        # dataset would yield no batch and save an untrained checkpoint
        assert len(self.train_dataset) >= self.batch_size, (
            f"batch_size {self.batch_size} exceeds the train dataset "
            f"({len(self.train_dataset)} clips): the epoch loader would be "
            "empty and no training would happen"
        )
        if self.mesh is not None and self.batch_size % self.mesh.size:
            raise ValueError(f"batch_size {self.batch_size} must divide the {self.mesh.size}-rank mesh")
        steps_per_epoch = max(len(self.train_dataset) // self.batch_size, 1)
        num_epochs = self.num_steps // steps_per_epoch + 1
        for epoch in range(num_epochs):
            for batch in self.train_dataset.batches(self.batch_size, seed=epoch):
                # both loops stop at num_steps exactly: the JAX loops' break
                # leaves only the epoch, so where num_steps is a multiple of
                # the batches per epoch they run (and may save) one step more
                if self.step >= self.num_steps:
                    return
                losses = self._train_batch(batch, epoch)
                self.last_losses = losses
                if self.step % self.log_interval == 0 and self.step > 0:
                    self._log("train", losses, epoch)
                    self._eval(epoch)
                if self.step % self.save_interval == 0 and self.step > 0:
                    self.save()
                self.step += 1

    @torch.no_grad()
    def _eval(self, epoch):
        agg, n = None, 0
        for batch in self.test_dataset.batches(self.batch_size, shuffle=False):
            out = gather_rows(self._eval_sample(batch, epoch), self.mesh)
            losses = self.eval_loss_fn(out, self._to_device(batch["motion_repr_clean"]))
            losses = {k: float(v) for k, v in losses.items()}
            agg = losses if agg is None else {k: agg[k] + losses[k] for k in agg}
            n += 1
        if agg:
            self._log("eval", {k: v / n for k, v in agg.items()}, epoch)


class TrainLoopTrajNet(_TrainLoop):
    """Reference train/training_loop_trajnet.py:16-153."""

    def __init__(
        self,
        model,
        sched_train: DiffusionSchedule,
        sched_eval: DiffusionSchedule,
        train_dataset,
        test_dataset,
        body_model,
        loss_weights: dict,
        logdir: str,
        device,
        batch_size: int = 64,
        lr: float = 1e-4,
        weight_decay: float = 0.0,
        num_steps: int = 100,
        log_interval: int = 100,
        save_interval: int = 25000,
        start_infill_epoch: int = 10**9,
        mask_prob: float = 0.0,
        max_infill_ratio: float = 0.0,
        repr_abs_only: bool = True,
        trajcontrol: bool = False,
        trainable: dict | None = None,
        writer=None,
        seed: int = 0,
        run_logger=None,
        save_optimizer: bool = False,
        mesh: DataMesh | None = None,
    ):
        self.model = model
        self.mesh = mesh
        self.logger = run_logger or logger
        self.save_optimizer = save_optimizer
        self.train_dataset = train_dataset
        self.test_dataset = test_dataset
        self.batch_size = batch_size
        self.num_steps = num_steps
        self.log_interval = log_interval
        self.save_interval = save_interval
        self.start_infill_epoch = start_infill_epoch
        self.mask_prob = mask_prob
        self.max_infill_ratio = max_infill_ratio
        self.trajcontrol = trajcontrol
        self.logdir = logdir
        self.writer = writer
        self.repr_abs_only = repr_abs_only
        self.traj_feat_dim = train_dataset.traj_feat_dim
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        self.state: TrainState = create_train_state(model, lr, weight_decay, trainable)
        mean = torch.as_tensor(train_dataset.mean, device=self.device)
        std = torch.as_tensor(train_dataset.std, device=self.device)
        self.train_step = make_trajnet_train_step(
            model, sched_train, mean, std, body_model, loss_weights, repr_abs_only, self.traj_feat_dim,
            mesh,
        )
        self.sampler = make_trajnet_sampler(model, sched_eval, self.traj_feat_dim, mesh)
        self.eval_loss_fn = lambda out, clean: trajnet_losses(
            out, clean, mean, std, body_model, loss_weights, repr_abs_only
        )
        self.step = 0

    def step_batch(self, batch: dict, epoch: int) -> dict:
        """A loader batch -> the step's device batch: the infill curriculum
        on the condition, and control_cond only for TrajControl."""
        cond = batch["cond"]
        # the short-circuit keeps the numpy stream in step with the JAX
        # loop's: no draw before start_infill_epoch
        if epoch >= self.start_infill_epoch and self.rng.uniform() > 1 - self.mask_prob:
            bs, clip_len = cond.shape[:2]
            cond = cond * traj_infill_mask(self.rng, bs, clip_len, self.max_infill_ratio)[..., None]
        out = {"motion_repr_clean": self._to_device(batch["motion_repr_clean"]), "cond": self._to_device(cond)}
        if self.trajcontrol:
            out["control_cond"] = self._to_device(batch["control_cond"])
        return out

    def _train_batch(self, batch: dict, epoch: int) -> dict:
        step_batch = shard_batch(self.step_batch(batch, epoch), self.mesh)
        self.state, losses = self.train_step(self.state, step_batch, self.generator)
        return losses

    def _eval_sample(self, batch: dict, epoch: int) -> torch.Tensor:
        cc = self._rows(batch["control_cond"]) if self.trajcontrol else None
        return self.sampler(self._rows(batch["cond"]), self.generator, cc)


class TrainLoopPoseNet(_TrainLoop):
    """Reference train/training_loop_posenet.py:15-303."""

    def __init__(
        self,
        model,
        sched_train: DiffusionSchedule,
        sched_eval: DiffusionSchedule,
        train_dataset,
        test_dataset,
        body_model,
        loss_weights: dict,
        logdir: str,
        device,
        batch_size: int = 64,
        lr: float = 1e-4,
        weight_decay: float = 0.0,
        num_steps: int = 100,
        log_interval: int = 100,
        save_interval: int = 25000,
        input_noise: bool = True,
        start_prox_mask_epoch: int = 10**9,
        start_skating_loss_epoch: int = 0,
        mask_scheme: str = "lower",
        prox_mask_bank: np.ndarray | None = None,
        writer=None,
        seed: int = 0,
        run_logger=None,
        save_optimizer: bool = False,
        fused_train: str = "",
        mesh: DataMesh | None = None,
    ):
        self.model = model
        self.mesh = mesh
        self.logger = run_logger or logger
        self.save_optimizer = save_optimizer
        self.train_dataset = train_dataset
        self.test_dataset = test_dataset
        self.batch_size = batch_size
        self.num_steps = num_steps
        self.log_interval = log_interval
        self.save_interval = save_interval
        self.input_noise = input_noise
        self.start_prox_mask_epoch = start_prox_mask_epoch
        self.start_skating_loss_epoch = start_skating_loss_epoch
        self.mask_scheme = mask_scheme
        self.prox_mask_bank = prox_mask_bank
        self.logdir = logdir
        self.writer = writer
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        self.state: TrainState = create_train_state(model, lr, weight_decay)
        self._skating: dict = {}  # the skating gate's device tensors, by value
        mean = torch.as_tensor(train_dataset.mean, device=self.device)
        std = torch.as_tensor(train_dataset.std, device=self.device)
        self.train_step = make_posenet_train_step(
            model, sched_train, mean, std, body_model, loss_weights, fused_train, mesh
        )
        self.sampler = make_posenet_sampler(model, sched_eval, mesh=mesh)
        self.eval_loss_fn = lambda out, clean: posenet_losses(
            out, clean, mean, std, body_model, loss_weights
        )
        self.step = 0

    def _make_cond(self, batch, epoch, train=True) -> np.ndarray:
        """Condition = (noisy|clean) repr x curriculum visibility mask."""
        cond = (
            batch["motion_repr_noisy"] if self.input_noise else batch["motion_repr_clean"]
        ).copy()
        bs, clip_len = cond.shape[:2]
        if train:
            vis = posenet_train_cond_mask(
                self.rng, bs, clip_len, epoch, self.start_prox_mask_epoch,
                self.mask_scheme, self.prox_mask_bank, self.input_noise,
            )
        else:
            vis = posenet_eval_cond_mask(self.rng, bs, clip_len, self.input_noise)
        return cond * vis

    def _train_batch(self, batch: dict, epoch: int) -> dict:
        active = epoch >= self.start_skating_loss_epoch
        if active not in self._skating:  # one host-to-device copy per value of the gate
            self._skating[active] = torch.tensor(float(active), device=self.device)
        skating = self._skating[active]
        step_batch = {
            "motion_repr_clean": self._rows(batch["motion_repr_clean"]),
            "cond": self._rows(self._make_cond(batch, epoch, train=True)),
        }
        self.state, losses = self.train_step(self.state, step_batch, self.generator, skating)
        return losses

    def _eval_sample(self, batch: dict, epoch: int) -> torch.Tensor:
        return self.sampler(self._rows(self._make_cond(batch, epoch, train=False)), self.generator)
