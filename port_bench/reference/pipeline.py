"""The RoHM iterative inference of one batch, plain PyTorch.

A frozen copy of rohm_tpu_torch/pipeline.py's `_run` and
`traj_to_pose_bridge` (single process, no preset noise), with PoseNet
through reference/denoisers.py in the mode the configuration states.
Per batch (sample_iter 2) four chains run in turn:
  0: TrajNet sample -> bridge -> 1: PoseNet guided sample
  2: TrajControl sample (control_cond = chain 1's pose dims, last frame
     duplicated) -> bridge -> 3: PoseNet guided sample
The bridge decodes a TrajNet output, runs SMPL-X forward kinematics and
re-encodes it. Every draw comes from the generator in the port's order: per
chain x_T, then one draw of the whole batch per step.

`chain_models` gives each chain's denoiser from the outputs of the chains
before it, so one step can be recomputed from any state (`step`), and
`run_batch` runs the whole batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .body import SmplxModel, forward_joints
from .denoisers import make_posenet_fn
from .encode import get_repr
from .gaussian import p_sample_step
from .guidance import amass_guidance
from .rotations import rot6d_to_rotmat
from .sampler import _guidance_shift, p_sample_loop
from .schedule import DiffusionSchedule
from .schema import TRAJ_FEAT_DIM_FULL, scatter_traj_abs, split_repr


def merge_traj_output(motion_repr_clean, model_output, repr_abs_only: bool):
    """Scatter TrajNet output back into a full 294-d repr (pose part from the clean input)."""
    if repr_abs_only:
        return scatter_traj_abs(motion_repr_clean, model_output)
    return torch.cat([model_output, motion_repr_clean[..., TRAJ_FEAT_DIM_FULL:]], dim=-1)


def traj_to_pose_bridge(val_output_traj, motion_repr_clean, mean, std, body_model: SmplxModel,
                        repr_abs_only: bool = True) -> torch.Tensor:
    """TrajNet output -> the 22-d trajectory of T-1 frames: scatter,
    denormalize, SMPL-X decode, re-encode, renormalize."""
    full = merge_traj_output(motion_repr_clean, val_output_traj, repr_abs_only)
    d = split_repr(full * std + mean)
    global_orient_mat = rot6d_to_rotmat(d["smplx_rot_6d"])
    pose6d = d["smplx_body_pose_6d"]
    body_pose_mat = rot6d_to_rotmat(pose6d.reshape(pose6d.shape[:-1] + (21, 6)))
    joints = forward_joints(body_model, d["smplx_betas"], None, None, d["smplx_trans"], num_joints=22,
                            global_orient_mat=global_orient_mat, body_pose_mat=body_pose_mat)
    re_repr = get_repr(joints, transl=d["smplx_trans"], betas=d["smplx_betas"],
                       global_orient_mat=global_orient_mat, body_pose_mat=body_pose_mat)
    return ((re_repr - mean) / std)[..., :TRAJ_FEAT_DIM_FULL]


@dataclass
class Chain:
    model_fn: object
    sched: DiffusionSchedule
    shape: tuple
    guidance: tuple


@dataclass
class ReferencePipeline:
    trajnet: torch.nn.Module
    trajcontrol: torch.nn.Module
    posenet: torch.nn.Module
    sched_traj: DiffusionSchedule
    sched_pose: DiffusionSchedule
    body_model: SmplxModel
    mean: torch.Tensor
    std: torch.Tensor
    posenet_mode: str  # "f32", "int8" or "int4"
    repr_abs_only: bool = True
    traj_feat_dim: int = 13
    sample_iter: int = 2
    guided: bool = True
    mask_scheme: str = "lower"
    input_noise: bool = True
    iter2_cond_noisy_pose: bool = True
    iter2_cond_noisy_traj: bool = True

    def chain(self, index: int, inputs: dict, outputs: dict) -> Chain:
        """Chain `index` (traj and pose chains alternate) given the batch's
        inputs (traj_cond, traj_clean, pose_noisy, pose_mask [B, T-2, 294])
        and the final outputs of the chains before it ({index: tensor})."""
        traj_cond = inputs["traj_cond"]
        b, t_traj = traj_cond.shape[0], traj_cond.shape[1]
        iter_idx, is_pose = divmod(index, 2)
        if not is_pose:
            if iter_idx == 0:
                return Chain(lambda x, tt: self.trajnet(x, traj_cond, tt), self.sched_traj,
                             (b, t_traj, self.traj_feat_dim), ())
            cur = traj_cond if self.iter2_cond_noisy_traj else outputs[index - 2]
            cc = outputs[index - 1][..., -272:]
            control_cond = torch.cat([cc, cc[:, -1:, :]], dim=1)
            return Chain(lambda x, tt: self.trajcontrol(x, cur, tt, control_cond=control_cond), self.sched_traj,
                         (b, t_traj, self.traj_feat_dim), ())
        t_pose = t_traj - 1
        traj_rec_full = traj_to_pose_bridge(outputs[index - 1], inputs["traj_clean"], self.mean, self.std,
                                            self.body_model, self.repr_abs_only)
        if self.input_noise and not (self.iter2_cond_noisy_pose or iter_idx == 0):
            cond = outputs[index - 2]
        else:
            cond = inputs["pose_noisy"][:, :t_pose]
        if not (self.mask_scheme == "lower" and not self.input_noise):
            cond = torch.cat([traj_rec_full, cond[..., TRAJ_FEAT_DIM_FULL:]], dim=-1)
        if iter_idx < (self.sample_iter if self.iter2_cond_noisy_pose else 1):
            cond = cond * inputs["pose_mask"]
        guidance = amass_guidance(self.mean, self.std, self.body_model) if self.guided else ()
        return Chain(make_posenet_fn(self.posenet, cond, self.posenet_mode), self.sched_pose,
                     (b, t_pose, cond.shape[-1]), guidance)

    @torch.no_grad()
    def step(self, chain: Chain, t: int, x_t: torch.Tensor, noise: torch.Tensor,
             guide_x0: torch.Tensor | None = None) -> torch.Tensor:
        """x_{t-1} from x_t: the denoiser, the guidance at its steps, the
        posterior step with this step's draw. The guidance's gradient is
        taken at guide_x0 where it is given (the program's pred_x0: its
        contact and speed thresholds then see the same values), else at
        the denoiser's own pred_x0."""
        pred = chain.model_fn(x_t, int(chain.sched.timestep_map[t]))
        at = pred if guide_x0 is None else guide_x0
        shift = _guidance_shift(chain.guidance, at, t, chain.sched.posterior_variance[t]) if chain.guidance else None
        return p_sample_step(chain.sched, pred, x_t, t, noise=noise, mean_shift=0.0 if shift is None else shift)

    @torch.no_grad()
    def run_batch(self, inputs: dict, generator: torch.Generator):
        """The whole batch -> (PoseNet output [B,T-2,294], TrajNet output [B,T-1,13])."""
        outputs = {}
        for index in range(2 * self.sample_iter):
            c = self.chain(index, inputs, outputs)
            outputs[index] = p_sample_loop(c.model_fn, c.sched, c.shape, generator, c.guidance)
        return outputs[2 * self.sample_iter - 1], outputs[2 * self.sample_iter - 2]


def replay_draws(generator: torch.Generator, chains: list[tuple[tuple, int]], wanted: set) -> dict:
    """The generator's draws in the port's order for chains given as (shape,
    steps): per chain x_T (draw key (chain, steps)) then one per step t =
    steps-1 .. 0 (key (chain, t), the draw that step t adds). Returns the
    wanted keys' draws."""
    out = {}
    for ci, (shape, steps) in enumerate(chains):
        for key in [(ci, steps)] + [(ci, t) for t in range(steps - 1, -1, -1)]:
            d = torch.randn(tuple(shape), generator=generator, device=generator.device, dtype=torch.float32)
            if key in wanted:
                out[key] = d
    return out
