"""The RoHM iterative inference pipeline, in eager PyTorch.

The port of rohm_tpu/pipeline.py (reference test_amass_full.py:200-385 and
test_prox_egobody.py:185-324).
Per batch (sample_iter, default 2):
  iter 0: vanilla TrajNet sample -> bridge -> PoseNet guided sample
  iter 1: TrajControl TrajNet (control_cond = PoseNet output pose dims,
          last frame duplicated) -> bridge -> PoseNet guided sample
The bridge decodes the TrajNet output, runs SMPL-X forward kinematics and
re-encodes it (decode -> FK -> get_repr -> renormalize).

Guidance: grad_type "amass" (foot skating) or "prox" (PROX/EgoBody: 2-D
keypoint reprojection + skating, on the cameras and keypoints a batch's
`guidance_data` carries); None runs none. mask_scheme "video" means the
caller hands the real per-frame visibility masks of the data.

PoseNet runs through the hand-written Hopper kernels when `fused_posenet`
is True/"bf16" (bf16 layers), "int8" (W8A8 layers), "int8qa" (W8A8 layers
with quantized attention) or "f32" (f32 layers on the raw weights).

Data parallelism (`mesh`, rohm_tpu/pipeline.py:147): run_batch takes the
global batch on every rank, runs this rank's rows through both iterations
(the PoseNet chain on this rank's card, through its mode's kernels), draws
every noise tensor at the global shape and keeps its rows, takes the
guidance losses over the global batch, and returns the global outputs on
every rank. The "f32" mode refuses a mesh, as in the JAX package.

Spans (utils/profiling.py, recorded only under a torch.profiler profile):
`batch` (the root) over run_batch, `chain.traj` and `chain.pose` (attribute
`iteration`) over each chain, `bridge` over each traj_to_pose_bridge call;
the sampler adds `step` and `guidance` inside the chains.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from rohm_tpu_torch.body.model import SmplxModel, forward_joints
from rohm_tpu_torch.diffusion.sampler import p_sample_loop
from rohm_tpu_torch.diffusion.schedule import DiffusionSchedule
from rohm_tpu_torch.geometry.rotations import rot6d_to_rotmat
from rohm_tpu_torch.models.guidance import amass_guidance, prox_guidance
from rohm_tpu_torch.models.losses import merge_traj_output
from rohm_tpu_torch.models.posenet import PoseNet
from rohm_tpu_torch.models.trajnet import TrajNet
from rohm_tpu_torch.parallel.mesh import DataMesh, gather_rows, shard_rows
from rohm_tpu_torch.reprs.encode import get_repr
from rohm_tpu_torch.reprs.schema import TRAJ_FEAT_DIM_FULL, split_repr
from rohm_tpu_torch.train.masking import UPPER_BODY_JOINTS, joint_mask_to_vec, lower_body_mask
from rohm_tpu_torch.utils.profiling import span

PRESET_NOISE_KEYS = ("traj_init", "traj_step", "pose_init", "pose_step")
# the per-batch inputs of the 'prox' guidance
GUIDANCE_DATA_KEYS = ("transf_matrix", "cam_r", "cam_t", "focal_length", "camera_center", "keypoints_2d")
# the batch axis of each preset_noise entry ([iter, (step,) B, ...]) and of
# the guidance inputs that have one (the camera pose cam_r, cam_t has none)
PRESET_NOISE_BATCH_AXIS = {"traj_init": 1, "traj_step": 2, "pose_init": 1, "pose_step": 2}
GUIDANCE_BATCH_KEYS = ("transf_matrix", "focal_length", "camera_center", "keypoints_2d")


def traj_to_pose_bridge(
    val_output_traj: torch.Tensor,  # [B, T, 13|22] normalized TrajNet output
    motion_repr_clean: torch.Tensor,  # [B, T, 294] normalized (pose part source)
    mean: torch.Tensor,
    std: torch.Tensor,
    body_model: SmplxModel,
    repr_abs_only: bool = True,
) -> torch.Tensor:
    """Rebuild the full 22-d trajectory (abs + velocities) from TrajNet output.

    Scatter -> denormalize -> SMPL-X decode -> re-encode through get_repr ->
    renormalize -> first 22 dims. Output has T-1 frames (re-encoding drops
    the last frame; reference test_amass_full.py:282-311).
    """
    full = merge_traj_output(motion_repr_clean, val_output_traj, repr_abs_only)
    dn = full * std + mean
    d = split_repr(dn)
    global_orient_mat = rot6d_to_rotmat(d["smplx_rot_6d"])  # [B, T, 3, 3]
    pose6d = d["smplx_body_pose_6d"]
    body_pose_mat = rot6d_to_rotmat(pose6d.reshape(pose6d.shape[:-1] + (21, 6)))
    joints = forward_joints(
        body_model, d["smplx_betas"], None, None, d["smplx_trans"], num_joints=22,
        global_orient_mat=global_orient_mat, body_pose_mat=body_pose_mat,
    )
    re_repr = get_repr(
        joints, transl=d["smplx_trans"], betas=d["smplx_betas"],
        global_orient_mat=global_orient_mat, body_pose_mat=body_pose_mat,
    )  # [B, T-1, 294]
    return ((re_repr - mean) / std)[..., :TRAJ_FEAT_DIM_FULL]


def amass_eval_pose_mask(
    mask_scheme: str,
    batch_size: int,
    clip_len: int,
    window_start: np.ndarray | None = None,
    window_len: int = 30,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Test-time occlusion mask [bs, T, 294] for the PoseNet condition
    (reference test_amass_full.py:336-368). 'full' masks a window per sample:
    fixed window_start, or a random start with window_len=30."""
    if mask_scheme == "lower":
        vis = joint_mask_to_vec(lower_body_mask(batch_size))
        vis = np.broadcast_to(vis[:, None, :], (batch_size, clip_len, vis.shape[-1])).copy()
    elif mask_scheme == "upper":
        masked = np.zeros((batch_size, 22), bool)
        masked[:, UPPER_BODY_JOINTS] = True
        vis = joint_mask_to_vec(masked)
        vis = np.broadcast_to(vis[:, None, :], (batch_size, clip_len, vis.shape[-1])).copy()
    elif mask_scheme == "full":
        if window_start is not None:
            start = np.broadcast_to(np.asarray(window_start), (batch_size,))
        elif rng is not None:
            start = rng.integers(0, clip_len - 1, size=batch_size)
        else:
            start = np.full(batch_size, 65)
        end = np.minimum(start + window_len, clip_len)
        t = np.arange(clip_len)
        inside = (t[None] >= start[:, None]) & (t[None] < end[:, None])
        vis = np.ones((batch_size, clip_len, 294), np.float32)
        vis[..., TRAJ_FEAT_DIM_FULL:] *= (~inside)[..., None]
    else:
        raise ValueError(f"bad mask_scheme {mask_scheme}")
    vis[..., -4:] = 0.0
    return vis.astype(np.float32)


def _full_f32() -> None:
    """cuDNN runs f32 convolutions in TF32 by default, which keeps ~3
    digits; over a 100-step TrajNet chain that difference matters, so every
    f32 product and convolution of the pipeline runs in full f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass
class RohmPipeline:
    """The three models + schedules + stats, run batch by batch."""

    trajnet: TrajNet  # trajcontrol=False
    trajcontrol: TrajNet | None  # trajcontrol=True; needed when sample_iter > 1
    posenet: PoseNet
    sched_traj: DiffusionSchedule
    sched_pose: DiffusionSchedule
    body_model: SmplxModel
    mean: torch.Tensor  # [294], on the device the pipeline runs on
    std: torch.Tensor  # [294]
    repr_abs_only: bool = True
    traj_feat_dim: int = 13
    sample_iter: int = 2
    early_stop: bool = False
    early_stop_steps: int = 20
    grad_type: str | None = "amass"  # None disables guidance
    mask_scheme: str = "lower"
    input_noise: bool = True
    iter2_cond_noisy_pose: bool = False
    iter2_cond_noisy_traj: bool = False
    infill_traj: bool = False
    guidance_override: tuple | None = None
    # PoseNet on the hand-written kernels: False = plain module, True/"bf16" =
    # bf16 layers (accuracy mode), "int8" = W8A8 layers (throughput mode),
    # "int8qa" = W8A8 layers with int8 attention, "f32" = f32 layers
    fused_posenet: bool | str = False
    # data parallelism: this process is one rank of the mesh (parallel/)
    mesh: DataMesh | None = None
    _prepared_posenet: dict | None = field(default=None, init=False, repr=False)

    def __post_init__(self):
        if self.fused_posenet not in (False, True, "bf16", "int8", "int8qa", "f32"):
            raise ValueError(
                f"fused_posenet={self.fused_posenet!r}: expected False, True, 'bf16', "
                "'int8', 'int8qa' or 'f32'"
            )
        if self.mesh is not None and self.fused_posenet == "f32":
            # as in the JAX package, whose f32 kernel path has no per-shard wrapper
            raise ValueError("fused_posenet='f32' does not support a mesh; use 'bf16'/'int8'")
        if self.grad_type not in (None, "amass", "prox"):
            raise ValueError(f"grad_type={self.grad_type!r}: expected None, 'amass' or 'prox'")
        _full_f32()

    @property
    def device(self) -> torch.device:
        return self.mean.device

    def _ensure_prepared(self) -> dict:
        """One-time cast/quantization of the PoseNet weights."""
        if self._prepared_posenet is None:
            from rohm_tpu_torch.ops import prepare_posenet_fused, prepare_posenet_int8

            if self.fused_posenet in ("int8", "int8qa"):
                prep = prepare_posenet_int8(self.posenet, qattn=self.fused_posenet == "int8qa")
            else:
                prep = prepare_posenet_fused(self.posenet)
            self._prepared_posenet = prep
        return self._prepared_posenet

    def _guidance(self, guidance_data: dict | None = None):
        guidance_data = guidance_data or {}
        if self.guidance_override is not None:
            return self.guidance_override
        if self.grad_type == "amass":
            return amass_guidance(self.mean, self.std, self.body_model, self.mesh)
        if self.grad_type == "prox":
            missing = [k for k in GUIDANCE_DATA_KEYS if k not in guidance_data]
            if missing:
                raise ValueError(f"grad_type='prox' needs guidance_data with {missing}")
            return prox_guidance(self.mean, self.std, self.body_model,
                                 *(guidance_data[k] for k in GUIDANCE_DATA_KEYS), mesh=self.mesh)
        return ()

    def _pose_model_fn(self, cond: torch.Tensor):
        if not self.fused_posenet:
            return lambda x, tt: self.posenet(x, cond, tt)
        if self.fused_posenet == "f32":
            # the f32 layers take the module's raw weights, as the JAX
            # package's f32 path takes the raw param tree
            from rohm_tpu_torch.ops import embed_cond_f32, posenet_apply_fused

            cond_emb = embed_cond_f32(self.posenet, cond)  # hoisted out of the loop
            return lambda x, tt: posenet_apply_fused(self.posenet, x, cond, tt, cond_emb=cond_emb)
        from rohm_tpu_torch.ops import embed_cond, posenet_apply_prepared

        prep = self._ensure_prepared()
        cond_emb = embed_cond(prep, cond)  # hoisted out of the 1000-step loop

        def fn(x, tt):
            return posenet_apply_prepared(
                prep, x, cond, tt, num_heads=self.posenet.num_heads,
                traj_feat_dim=self.posenet.traj_feat_dim, cond_emb=cond_emb,
            )

        return fn

    def _run(self, traj_cond, traj_clean, pose_noisy, pose_mask, traj_mask,
             generator: torch.Generator, guidance_data: dict, preset_noise: dict):
        """Returns (posenet output [B,143,294], traj output [B,144,traj_feat_dim]).

        guidance_data: the 'prox' guidance's tensors on the pipeline's
        device (GUIDANCE_DATA_KEYS), else empty.

        preset_noise: any subset of traj_init [I,B,144,tf],
        traj_step [I,S_traj,B,144,tf], pose_init [I,B,143,294],
        pose_step [I,S_pose,B,143,294]; absent keys sample from `generator`.
        """
        mean, std = self.mean, self.std
        guidance = self._guidance(guidance_data)
        early = self.early_stop_steps if self.early_stop else 0
        b, t_traj = traj_cond.shape[0], traj_cond.shape[1]
        t_pose = t_traj - 1

        val_output_pose = None
        val_output_traj = None
        cur_traj_cond = traj_cond
        for iter_idx in range(self.sample_iter):
            pn = {k: v[iter_idx] for k, v in preset_noise.items()}
            traj_kw = {kw: pn["traj" + sfx] for kw, sfx in (("noise", "_init"), ("step_noise", "_step"))
                       if "traj" + sfx in pn}
            pose_kw = {kw: pn["pose" + sfx] for kw, sfx in (("noise", "_init"), ("step_noise", "_step"))
                       if "pose" + sfx in pn}
            if iter_idx == 0:
                def traj_fn(x, tt, c=cur_traj_cond):
                    return self.trajnet(x, c, tt)
            else:
                if self.iter2_cond_noisy_traj and self.infill_traj:
                    # visible noisy + predicted for occluded (test_amass_full.py:233-237)
                    cur_traj_cond = traj_cond * traj_mask[..., None] + val_output_traj * (
                        1.0 - traj_mask[..., None]
                    )
                elif not self.iter2_cond_noisy_traj:
                    # condition on the previous iteration's prediction
                    cur_traj_cond = val_output_traj
                # control_cond: PoseNet pose dims, last frame duplicated
                cc = val_output_pose[..., -272:]
                control_cond = torch.cat([cc, cc[:, -1:, :]], dim=1)  # [B,144,272]

                def traj_fn(x, tt, c=cur_traj_cond, cc=control_cond):
                    return self.trajcontrol(x, c, tt, control_cond=cc)

            with span("chain.traj", "iteration", iter_idx):
                val_output_traj = p_sample_loop(
                    traj_fn, self.sched_traj, (b, t_traj, self.traj_feat_dim), generator,
                    mesh=self.mesh, **traj_kw,
                )
            with span("bridge"):
                traj_rec_full = traj_to_pose_bridge(
                    val_output_traj, traj_clean, mean, std, self.body_model, self.repr_abs_only
                )  # [B, 143, 22]

            # PoseNet condition assembly (test_amass_full.py:318-333)
            if self.input_noise and not (self.iter2_cond_noisy_pose or iter_idx == 0):
                cond = val_output_pose
            else:
                cond = pose_noisy[:, :t_pose]
            if not (self.mask_scheme == "lower" and not self.input_noise):
                cond = torch.cat([traj_rec_full, cond[..., TRAJ_FEAT_DIM_FULL:]], dim=-1)
            mask_iter_num = self.sample_iter if self.iter2_cond_noisy_pose else 1
            if iter_idx < mask_iter_num:
                # one mask per iteration: the reference redraws the random
                # full-body window inside each iteration
                cond = cond * pose_mask[iter_idx]

            with span("chain.pose", "iteration", iter_idx):
                val_output_pose = p_sample_loop(
                    self._pose_model_fn(cond), self.sched_pose, (b, t_pose, cond.shape[-1]),
                    generator, guidance=guidance, early_stop_steps=early, mesh=self.mesh, **pose_kw,
                )
        return val_output_pose, val_output_traj

    def run_batch(self, traj_cond, traj_clean, pose_noisy, pose_mask, traj_mask,
                  generator: torch.Generator, guidance_data: dict | None = None,
                  preset_noise: dict | None = None):
        """One batch; array arguments as numpy arrays or tensors. `generator`
        draws all noise that `preset_noise` does not replay (see _run).
        guidance_data carries the 'prox' guidance's per-batch inputs
        (GUIDANCE_DATA_KEYS: transf_matrix [B,4,4], cam_r [3,3], cam_t [3],
        focal_length [B,2], camera_center [B,2], keypoints_2d [B,T,22,3]);
        they move to the pipeline's device once per batch. Under a mesh
        every argument is the global batch and so are the outputs. The
        whole call is the root span `batch`."""
        with span("batch", root=True):
            _full_f32()  # again per batch: a resident pipeline outlives the switches its process set
            dev = self.device

            def as_t(a):
                return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                                       dtype=torch.float32, device=dev)

            pn = dict(preset_noise or {})
            unknown = set(pn) - set(PRESET_NOISE_KEYS)
            if unknown:
                raise ValueError(
                    f"unknown preset_noise key(s) {sorted(unknown)}; "
                    f"valid keys: {sorted(PRESET_NOISE_KEYS)} (any subset — absent keys "
                    "fall back to generator sampling)"
                )
            pn = {k: as_t(v) for k, v in pn.items()}
            gd = {k: as_t(v) for k, v in (guidance_data or {}).items()}
            pm = as_t(pose_mask)
            if pm.dim() == 3:  # one mask for every iteration
                pm = pm.expand((self.sample_iter,) + tuple(pm.shape))
            mesh = self.mesh
            if mesh is not None:  # this rank's rows; the mask's batch axis is 1
                pn = {k: shard_rows(v, mesh, PRESET_NOISE_BATCH_AXIS[k]) for k, v in pn.items()}
                gd = {k: shard_rows(v, mesh) if k in GUIDANCE_BATCH_KEYS else v for k, v in gd.items()}
                pm = shard_rows(pm, mesh, 1)
            rows = [shard_rows(as_t(a), mesh) for a in (traj_cond, traj_clean, pose_noisy)]
            pose, traj = self._run(*rows, pm, shard_rows(as_t(traj_mask), mesh), generator, gd, pn)
            return gather_rows(pose, mesh), gather_rows(traj, mesh)
