"""RoHM's PROX/EgoBody inference of one batch (`prox_rgb.yaml`), plain
PyTorch.

Builds on the frozen reference pipeline (pipeline.py: the chains, the
bridge, the condition assembly, one step from any state) with the settings
of the video configuration:
  - iteration 2 conditioned on iteration 1's outputs
    (iter2_cond_noisy_traj and iter2_cond_noisy_pose False): TrajControl
    on chain 0's trajectory, PoseNet on chain 1's pose;
  - the data's per-window visibility masks ([B, T-2, 294]) on PoseNet's
    condition in iteration 1, as the 'video' scheme gives them;
  - each PoseNet chain early-stopped: of its 1,000 steps the last 20 are
    left out, so steps t = 999 .. 20 run (980) and the chain's answer is
    the last step's pred_x0; TrajNet's chains run to t = 0;
  - the guidance on the PoseNet chains: the 2-D reprojection (3e5) and the
    foot skating (1e5), both at t <= 100 (reprojection.py).
Every draw comes from the generator in the port's order: per chain x_T,
then one draw of the whole batch per step that runs (the last step of an
early-stopped chain draws too).

Everything runs in f32 with TF32 off: importing reprojection.py sets
torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
to False, and drivers/prox.py's run_checks holds them so around the
reference (the controls switch them on, everywhere or in the PoseNet
alone).

Departures from the published code: the batch holds windows of several
recordings, each with its own camera; the reprojection's mean is over the
whole batch, as the paper's loss is over its batch.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from .gaussian import p_sample_step
from .pipeline import Chain, ReferencePipeline
from .reprojection import prox_guidance
from .sampler import _guidance_shift

# the batch's guidance inputs, in prox_guidance's order
CAMERA_KEYS = ("transf_matrix", "cam_r", "cam_t", "focal_length", "camera_center", "keypoints_2d")


def last_step(index: int, early_stop_steps: int) -> int:
    """The last step t that chain `index` runs: the PoseNet chains (odd)
    stop early_stop_steps before 0."""
    return early_stop_steps if index % 2 else 0


@dataclass
class ProxReferencePipeline(ReferencePipeline):
    """ReferencePipeline with the PROX guidance and early stop; build it with
    guided=False (the base's guidance is the AMASS one), mask_scheme
    'video', iter2_cond_noisy_traj and iter2_cond_noisy_pose False."""

    prox_guided: bool = True
    early_stop_steps: int = 20

    def chain(self, index: int, inputs: dict, outputs: dict) -> Chain:
        """Chain `index` given the batch's inputs (the base's, pose_mask the
        per-window mask, and the CAMERA_KEYS) and the answers of the chains
        before it."""
        c = super().chain(index, inputs, outputs)
        if index % 2 and self.prox_guided:
            c = replace(c, guidance=prox_guidance(self.mean, self.std, self.body_model,
                                                  *(inputs[k] for k in CAMERA_KEYS)))
        return c

    @torch.no_grad()
    def run_batch(self, inputs: dict, generator: torch.Generator):
        """The whole batch -> (PoseNet answer [B,T-2,294], TrajNet output [B,T-1,13])."""
        outputs = {}
        for index in range(2 * self.sample_iter):
            c = self.chain(index, inputs, outputs)
            outputs[index] = sample(c, generator, last_step(index, self.early_stop_steps))
        return outputs[2 * self.sample_iter - 1], outputs[2 * self.sample_iter - 2]


def sample(chain: Chain, generator: torch.Generator, stop: int) -> torch.Tensor:
    """The chain from t = T-1 down to t = stop: x_{stop-1} where stop is 0,
    else the last step's pred_x0 (early stop)."""
    def randn():
        return torch.randn(tuple(chain.shape), generator=generator, device=generator.device, dtype=torch.float32)

    sched = chain.sched
    tmap = sched.timestep_map.tolist()
    x = randn()
    pred = x
    for t in range(sched.num_timesteps - 1, stop - 1, -1):
        pred = chain.model_fn(x, tmap[t])
        shift = _guidance_shift(chain.guidance, pred, t, sched.posterior_variance[t]) if chain.guidance else None
        x = p_sample_step(sched, pred, x, t, noise=randn(), mean_shift=0.0 if shift is None else shift)
    return pred if stop else x


def replay_draws(generator: torch.Generator, chains: list[tuple[tuple, int, int]], wanted: set) -> dict:
    """The generator's draws in the port's order for chains given as (shape,
    steps, last step): per chain x_T (key (chain, steps)) then one per step
    t = steps-1 .. last (key (chain, t)). Returns the wanted keys' draws."""
    out = {}
    for ci, (shape, steps, stop) in enumerate(chains):
        for key in [(ci, steps)] + [(ci, t) for t in range(steps - 1, stop - 1, -1)]:
            d = torch.randn(tuple(shape), generator=generator, device=generator.device, dtype=torch.float32)
            if key in wanted:
                out[key] = d
    return out
