"""AMASS test-time guidance: foot skating on the model's predicted x0.

The port of the AMASS half of rohm_tpu/models/guidance.py. The sampler
differentiates `skating_loss_fn` with torch.autograd.grad wrt pred_x0; the
gradient is masked to zero on the trajectory dims [:22] and the contact
dims [-4:] (reference posenet.py:251-252). Weight 3e6, active at t <= 50
(gaussian_diffusion_posenet.py:461-477).
"""

from __future__ import annotations

import torch

from rohm_tpu_torch.body.model import SmplxModel
from rohm_tpu_torch.diffusion.sampler import GuidanceSpec
from rohm_tpu_torch.models.losses import foot_skating_loss
from rohm_tpu_torch.reprs.decode import recover_from_repr
from rohm_tpu_torch.reprs.schema import BODY_FEAT_DIM, TRAJ_FEAT_DIM_FULL, split_repr

AMASS_SKATING_WEIGHT = 3e6
AMASS_SKATING_T_THRESH = 50


def guidance_grad_mask(device, dtype=torch.float32) -> torch.Tensor:
    """[294] mask: 0 on traj dims and contact dims, 1 elsewhere."""
    m = torch.ones(BODY_FEAT_DIM, dtype=dtype, device=device)
    m[:TRAJ_FEAT_DIM_FULL] = 0.0
    m[-4:] = 0.0
    return m


def skating_loss_fn(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                    body_model: SmplxModel) -> torch.Tensor:
    """Foot-skating guidance loss on a normalized repr x [B, T, 294].

    Contact labels come from x itself, thresholded at 0.5 and detached; the
    loss sums skating over the abs-traj and SMPL-X joint decodings
    (posenet.py:220-248).
    """
    dn = x * std + mean
    d = split_repr(dn)
    contact = (dn[..., -4:] > 0.5).to(x.dtype).detach()
    j_abs = recover_from_repr(d, mode="joint_abs_traj")
    j_smpl = recover_from_repr(d, mode="smplx_params", body_model=body_model)
    return foot_skating_loss(j_abs, contact) + foot_skating_loss(j_smpl, contact)


def amass_guidance(mean, std, body_model) -> tuple[GuidanceSpec, ...]:
    """Guidance stack for AMASS evaluation (skating only)."""
    return (
        GuidanceSpec(
            loss_fn=lambda x: skating_loss_fn(x, mean, std, body_model),
            weight=AMASS_SKATING_WEIGHT,
            t_threshold=AMASS_SKATING_T_THRESH,
            grad_mask=guidance_grad_mask(mean.device),
        ),
    )
