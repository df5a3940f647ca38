"""SMPL-X joints and vertices in PyTorch."""

from rohm_tpu_torch.body.model import (
    NUM_BETAS,
    NUM_BODY_JOINTS,
    NUM_JOINTS,
    SMPLX_PARENTS,
    SmplxModel,
    forward_joints,
    forward_vertices,
    load_smplx_npz,
    synthetic_model,
)

__all__ = [
    "NUM_BETAS", "NUM_BODY_JOINTS", "NUM_JOINTS", "SMPLX_PARENTS", "SmplxModel",
    "forward_joints", "forward_vertices", "load_smplx_npz", "synthetic_model",
]
