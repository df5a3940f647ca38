"""Motion representation: the 294-d schema, encoder and decoder."""

from rohm_tpu_torch.reprs.canonicalize import cano_seq_smplx, cano_seq_smplx_egobody, update_global_rt
from rohm_tpu_torch.reprs.decode import recover_from_repr, recover_root_rot_pos, repr_to_smplx_params
from rohm_tpu_torch.reprs.encode import get_repr
from rohm_tpu_torch.reprs.schema import (
    BODY_FEAT_DIM,
    FOOT_JOINT_INDEX,
    POSE_FEAT_DIM,
    REPR_DIM_DICT,
    REPR_LIST,
    TRAJ_ABS_INDEX,
    TRAJ_FEAT_DIM_ABS,
    TRAJ_FEAT_DIM_FULL,
    block_slice,
    scatter_traj_abs,
    split_repr,
)
from rohm_tpu_torch.reprs.stats import compute_stats, load_stats, save_stats

__all__ = [
    "BODY_FEAT_DIM",
    "FOOT_JOINT_INDEX",
    "POSE_FEAT_DIM",
    "REPR_DIM_DICT",
    "REPR_LIST",
    "TRAJ_ABS_INDEX",
    "TRAJ_FEAT_DIM_ABS",
    "TRAJ_FEAT_DIM_FULL",
    "block_slice",
    "scatter_traj_abs",
    "split_repr",
    "get_repr",
    "recover_from_repr",
    "recover_root_rot_pos",
    "repr_to_smplx_params",
    "cano_seq_smplx",
    "cano_seq_smplx_egobody",
    "update_global_rt",
    "compute_stats",
    "load_stats",
    "save_stats",
]
