"""Motion representation: the 294-d schema, encoder and decoder."""

from rohm_tpu_torch.reprs.canonicalize import cano_seq_smplx, cano_seq_smplx_egobody, update_global_rt
from rohm_tpu_torch.reprs.decode import recover_from_repr
from rohm_tpu_torch.reprs.encode import get_repr
from rohm_tpu_torch.reprs.schema import (
    BODY_FEAT_DIM,
    REPR_DIM_DICT,
    REPR_LIST,
    TRAJ_FEAT_DIM_ABS,
    TRAJ_FEAT_DIM_FULL,
    scatter_traj_abs,
    split_repr,
)

__all__ = [
    "BODY_FEAT_DIM", "REPR_DIM_DICT", "REPR_LIST", "TRAJ_FEAT_DIM_ABS",
    "TRAJ_FEAT_DIM_FULL", "scatter_traj_abs", "split_repr", "get_repr",
    "recover_from_repr", "cano_seq_smplx", "cano_seq_smplx_egobody", "update_global_rt",
]
