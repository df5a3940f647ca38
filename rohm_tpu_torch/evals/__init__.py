"""Evaluation metrics: numpy post-processing of saved results."""

from rohm_tpu_torch.evals.metrics import (
    accel_error,
    contact_label_accuracy,
    ground_penetration,
    mpjpe_global,
    mpjpe_masked,
    skating_ratio,
    trajnet_root_errors,
)

__all__ = [
    "mpjpe_global",
    "mpjpe_masked",
    "contact_label_accuracy",
    "skating_ratio",
    "accel_error",
    "ground_penetration",
    "trajnet_root_errors",
]
