"""Models: the TrajNet U-Net (+ TrajControl branch) and the PoseNet encoder."""

from rohm_tpu_torch.models.posenet import PoseNet
from rohm_tpu_torch.models.trajnet import TrajNet

__all__ = ["TrajNet", "PoseNet"]
