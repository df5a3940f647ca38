"""Visualization and rendering: the port of rohm_tpu/viz/, optional extras.

open3d, pyrender, trimesh and PIL are not part of the port's stack; every
entry point imports what it needs when called and raises the JAX package's
ImportError where it is absent. Parity targets: reference
utils/vis_util.py, utils/render_util.py, and the visualization branches of
the eval scripts.
"""

from rohm_tpu_torch.viz.skeleton import LIMBS_BODY_SMPL
from rohm_tpu_torch.viz.results import (
    animate_skeletons,
    render_amass_results,
    render_prox_overlay,
    visualize_amass_results,
)

__all__ = [
    "LIMBS_BODY_SMPL",
    "visualize_amass_results",
    "render_amass_results",
    "render_prox_overlay",
    "animate_skeletons",
]
