"""The whole inference slice without guidance, fused_posenet "bf16" and
"int8": the port's plain versions of the kernels against the JAX pipeline
running its Pallas kernels in interpret mode, on the CPU (setup in
test_torch_pipeline.py)."""

import pytest

from test_torch_pipeline import check_run_batch_matches_jax


@pytest.mark.parametrize("fused, pose_max, pose_mean", [("bf16", 0.25, 1e-2), ("int8", 0.5, 2e-2)])
def test_run_batch_matches_jax_unguided(fused, pose_max, pose_mean):
    """Without guidance the chain is smooth: what is left is the f32 GEMM
    summation order flipping activation roundings (bf16 2^-8 relative, or
    one int8 step), carried through 2 x 8 PoseNet and 2 x 5 TrajNet steps."""
    check_run_batch_matches_jax(fused, guided=False, pose_max=pose_max, pose_mean=pose_mean)
