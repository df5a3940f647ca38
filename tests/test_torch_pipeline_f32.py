"""The whole inference slice with the shipped guidance and
fused_posenet="f32": the port's plain versions of the f32 kernels (the
PoseNet on its raw weights) against the JAX pipeline running its f32 Pallas
kernel in interpret mode, on the CPU (setup in test_torch_pipeline.py)."""

from test_torch_pipeline import check_run_batch_matches_jax


def test_run_batch_matches_jax_f32_kernel_guided():
    """f32 on both sides, with the same two-pass LayerNorm and erf
    polynomial, so only summation order differs, and at that size no
    contact or velocity threshold of the skating loss flips: the gates of
    the plain f32 module's test (measured max 1.4e-4, mean 8.7e-7 on the
    pose)."""
    check_run_batch_matches_jax("f32", guided=True, pose_max=1e-2, pose_mean=1e-3)
