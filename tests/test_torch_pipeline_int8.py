"""The whole inference slice with the shipped guidance and
fused_posenet="int8": the port's plain versions of the int8 kernels
against the JAX pipeline running its Pallas kernel in interpret mode, on
the CPU (setup in test_torch_pipeline.py)."""

from test_torch_pipeline import check_run_batch_matches_jax


def test_run_batch_matches_jax_int8_guided():
    """With the shipped guidance the tail is knife-edge: the skating loss
    thresholds contact (> 0.5) and foot speed (> 0.1 m/s), so a rounding
    flip can switch a foot's term on or off at weight 3e6. The JAX pipeline
    itself moves by max 1.2 between its jit and op-by-op runs, and by max
    1.9 / mean 0.16 between its bf16 and f32 modes, with outputs up to |120|.
    So the gate is on the mean, at half the output's mean magnitude (0.84),
    and the max stays under the output's own range."""
    check_run_batch_matches_jax("int8", guided=True, pose_max=60.0, pose_mean=0.42)
