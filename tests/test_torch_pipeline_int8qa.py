"""The whole inference slice with the shipped guidance and
fused_posenet="int8qa" (W8A8 layers with int8 attention): the port's plain
versions of the int8 kernels against the JAX pipeline running its Pallas
kernel (qattn=True) in interpret mode, on the CPU (setup in
test_torch_pipeline.py)."""

from test_torch_pipeline import check_run_batch_matches_jax


def test_run_batch_matches_jax_int8qa_guided():
    """The argument of the int8 test (test_torch_pipeline_int8.py) holds
    here too: a flipped int8 code (now also a prob code of the attention,
    1/127 of a prob) can switch a skating-loss term on or off at weight 3e6,
    and the JAX pipeline itself moves by max 1.9 / mean 0.16 between its
    bf16 and f32 modes with outputs up to |120|. So the gate is on the mean,
    at half the output's mean magnitude (0.85), and the max stays under the
    output's own range (measured max 16.4, mean 0.36)."""
    check_run_batch_matches_jax("int8qa", guided=True, pose_max=60.0, pose_mean=0.42)
