"""The K8 probe's chained carry (rohm_tpu_torch.scripts.bench_int8_gemm_rows),
on the CPU through the skeleton's plain version.

The probe times chains of calls in which each call's output is the next
one's input. `build` divides each product's column scales by the square
root of its depth, so a call keeps its input's scale and the carry stays
finite over the chain; with the weights' own scales (N(0, 1) weights, as
the JAX script draws them) it overflows bf16 within a few calls.
"""

import torch

from rohm_tpu_torch.scripts import bench_int8_gemm_rows as k8

CALLS = 12


def _chain(weights, x):
    """The carry after each of CALLS chained plain calls."""
    ends = []
    for _ in range(CALLS):
        x = k8.gemm_skeleton(x, weights)
        ends.append(x)
    return ends


def test_chained_carry_stays_finite():
    weights, x = k8.build(1, "cpu")
    before = k8.gemm_skeleton.launches
    for i, y in enumerate(_chain(weights, x)):
        assert y.dtype == torch.bfloat16 and y.shape == x.shape
        assert torch.isfinite(y).all(), f"call {i + 1}: the carry is not finite"
        # each product keeps its input's scale: the carry stays within a
        # decade of the unit input
        assert 0.1 < y.float().std().item() < 10, (i, y.float().std().item())
    assert k8.gemm_skeleton.launches == before  # CPU tensors take the plain version


def test_unit_column_scales_overflow_the_chain():
    """The fault the scaling repairs: with the quantized N(0, 1) weights'
    own column scales the carry is not finite by the last call."""
    weights, x = k8.build(1, "cpu")
    depths = (k8.D, k8.D, k8.D, k8.F)
    unit = list(weights)
    for i, depth in enumerate(depths):
        unit[2 * i + 1] = weights[2 * i + 1] * depth ** 0.5
    assert not torch.isfinite(_chain(tuple(unit), x)[-1]).all()
