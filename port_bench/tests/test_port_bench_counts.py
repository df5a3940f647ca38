"""The frozen operation and byte counts against hand counts."""

import pytest
import torch
from harness import counts

from reference.trajnet import TrajNet


def test_posenet_layer_by_hand():
    # one layer at 64 clips x 144 tokens, d 512, ff 1024:
    # 2 * 9216 * (3*512*512 + 512*512 + 2*512*1024) = 38.65 GFLOP of products,
    # 4 * 64 * 144^2 * 512 = 2.72 GFLOP of attention
    prod, att = counts.posenet_layer_ops(64 * 144, 64, 144)
    assert prod == 2 * 9216 * (3 * 512 * 512 + 512 * 512 + 2 * 512 * 1024) == pytest.approx(38.65e9, rel=1e-3)
    assert att == 4 * 64 * 144**2 * 512 == pytest.approx(2.72e9, rel=1e-3)


def test_kernel_lists():
    int8 = counts.posenet_kernel_launches("int8", 64)
    f32 = counts.posenet_kernel_launches("f32", 64)
    assert len(int8) == 1 + 9 * 8 and len(f32) == 7 * 8
    # the QKV product's bytes: A codes, row scales, weight codes, column
    # scales and bias, bf16 output
    m = 64 * 144
    assert int8[1] == ("gemm_int8", 2.0 * m * 512 * 1536, m * 512 + 4 * m + 512 * 1536 + 8 * 1536 + 2 * m * 1536, "int8")
    ops = sum(o for k, o, _, _ in int8 if k == "gemm_int8")
    assert ops == 8 * counts.posenet_layer_ops(m, 64, 144)[0]


@pytest.mark.parametrize("trajcontrol", [False, True])
def test_trajnet_count_matches_torchs_counter(trajcontrol):
    from torch.utils.flop_counter import FlopCounterMode

    net = TrajNet(mid_dim=64, trajcontrol=trajcontrol)
    x, c, cc = torch.randn(2, 32, 13), torch.randn(2, 32, 13), torch.randn(2, 32, 272)
    with FlopCounterMode(display=False) as fc:
        net(x, c, 5, control_cond=cc if trajcontrol else None)
    assert fc.get_total_flops() == counts.trajnet_ops(2, 32, 64, trajcontrol=trajcontrol)


def test_least_time_takes_the_larger_bound():
    assert counts.least_seconds(1979e12, 0, "int8") == pytest.approx(1.0)
    assert counts.least_seconds(0, 3.35e12, "f32") == pytest.approx(1.0)


def _roofline_ctx(names: dict, forwards: int = 3):
    bounds = counts.posenet_kernel_launches("f32", 2, seq=16, d=64, f=128, layers=1)
    per = {}
    for kernel, *_ in bounds:
        per[kernel] = per.get(kernel, 0) + forwards
    trace = {"kernel_launches": {names.get(k, k): n for k, n in per.items()},
             "kernel_seconds": {names.get(k, k): 1e-3 * n for k, n in per.items()}}
    return {"kernel_bounds": bounds, "trace": trace, "forwards": forwards,
            "port_launches": {f"{k}.launches": n for k, n in per.items()}}


def test_roofline_reads_only_the_counted_launches():
    from harness import spec

    reader = spec.metric_reader("port_kernels_roofline")
    trace_names = {"gemm_f32": "f32g::gemm_kernel", "attention_f32": "attention_f32_kernel",
                   "residual_layernorm": "residual_layernorm_kernel"}
    value = reader.read(_roofline_ctx(trace_names))
    assert value is not None and 0 < value <= 100
    # a kernel renamed in the trace, or launched more often than counted, reads nothing
    assert reader.read(_roofline_ctx(trace_names | {"gemm_f32": "f32g::gemm_kernel_v2"})) is None
    ctx = _roofline_ctx(trace_names)
    ctx["port_launches"]["attention_f32.launches"] += 1
    assert reader.read(ctx) is None
