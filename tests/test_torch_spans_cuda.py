"""The port's spans on the card (utils/profiling.py): device stamps on the
profiler's clock, the sync counter, and what the spans leave in a
CUDA-only and in a CPU + CUDA profile. Every test needs an NVIDIA GPU
(`cuda` marker) and skips without one. On the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_spans_cuda.py
"""

import json
import os
import warnings

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from rohm_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
SLACK_NS = 50_000


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    profiling.take_spans()
    yield
    profiling.take_spans()


def test_kernel_inside_its_span_on_the_profilers_clock(card):
    """Under the benchmark's kind of profile (CUDA activity only): the
    launch call of the one kernel inside a span lies between the span's
    host stamps, and the kernel's interval inside the span's anchored
    device interval, within 50 us at each end."""
    x = torch.ones(64 << 20, device="cuda")
    y = torch.empty_like(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.span("batch", root=True):
            torch.cuda._sleep(2_000_000)  # the card runs behind the host
            with profiling.span("step", "t", 0):
                torch.mul(x, 3.0, out=y)
    log = profiling.spans()
    assert [s["name"] for s in log] == ["batch", "step"]
    step = log[1]
    events = list(prof.profiler.kineto_results.events())
    (kernel,) = [e for e in events if e.device_type() == DeviceType.CUDA and "elementwise" in e.name()]
    (launch,) = [e for e in events if e.name() in LAUNCHES and e.correlation_id() == kernel.correlation_id()]
    assert step["host_start_ns"] <= launch.start_ns() <= launch.start_ns() + launch.duration_ns() \
        <= step["host_end_ns"]
    k0, k1 = kernel.start_ns(), kernel.start_ns() + kernel.duration_ns()
    assert step["device_start_ns"] - SLACK_NS <= k0 <= k1 <= step["device_end_ns"] + SLACK_NS, (
        k0 - step["device_start_ns"], step["device_end_ns"] - k1)
    # the sleep held the card: the step began on the card well after the host
    assert step["device_start_ns"] - step["host_start_ns"] > 100_000
    assert log[0]["device_start_ns"] <= step["device_start_ns"] <= step["device_end_ns"] <= log[0]["device_end_ns"]


def test_cuda_only_profile_keeps_spans_off_the_device_rows(card):
    """The benchmark's trace counts every CUDA-typed event as device work;
    the spans' ranges must not appear there without CPU activity."""
    x = torch.ones(1 << 20, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.span("batch", root=True):
            with profiling.span("step", "t", 0):
                x.mul_(2.0)
    names = {e.name() for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA}
    assert not names & {"batch", "step"}, names
    assert [s["name"] for s in profiling.take_spans()] == ["batch", "step"]


def test_chrome_trace_shows_the_spans_above_the_kernels(card, tmp_path):
    x = torch.ones(1 << 20, device="cuda")
    with profiling.trace(str(tmp_path)):
        with profiling.span("batch", root=True):
            with profiling.span("step", "t", 0):
                x.mul_(2.0)
    (name,) = os.listdir(tmp_path)
    events = json.loads((tmp_path / name).read_text())["traceEvents"]
    cats = {e.get("cat") for e in events if e.get("name") == "step"}
    assert "gpu_user_annotation" in cats, cats


def test_sync_counter_counts_a_planted_item(card):
    x = torch.ones(1 << 10, device="cuda")
    counts = []
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CUDA]):
            for planted in (0, 1, 2):
                with profiling.span("batch", root=True):
                    y = x * 2.0
                    for _ in range(planted):
                        y.sum().item()
    counts = [s["syncs"] for s in profiling.spans() if s["name"] == "batch"]
    assert counts == [0, 1, 2]
    assert not [w for w in shown if profiling.SYNC_WARNING in str(w.message)]
    assert torch.cuda.get_sync_debug_mode() == 0
