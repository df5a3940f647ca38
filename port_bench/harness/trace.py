"""The device trace of a traced window: torch.profiler over the card, read
from the raw events (no per-event Python objects beyond one pass).

What it keeps: every device activity (kernels, copies, sets) with its
name and interval, and the host's launch calls. The per-layer readers in
port_bench/metrics/ take their numbers from the summary.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

from torch.autograd import DeviceType

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch")


COPIES = ("Memcpy", "Memset")


def short_name(name: str) -> str:
    """A kernel's qualified name without its return type, template
    arguments, parameters and anonymous namespaces."""
    if name.startswith(COPIES):
        return name.split("(", 1)[0].strip()
    name = name.replace("(anonymous namespace)::", "")
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    head = "".join(out).split("(", 1)[0].strip()
    return head.split()[-1] if head else name


class DeviceTrace:
    """Context manager: profiles the card between enter and exit; the window
    is the host clock's span between two synchronizations."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self.window_start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_end_ns = time.time_ns()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            t = time.perf_counter()
            self.summary = summarize(self._prof.profiler.kineto_results.events(),
                                     self.window_start_ns, self.window_end_ns)
            self.summary["reduce_s"] = time.perf_counter() - t
        return False


def summarize(events, t0: int, t1: int) -> dict:
    """Reduce raw profiler events to: device intervals merged (busy seconds),
    device seconds and launch counts per kernel name, host launch calls,
    the top device operations and idle gaps."""
    intervals = []
    kernel_s = defaultdict(float)
    kernel_n = defaultdict(int)
    launches = 0
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            s, d = e.start_ns(), e.duration_ns()
            if s + d <= t0 or s >= t1:
                continue
            s0, s1 = max(s, t0), min(s + d, t1)
            name = short_name(e.name())
            intervals.append((s0, s1, name))
            kernel_s[name] += (s1 - s0) * 1e-9
            if not name.startswith(COPIES):
                kernel_n[name] += 1
        elif e.name() in LAUNCH_CALLS and t0 <= e.start_ns() < t1:
            launches += 1
    intervals.sort()
    busy = 0
    gaps = defaultdict(float)
    cursor = t0
    for s, e, name in intervals:
        if s > cursor:
            gaps["host, before " + name] += (s - cursor) * 1e-9
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if t1 > cursor:
        gaps["host, after the last device operation"] += (t1 - cursor) * 1e-9
    window_s = (t1 - t0) * 1e-9
    return {
        "window_s": window_s,
        "busy_s": busy * 1e-9,
        "launch_calls": launches,
        "kernel_seconds": dict(kernel_s),
        "kernel_launches": dict(kernel_n),
        "device_ops": sorted(([k, v] for k, v in kernel_s.items()), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:10],
    }
