"""Profiling helpers: the port of rohm_tpu/utils/profiling.py.

- profile_kv: wall-clock accumulator context manager, kv-style (a copy)
- profile: its decorator form (a copy)
- trace: torch.profiler over the CPU and the card, written as a Chrome
  trace (chrome://tracing, Perfetto) into `logdir` on exit
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

_TIMINGS: dict[str, float] = defaultdict(float)
_COUNTS: dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def profile_kv(name: str):
    """Accumulate wall-clock under `name`; read with get_timings()."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _TIMINGS[name] += time.perf_counter() - t0
        _COUNTS[name] += 1


def profile(fn):
    """Decorator form of profile_kv (reference logger.py @profile)."""

    def wrapped(*a, **kw):
        with profile_kv(fn.__name__):
            return fn(*a, **kw)

    return wrapped


def get_timings() -> dict[str, tuple[float, int]]:
    return {k: (_TIMINGS[k], _COUNTS[k]) for k in _TIMINGS}


def reset_timings() -> None:
    _TIMINGS.clear()
    _COUNTS.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the block's host ops and, where CUDA is present, its kernels on
    the card; on exit write `<logdir>/trace_<pid>_<time>.json` (Chrome trace
    format). Yields the profiler (`key_averages()` for a table)."""
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.strftime('%Y%m%d_%H%M%S')}.json"))
