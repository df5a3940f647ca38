"""Profiling helpers: the port of rohm_tpu/utils/profiling.py.

- profile_kv: wall-clock accumulator context manager, kv-style (a copy)
- profile: its decorator form (a copy)
- trace: torch.profiler over the CPU and the card, written as a Chrome
  trace (chrome://tracing, Perfetto) into `logdir` on exit
- span: a named range inside the program (a batch, a chain, a step, ...),
  recorded only while a torch.profiler profile records; read with spans()
  or take_spans()

Spans. Off (no profile recording) entering a span is one flag read and a
shared no-op context. While a profile records, each span keeps its name,
its parent's and its root's index in the log, one int attribute, and its
host start and end from time.time_ns() (the clock the profiler's events
are placed on). Under a root span (span(..., root=True)) on a process
whose CUDA is initialised, each span also records a CUDA event on the
current stream at enter and at exit; the root's enter synchronises once
and records an anchor event at a known host time, so that every device
stamp of the root is the anchor's host time plus the event's elapsed time
from the anchor: device and host stamps on one clock. The events are
resolved only when the log is read. While a root records, torch.cuda's
sync debug mode is set to warn and every host-device synchronisation it
reports is counted on the root (`syncs`), the warning itself swallowed.
Each span also opens a record_function range, so where the profile
records CPU activity (trace() does) the spans appear in its Chrome trace
above the kernels they launched.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from collections import defaultdict

import torch
from torch.autograd import profiler as _torch_profiler

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
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.strftime('%Y%m%d_%H%M%S')}.json"))


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

# the text of the warning torch.cuda's sync debug mode gives per synchronisation
SYNC_WARNING = "called a synchronizing CUDA operation"

_LOG: list[_Span] = []  # every span recorded since the last take_spans()
_OPEN: list[int] = []  # the indices of the spans open now, innermost last
_OFF = contextlib.nullcontext()


def span(name: str, attr: str | None = None, value: int = 0, root: bool = False):
    """A context manager that records the block as a span named `name`,
    with the int attribute `attr` = `value` where `attr` is given, while a
    torch.profiler profile records; otherwise it does nothing. A root span
    (one batch) anchors its spans' device stamps to the host clock and
    counts its host-device synchronisations (see the module docstring)."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attr, value, root)


class _SyncCounter:
    """Counts the synchronisations torch.cuda's sync debug mode reports
    between start() and stop(); other warnings pass through."""

    def start(self) -> _SyncCounter:
        self.count = 0
        self._mode = torch.cuda.get_sync_debug_mode()
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
        self._show = warnings.showwarning
        warnings.showwarning = self._seen
        if self._mode == 0:  # a mode set to raise stays so
            torch.cuda.set_sync_debug_mode("warn")
        return self

    def _seen(self, message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(SYNC_WARNING):
            self.count += 1
        else:
            self._show(message, category, filename, lineno, file, line)

    def stop(self) -> int:
        torch.cuda.set_sync_debug_mode(self._mode)
        self._warnings.__exit__(None, None, None)
        return self.count


class _Span:
    """One recorded span: the log's entry and its context manager."""

    __slots__ = ("name", "attrs", "is_root", "parent", "root", "host_start", "host_end", "device_start",
                 "device_end", "syncs", "anchor", "anchor_ns", "_ev_start", "_ev_end", "_range", "_counter")

    def __init__(self, name: str, attr: str | None, value: int, root: bool):
        self.name, self.is_root = name, root
        self.attrs = {} if attr is None else {attr: int(value)}
        self.host_end = self.device_start = self.device_end = self.syncs = None
        self.anchor = self.anchor_ns = self._ev_start = self._ev_end = self._counter = None

    def __enter__(self):
        index = len(_LOG)
        self.parent = _OPEN[-1] if _OPEN else None
        _LOG.append(self)
        _OPEN.append(index)
        if self.is_root:
            self.root = index
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
                self.anchor = self._ev_start = torch.cuda.Event(enable_timing=True)
                self.anchor.record()
                self.anchor_ns = time.time_ns()
                self._counter = _SyncCounter().start()
        else:
            self.root = None if self.parent is None else _LOG[self.parent].root
            if self.root is not None and _LOG[self.root].anchor is not None:
                self._ev_start = torch.cuda.Event(enable_timing=True)
                self._ev_start.record()
        self._range = _torch_profiler.record_function(self.name)
        self._range.__enter__()
        self.host_start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.host_end = time.time_ns()
        try:
            self._range.__exit__(*exc)
            if self._ev_start is not None:
                self._ev_end = torch.cuda.Event(enable_timing=True)
                self._ev_end.record()
            if self._counter is not None:
                self.syncs = self._counter.stop()
                self._counter = None
        finally:
            self._range = None
            _OPEN.pop()
        return False

    def resolve(self) -> None:
        """Device stamps from the events (which must have completed)."""
        root = _LOG[self.root]
        self.device_start = root.anchor_ns + round(root.anchor.elapsed_time(self._ev_start) * 1e6)
        self.device_end = root.anchor_ns + round(root.anchor.elapsed_time(self._ev_end) * 1e6)
        self._ev_start = self._ev_end = None

    def as_dict(self) -> dict:
        def dur(a, b):
            return None if a is None or b is None else b - a

        return {"name": self.name, "parent": self.parent, "root": self.root, "attrs": dict(self.attrs),
                "host_start_ns": self.host_start, "host_end_ns": self.host_end,
                "host_ns": dur(self.host_start, self.host_end), "device_start_ns": self.device_start,
                "device_end_ns": self.device_end, "device_ns": dur(self.device_start, self.device_end),
                "syncs": self.syncs}


def spans() -> list[dict]:
    """The log, resolved and left in place: one dict per span in the order
    the spans were entered, a span's index being its position. Keys: name,
    parent and root (indices, or None), attrs, host_start_ns, host_end_ns,
    host_ns, device_start_ns, device_end_ns, device_ns (None where the span
    has no device stamps, or is still open) and syncs (the root's count of
    host-device synchronisations; None elsewhere)."""
    pending = [s for s in _LOG if s._ev_end is not None]
    if pending:
        torch.cuda.synchronize()
        for s in pending:
            s.resolve()
    return [s.as_dict() for s in _LOG]


def take_spans() -> list[dict]:
    """spans(), then the log cleared. Refused while a span is open."""
    if _OPEN:
        raise RuntimeError(f"take_spans() inside the open span {_LOG[_OPEN[-1]].name!r}")
    out = spans()
    _LOG.clear()
    return out
