"""Stitch overlapping-window outputs into one continuous sequence (a copy
of rohm_tpu/evals/stitch.py).

Beyond-parity extension (off by default everywhere): the reference evaluates
each sliding window independently and never recombines them
(dataloader_video.py:160-179 cuts windows at stride clip_len - overlap_len;
eval_prox_egobody.py concatenates per-window arrays). For export and
visualization of a whole recording, this linearly crossfades the overlapping
output frames.

Geometry: windows are cut at stride = clip_len - overlap_len over the input
frames, and each pipeline output covers the first clip_len - 2 input frames
of its window (two frames are consumed by the repr encode / re-encode
truncations). The OUTPUT overlap is therefore overlap_len - 2 frames — zero
at the shipped window_size=2 (plain concatenation), a real crossfade for
larger overlaps.
"""

from __future__ import annotations

import numpy as np


def stitch_windows(windows: np.ndarray, stride: int) -> np.ndarray:
    """Blend window outputs [N, L, ...] cut at `stride` into [S*(N-1)+L, ...].

    Overlapping frames (L - stride per boundary, when positive) are combined
    with complementary linear ramps; non-overlapping frames pass through
    unchanged. With L <= stride (no output overlap) this is concatenation
    with any inter-window gap left at the last window's values' boundary —
    callers should cut windows so stride <= L.
    """
    windows = np.asarray(windows)
    n, length = windows.shape[:2]
    assert stride > 0, "stride must be positive"
    assert stride <= length, f"stride {stride} > window length {length} leaves gaps"
    total = stride * (n - 1) + length
    tail_shape = (1,) * (windows.ndim - 2)
    out = np.zeros((total,) + windows.shape[2:], np.float64)
    wsum = np.zeros((total,) + tail_shape, np.float64)

    ov = length - stride
    for k in range(n):
        w = np.ones(length)
        if ov > 0:
            ramp = np.arange(1, ov + 1) / (ov + 1)
            if k > 0:
                w[:ov] = ramp  # fade in against the previous window's fade-out
            if k < n - 1:
                w[-ov:] = ramp[::-1]
        s = k * stride
        out[s : s + length] += windows[k] * w.reshape((length,) + tail_shape)
        wsum[s : s + length] += w.reshape((length,) + tail_shape)
    return (out / wsum).astype(windows.dtype)
