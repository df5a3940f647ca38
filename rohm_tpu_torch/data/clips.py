"""Sequence -> fixed-length clip cutting (a copy of rohm_tpu/data/clips.py)."""

from __future__ import annotations

import numpy as np


def divide_into_clips(
    seq_joints: np.ndarray, seq_params: np.ndarray, clip_len: int
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Cut a sequence into non-overlapping clip_len windows; drop the remainder
    (reference dataloader_amass.py:121-131)."""
    n = len(seq_joints)
    joints, params = [], []
    for i in range(n // clip_len):
        joints.append(seq_joints[clip_len * i : clip_len * (i + 1)])
        params.append(seq_params[clip_len * i : clip_len * (i + 1)])
    return joints, params


def pad_tail_size(valid: int, batch_size: int, pad_last, pad_multiple: int = 1) -> int:
    """Padded size for a short final batch.

    pad_last=True pads to batch_size (one compiled shape for the whole eval).
    pad_last="bucket" pads only to the next power of two (rounded up to
    pad_multiple, for mesh divisibility), capped at batch_size: a 7-clip tail
    behind bs=64 batches costs 8 clips of device compute instead of 64. Each
    bucket is one extra compiled program, amortized by the persistent
    compilation cache."""
    if pad_last != "bucket":
        return batch_size
    b = 1
    while b < valid:
        b *= 2
    b = -(-b // pad_multiple) * pad_multiple
    return min(b, batch_size)


def overlapping_windows(n_frames: int, clip_len: int, overlap_len: int) -> list[tuple[int, int]]:
    """Start/end indices of overlapping sliding windows over a long recording
    (reference dataloader_video.py:160-179: stride = clip_len - overlap_len)."""
    stride = clip_len - overlap_len
    assert stride > 0
    spans = []
    start = 0
    while start + clip_len <= n_frames:
        spans.append((start, start + clip_len))
        start += stride
    return spans
