"""Per-block Mean/Std normalization stats (a copy of rohm_tpu/reprs/stats.py).

Reference semantics (data_loaders/dataloader_amass.py:247-279):
- mean over all frames of all clips, per dim
- std per dim, then COLLAPSED to the block's scalar mean std — except
  smplx_betas keeps per-dim std, and foot_contact uses mean 0 / std 1
- foot_contact mean forced to 0

Stats are checkpoint-adjacent artifacts: training writes
``<logdir>/AMASS_mean.pkl`` / ``AMASS_std.pkl``; tests load them from the
checkpoint's directory (the reference couples them the same way).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from rohm_tpu_torch.reprs.schema import BODY_FEAT_DIM, REPR_LIST, block_slice


def compute_stats(repr_frames: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Compute (mean [294], std [294]) from frames of shape [..., 294]."""
    flat = np.asarray(repr_frames, np.float64).reshape(-1, BODY_FEAT_DIM)
    mean = flat.mean(axis=0)
    std = flat.std(axis=0)
    for name in REPR_LIST:
        sl = block_slice(name)
        if name == "foot_contact":
            mean[sl] = 0.0
            std[sl] = 1.0
        elif name != "smplx_betas":
            std[sl] = std[sl].mean()
    # constant dims (possible with tiny/synthetic datasets) normalize to 0
    std[std == 0.0] = 1.0
    return mean.astype(np.float32), std.astype(np.float32)


def _to_dicts(mean: np.ndarray, std: np.ndarray) -> tuple[dict, dict]:
    mean_d = {name: mean[block_slice(name)] for name in REPR_LIST}
    std_d = {name: std[block_slice(name)] for name in REPR_LIST}
    return mean_d, std_d


def save_stats(logdir: str, mean: np.ndarray, std: np.ndarray, prefix: str = "AMASS") -> None:
    """Save stats as block dicts (pickle format compatible with the reference).

    Writes are atomic (tmp + rename, std before mean) so an interrupted run
    can never leave a mean file without a matching std file — callers treat
    the mean file's existence as "stats are present"."""
    os.makedirs(logdir, exist_ok=True)
    mean_d, std_d = _to_dicts(mean, std)
    for name, payload in (("std", std_d), ("mean", mean_d)):
        path = os.path.join(logdir, f"{prefix}_{name}.pkl")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=2)
        os.replace(tmp, path)


def load_stats(logdir: str, prefix: str = "AMASS") -> tuple[np.ndarray, np.ndarray]:
    """Load stats saved by save_stats (or by the reference trainer)."""
    mean_p = os.path.join(logdir, f"{prefix}_mean.pkl")
    std_p = os.path.join(logdir, f"{prefix}_std.pkl")
    if not (os.path.exists(mean_p) and os.path.exists(std_p)):
        raise FileNotFoundError(
            f"normalization stats not found in {logdir!r} (expected "
            f"{prefix}_mean.pkl / {prefix}_std.pkl). Stats travel WITH the "
            "checkpoint: they are written into the train logdir and must sit "
            "next to the model checkpoint at test time (reference "
            "dataloader_amass.py:264-276)."
        )
    with open(mean_p, "rb") as f:
        mean_d = pickle.load(f)
    with open(std_p, "rb") as f:
        std_d = pickle.load(f)
    mean = np.concatenate([np.asarray(mean_d[k], np.float32) for k in REPR_LIST], axis=-1)
    std = np.concatenate([np.asarray(std_d[k], np.float32) for k in REPR_LIST], axis=-1)
    assert mean.shape == (BODY_FEAT_DIM,) and std.shape == (BODY_FEAT_DIM,)
    return mean, std
