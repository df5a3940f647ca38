"""Data layer: AMASS and video (PROX/EgoBody) clip datasets, the noise
model, synthetic trees.

Host-side numpy/scipy, with FK and the repr encoding through the port's
torch functions; every batch is a fixed-shape float32 array.
"""

from rohm_tpu_torch.data.amass import AmassClipDataset, load_noise_dict, save_noise_dict
from rohm_tpu_torch.data.clips import divide_into_clips, overlapping_windows
from rohm_tpu_torch.data.synthetic import (
    synthetic_amass_arrays,
    synthetic_clip_batch,
    synthetic_motion,
    write_synthetic_amass,
    write_synthetic_amass_raw,
    write_synthetic_egobody,
    write_synthetic_prox,
)
from rohm_tpu_torch.data.video import VideoClipDataset

__all__ = [
    "AmassClipDataset",
    "load_noise_dict",
    "save_noise_dict",
    "divide_into_clips",
    "overlapping_windows",
    "synthetic_motion",
    "synthetic_clip_batch",
    "synthetic_amass_arrays",
    "write_synthetic_amass",
    "write_synthetic_amass_raw",
    "write_synthetic_egobody",
    "write_synthetic_prox",
    "VideoClipDataset",
]
