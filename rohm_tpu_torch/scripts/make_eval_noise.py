"""Generate the deterministic evaluation-noise pickles.

A copy of the JAX package's `scripts/make_eval_noise.py` (numpy only), which
gives the same pickles for the same arguments: the reference's preset-noise
files data/eval_noise_smplx/smplx_noise_level_{N}.pkl (the commented-out
generator at reference dataloader_amass.py:238-245), per-clip Gaussian
draws for transl and betas (additive) and global_orient and body_pose
(Euler-degree space), keyed by a noise level N that sets the rotation std
to N degrees and the translation std to N cm. Run:

    python -m rohm_tpu_torch.scripts.make_eval_noise --n_clips 500 --levels 3,5,7 \\
        --clip_len 145 --out_dir data/eval_noise_smplx
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def make_noise(n_clips: int, clip_len: int, level: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    rot_std = float(level)  # degrees
    trans_std = level / 100.0  # meters (N cm)
    betas_std = 0.1
    return {
        "transl": rng.normal(0.0, trans_std, (n_clips, clip_len, 3)),
        "betas": rng.normal(0.0, betas_std, (n_clips, clip_len, 10)),
        "global_orient": rng.normal(0.0, rot_std, (n_clips, clip_len, 3)),
        "body_pose": rng.normal(0.0, rot_std, (n_clips, clip_len, 21, 3)),
    }


def main(argv=None) -> list[str]:
    """Write one pickle per level (seed + level); returns their paths."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n_clips", type=int, default=500)
    ap.add_argument("--clip_len", type=int, default=145)
    ap.add_argument("--levels", type=str, default="3,5,7")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out_dir", type=str, default="data/eval_noise_smplx")
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    paths = []
    for level in [int(x) for x in args.levels.split(",")]:
        noise = make_noise(args.n_clips, args.clip_len, level, args.seed + level)
        path = os.path.join(args.out_dir, f"smplx_noise_level_{level}.pkl")
        with open(path, "wb") as f:
            pickle.dump(noise, f, protocol=2)
        print(f"wrote {path}")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
