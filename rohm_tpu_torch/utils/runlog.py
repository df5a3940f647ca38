"""Run directories, file loggers, config dumps (reference utils/other_utils.py:101-117).

A copy of rohm_tpu/utils/runlog.py; the logger is named under
"rohm_tpu_torch", and `fixseed` returns a torch.Generator where the JAX one
returns a PRNG key. `enable_compilation_cache` has no counterpart: it sets
up XLA's persistent compile cache, and eager PyTorch compiles nothing per
run (the kernel library is built once into rohm_tpu_torch/_build/)."""

from __future__ import annotations

import json
import logging
import os
import time


def make_logdir(root: str = "runs", seed=None) -> str:
    """runs/<random 1..100000> like the reference (train_trajnet.py:197-198)."""
    import random

    rng = random.Random(seed)
    while True:
        run_id = rng.randint(1, 100000)
        path = os.path.join(root, str(run_id))
        if not os.path.exists(path):
            os.makedirs(path)
            return path


def setup_logger(logdir: str) -> logging.Logger:
    logger = logging.getLogger(f"rohm_tpu_torch.{os.path.basename(logdir)}")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        handler = logging.FileHandler(
            os.path.join(logdir, f"run_{time.strftime('%Y%m%d_%H%M%S')}.log")
        )
        handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        logger.addHandler(handler)
        logger.addHandler(logging.StreamHandler())
    return logger


def save_params_json(logdir: str, args) -> None:
    """Dump the resolved config as params.json (reference other_utils.py:113-117)."""
    with open(os.path.join(logdir, "params.json"), "w") as f:
        json.dump({k: v for k, v in sorted(vars(args).items())}, f, indent=2, default=str)


def fixseed(seed: int):
    """Seed python's, numpy's and torch's global RNGs and return a
    torch.Generator seeded with `seed` (reference utils/fixseed.py:6-10;
    the JAX package returns jax.random.PRNGKey(seed))."""
    import random

    import numpy as np
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
