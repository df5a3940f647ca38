"""Run directories, file loggers, config dumps (reference utils/other_utils.py:101-117).

A copy of rohm_tpu/utils/runlog.py without its JAX helpers; the logger is
named under "rohm_tpu_torch"."""

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
