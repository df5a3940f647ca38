"""Checkpoints of PoseNet training as `.npz` files of flattened flax params.

The port of rohm_tpu/train/checkpoint.py. The JAX package saves orbax
directories `model{step:09d}` in the run directory, beside the
normalization stats (`AMASS_mean.pkl`/`AMASS_std.pkl`) that the test CLIs
read from the checkpoint's directory (reference dataloader_amass.py:264-276).
Orbax cannot be written without jax, so the port writes
`model{step:09d}.npz` in the same place, holding the flax param tree
flattened with "/" (keys "params/..."): the format both the JAX package's
`load_pretrained` (rohm_tpu/cli/common.py) and the port's read. With the
optimizer state, the AdamW moments ride along in the flax layout under
"opt_state/mu/params/...", "opt_state/nu/params/..." with their step count
under "opt_state/count".
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from rohm_tpu_torch.utils.convert_flax import posenet_flax_params, posenet_state_dict

CKPT_RE = re.compile(r"model(\d{9})\.npz")


def ckpt_name(step: int) -> str:
    return f"model{step:09d}.npz"


def _moments(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    """AdamW state -> {"count", "mu", "nu"}, the moments by parameter name."""
    names = {p: n for n, p in model.named_parameters()}
    mu, nu, count = {}, {}, 0
    for p, st in optimizer.state.items():
        mu[names[p]] = st["exp_avg"]
        nu[names[p]] = st["exp_avg_sq"]
        count = int(st["step"])
    return {"count": count, "mu": mu, "nu": nu}


def save_checkpoint(logdir: str, step: int, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer | None = None) -> str:
    """Write `<logdir>/model{step:09d}.npz`; returns its path."""
    num_heads = model.num_heads
    payload = posenet_flax_params(model.state_dict(), num_heads)
    if optimizer is not None and optimizer.state:
        m = _moments(model, optimizer)
        payload["opt_state/count"] = np.asarray(m["count"], np.int64)
        for kind in ("mu", "nu"):
            for k, v in posenet_flax_params(m[kind], num_heads).items():
                payload[f"opt_state/{kind}/{k}"] = v
    path = os.path.abspath(os.path.join(logdir, ckpt_name(step)))
    tmp = path[: -len(".npz")] + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer | None = None) -> bool:
    """Load params strictly into `model`, and the AdamW state into
    `optimizer` when the file has it. Returns whether it had. An orbax
    directory (the JAX package's checkpoints) raises: the port reads its
    `.npz`, or a JAX checkpoint flattened to one."""
    if os.path.isdir(path) or not path.endswith(".npz"):
        raise ValueError(
            f"checkpoint {path!r} is not a .npz: the port resumes from its own "
            "model{step:09d}.npz checkpoints (flattened flax params); an orbax "
            "directory of the JAX package is not read - save its params with "
            "np.savez(path, **flax.traverse_util.flatten_dict(params, sep='/')) first"
        )
    with np.load(path) as z:
        flat = dict(z)
    sd = posenet_state_dict(flat, num_layers=model.num_layers)
    model.load_state_dict(sd, strict=True)
    if optimizer is None or "opt_state/count" not in flat:
        return False
    moments = {kind: posenet_state_dict({k[len(f"opt_state/{kind}/"):]: v for k, v in flat.items()
                                         if k.startswith(f"opt_state/{kind}/")},
                                        num_layers=model.num_layers)
               for kind in ("mu", "nu")}
    count = float(flat["opt_state/count"])
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(count),
            "exp_avg": moments["mu"][name].to(p.device),
            "exp_avg_sq": moments["nu"][name].to(p.device),
        }
    return True


def latest_checkpoint(logdir: str) -> str | None:
    """Highest-step model{step:09d}.npz inside logdir, or None."""
    if not os.path.isdir(logdir):
        return None
    found = [(int(m.group(1)), name) for name in os.listdir(logdir) if (m := CKPT_RE.fullmatch(name))]
    return os.path.join(logdir, max(found)[1]) if found else None


def checkpoint_step(path: str) -> int | None:
    """The step in a checkpoint's file name, or None."""
    m = CKPT_RE.fullmatch(os.path.basename(path))
    return int(m.group(1)) if m else None
