"""Checkpoints of TrajNet and PoseNet training as `.npz` files of flattened
flax params.

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
under "opt_state/count": those of the parameters the optimizer holds, which
in a TrajControl run are the `controlnet.` branch's alone (the frozen
backbone has none; train/state.py). The model's type picks the layout:
TrajNet (plain or TrajControl, from its `trajcontrol`) or PoseNet.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from rohm_tpu_torch.models.trajnet import TrajNet
from rohm_tpu_torch.utils.convert_flax import (
    posenet_flax_params,
    posenet_state_dict,
    trajnet_flax_params,
    trajnet_state_dict,
)

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


def _flax_params(model: torch.nn.Module, tensors: dict) -> dict:
    """Tensors under the model's parameter names -> flat flax params."""
    if isinstance(model, TrajNet):
        return trajnet_flax_params(tensors)
    return posenet_flax_params(tensors, model.num_heads)


def _state_dict(model: torch.nn.Module, flat: dict, names, prefix: str = "params/") -> dict:
    """Flat flax params under `prefix` -> the tensors of `names`. The entries
    under `prefix` are laid over the params, so moments held for only some
    parameters (a TrajControl run's branch) decode with the same converter."""
    tree = {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}
    tree.update({k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)})
    if isinstance(model, TrajNet):
        sd = trajnet_state_dict(tree, trajcontrol=model.trajcontrol)
    else:
        sd = posenet_state_dict(tree, num_layers=model.num_layers)
    return {n: sd[n] for n in names}


def save_checkpoint(logdir: str, step: int, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer | None = None) -> str:
    """Write `<logdir>/model{step:09d}.npz`; returns its path."""
    payload = _flax_params(model, model.state_dict())
    if optimizer is not None and optimizer.state:
        m = _moments(model, optimizer)
        payload["opt_state/count"] = np.asarray(m["count"], np.int64)
        for kind in ("mu", "nu"):
            for k, v in _flax_params(model, m[kind]).items():
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
    model.load_state_dict(_state_dict(model, flat, dict(model.named_parameters())), strict=True)
    if optimizer is None or "opt_state/count" not in flat:
        return False
    names = {p: n for n, p in model.named_parameters()}
    held = {names[p]: p for group in optimizer.param_groups for p in group["params"]}
    moments = {kind: _state_dict(model, flat, held, f"opt_state/{kind}/params/") for kind in ("mu", "nu")}
    count = float(flat["opt_state/count"])
    for name, p in held.items():
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
