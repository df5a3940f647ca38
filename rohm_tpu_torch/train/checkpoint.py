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

The JAX package's orbax directories are read too (`read_orbax`, with
tensorstore alone: no jax, no orbax) into that same flat layout, so both
`load_checkpoint` and `cli/common.py::load_pretrained` take either.
"""

from __future__ import annotations

import json
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
ORBAX_RE = re.compile(r"model(\d{9})")  # the JAX trainers' orbax directories
# optax's AdamW state (ScaleByAdamState) holds these three; where it sits in
# the optimizer's tuple (0, or (0, 0) under a TrajControl run's mask chain)
# does not matter to the port
ADAM_FIELDS = ("count", "mu", "nu")


def ckpt_name(step: int) -> str:
    return f"model{step:09d}.npz"


def _orbax_leaves(path: str) -> list[tuple[tuple, str]]:
    """(tree path, store key) of every array an orbax checkpoint holds, from
    its `_METADATA`: the path from each leaf's `key_metadata` (a key may hold
    dots, so the store key is never split), leaves orbax skips (empty
    optimizer states) left out."""
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise ValueError(
            f"checkpoint {path!r} is a directory without orbax's _METADATA: not an orbax "
            "checkpoint. The port reads orbax directories, flattened flax params saved as "
            ".npz, or a torch state_dict file")
    with open(meta_path) as f:
        meta = json.load(f)
    leaves = []
    for entry in meta["tree_metadata"].values():
        value = entry.get("value_metadata", {})
        if value.get("skip_deserialize") or value.get("value_type") == "None":
            continue
        keys = tuple(str(k["key"]) for k in entry["key_metadata"])
        leaves.append((keys, ".".join(keys)))
    return leaves


def _flat_key(keys: tuple) -> str:
    """An orbax tree path -> the key the `.npz` route holds the same array
    under: "params/..." for the params, "opt_state/count" and
    "opt_state/mu/params/..." for the AdamW state. A tree saved without the
    outer "params" level of flax's variables gets it added."""
    head, rest = keys[0], list(keys[1:])
    if head == "params":
        return "/".join(rest if rest[:1] == ["params"] else ["params", *rest])
    if head != "opt_state":
        raise ValueError(f"orbax leaf {keys}: expected params or opt_state at the top")
    i = next((i for i, k in enumerate(rest) if k in ADAM_FIELDS), None)
    if i is None:
        raise ValueError(f"orbax leaf {keys}: an optimizer state other than AdamW's")
    field, tree = rest[i], rest[i + 1:]
    if field == "count":
        return "opt_state/count"
    return "/".join(["opt_state", field, *(tree if tree[:1] == ["params"] else ["params", *tree])])


def read_orbax(path: str) -> dict:
    """An orbax checkpoint directory of the JAX trainers (`model{step:09d}`,
    rohm_tpu/train/checkpoint.py) -> the flat dict the `.npz` route reads:
    "params/..." and, where the trainer saved its optimizer, "opt_state/
    count", "opt_state/mu/params/..." and "opt_state/nu/params/...".
    Read with tensorstore alone (its OCDBT store holds a zarr array per
    leaf; zarr3 where the leaf has zarr.json); without tensorstore this
    raises ImportError."""
    path = os.path.abspath(path)
    leaves = _orbax_leaves(path)
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            f"reading the orbax checkpoint {path!r} needs the tensorstore package, which is not "
            "installed; save the params as .npz instead (np.savez(path, **flax.traverse_util."
            "flatten_dict(params, sep='/')), the .npz route)") from e
    base = {"driver": "ocdbt", "base": f"file://{path}"}
    stored = {k.decode() for k in ts.KvStore.open(base).result().list().result()}
    flat = {}
    for keys, store_key in leaves:
        zarr = "zarr3" if f"{store_key}/zarr.json" in stored else "zarr"
        if zarr == "zarr" and f"{store_key}/.zarray" not in stored:
            raise KeyError(f"orbax checkpoint {path!r} lists {keys} but holds no array {store_key!r}")
        arr = ts.open({"driver": zarr, "kvstore": {**base, "path": store_key + "/"}}).result()
        key = _flat_key(keys)
        if key in flat:
            raise ValueError(f"orbax checkpoint {path!r}: two leaves map to {key!r}")
        flat[key] = np.asarray(arr.read().result())
    return flat


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
    `optimizer` when the checkpoint has it. Returns whether it had. `path`
    is a `.npz` or a JAX trainer's orbax directory (`read_orbax`), whose
    AdamW moments cover every parameter: a TrajControl optimizer takes those
    of the parameters it holds, the `controlnet.` branch's."""
    if os.path.isdir(path):
        flat = read_orbax(path)
    elif path.endswith(".npz"):
        with np.load(path) as z:
            flat = dict(z)
    else:
        raise ValueError(
            f"checkpoint {path!r} is neither a .npz nor an orbax directory: the port resumes "
            "from its own model{step:09d}.npz checkpoints (flattened flax params) or from "
            "the JAX trainers' model{step:09d} orbax directories"
        )
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
    """The step in a checkpoint's name (a .npz or an orbax directory), or None."""
    name = os.path.basename(path.rstrip("/"))
    m = CKPT_RE.fullmatch(name) or ORBAX_RE.fullmatch(name)
    return int(m.group(1)) if m else None
