"""Shared CLI plumbing: body-model resolution, dataset lists, model builders,
checkpoint loading. The port of rohm_tpu/cli/common.py (reference
train_trajnet.py:82-194, test_amass_full.py:77-188).

Checkpoints: a `.npz` of flattened flax params ("/"-separated keys, the
format rohm_tpu/cli/common.py::load_pretrained reads) is converted by
rohm_tpu_torch/utils/convert_flax.py and loaded strictly; that is how the
JAX package's weights come across. Orbax checkpoint directories are not
read by the port.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from rohm_tpu_torch.body.model import SmplxModel, load_smplx_npz, synthetic_model
from rohm_tpu_torch.models import PoseNet, TrajNet
from rohm_tpu_torch.utils.convert_flax import posenet_state_dict, trajnet_state_dict

log = logging.getLogger("rohm_tpu_torch.cli")

# reference train_trajnet.py:86-92
AMASS_TRAIN_DATASETS = [
    "HumanEva", "HDM05", "MoSh", "Transitions", "ACCAD", "BMLhandball",
    "BMLmovi", "BMLrub", "CMU", "DFaust", "Eyes_Japan_Dataset", "PosePrior",
    "SSM", "GRAB", "SOMA",
]
AMASS_TEST_DATASETS = ["TCDHands", "TotalCapture", "SFU"]


def resolve_device(spec) -> torch.device:
    """--device: a CUDA index (default 0) or the literal "cpu". An index
    with no CUDA device raises: the CLI never moves to the CPU by itself."""
    if str(spec).lower() == "cpu":
        return torch.device("cpu")
    index = int(spec)
    if not torch.cuda.is_available() or index >= torch.cuda.device_count():
        raise RuntimeError(
            f"--device={spec}: no CUDA device {index} on this host "
            f"({torch.cuda.device_count()} visible); pass --device=cpu to run on the CPU"
        )
    return torch.device("cuda", index)


def resolve_body_model(body_model_path: str, device, gender: str = "neutral") -> SmplxModel:
    """Load SMPL-X weights if present, else fall back to the synthetic test
    model (real SMPL-X weights are license-gated and may be absent)."""
    candidates = [
        body_model_path,
        os.path.join(body_model_path, f"SMPLX_{gender.upper()}.npz"),
        os.path.join(body_model_path, "smplx", f"SMPLX_{gender.upper()}.npz"),
    ]
    for c in candidates:
        if os.path.isfile(c) and c.endswith(".npz"):
            log.info("loading SMPL-X model from %s", c)
            return load_smplx_npz(c, device)
    log.warning(
        "SMPL-X weights not found under %s — using the synthetic body model "
        "(shapes/kinematics identical; joint outputs are NOT SMPL-X-accurate)",
        body_model_path,
    )
    return synthetic_model(device=device)


def build_trajnet(args, traj_feat_dim: int, trajcontrol: bool = False) -> TrajNet:
    """Hyperparameters as constructed by the reference entry scripts
    (train_trajnet.py:128-142: time_dim=32, mid_dim=512)."""
    return TrajNet(
        traj_feat_dim=traj_feat_dim,
        cond_dim=traj_feat_dim,
        mid_dim=getattr(args, "mid_dim", None) or 512,
        time_dim=32,
        trajcontrol=trajcontrol,
    )


def build_posenet(args, seed: int | None = None) -> PoseNet:
    """Reference train_posenet.py:116-128: latent 512, ff 1024, 8 layers,
    4 heads, dropout 0.1 (train mode only). With `seed`, the random init
    is drawn from a generator seeded with it (the global one is left as it
    was); without, from the global generator."""
    def make():
        return PoseNet(
            latent_dim=getattr(args, "latent_dim", None) or 512,
            ff_size=1024,
            num_layers=8,
            num_heads=4,
            dropout=0.1,
        )

    if seed is None:
        return make()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return make()


def load_pretrained(model: torch.nn.Module, path: str) -> None:
    """Load a flattened-flax-params `.npz` into a TrajNet or PoseNet, strictly:
    a parameter the model expects and the file lacks raises (silently keeping
    random init would produce garbage metrics with rc=0); keys the model does
    not use are ignored."""
    if os.path.isdir(path) or not path.endswith(".npz"):
        raise ValueError(
            f"checkpoint {path!r} is not a .npz: the port reads flattened flax params "
            "saved as .npz ('/'-separated keys, e.g. np.savez(path, **flax.traverse_util."
            "flatten_dict(params, sep='/'))); orbax checkpoint directories are not read"
        )
    with np.load(path) as z:
        flat = dict(z)
    try:
        if isinstance(model, PoseNet):
            sd = posenet_state_dict(flat, num_layers=model.num_layers)
        else:
            sd = trajnet_state_dict(flat, trajcontrol=model.trajcontrol)
    except KeyError as e:
        raise KeyError(
            f"checkpoint {path} is missing parameter {e} the model expects "
            "(converter drift or wrong architecture flags)"
        ) from None
    model.load_state_dict(sd, strict=True)


def load_or_init(model: torch.nn.Module, path: str, allow_missing: bool = False,
                 name: str = "model") -> torch.nn.Module:
    """Keep the model's random init (made from the caller's seed), then load
    `path` if given. A given-but-nonexistent path RAISES (reference
    behavior: torch.load fails loudly on a typo'd --model_path); an empty
    path means intentional random init (synthetic / smoke runs).
    `allow_missing` downgrades the raise to a loud warning."""
    if not path:
        return model
    if not os.path.exists(path):
        if allow_missing:
            log.warning(
                "%s checkpoint %s not found — proceeding with RANDOM-INIT "
                "weights (allow_missing_ckpt=True)", name, path,
            )
            return model
        raise FileNotFoundError(
            f"{name} checkpoint not found: {path!r}. Fix the path, or pass "
            "--allow_missing_ckpt=True to run with random-init weights."
        )
    load_pretrained(model, path)
    return model
