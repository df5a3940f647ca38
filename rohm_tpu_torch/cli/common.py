"""Shared CLI plumbing: body-model resolution, dataset lists, preset noise
and stats, model builders, checkpoint loading. The port of rohm_tpu/cli/common.py (reference
train_trajnet.py:82-194, test_amass_full.py:77-188).

Checkpoints: a `.npz` of flattened flax params ("/"-separated keys, the
format rohm_tpu/cli/common.py::load_pretrained reads) is converted by
rohm_tpu_torch/utils/convert_flax.py and loaded strictly; that is how the
JAX package's weights come across. Any other file is a torch state_dict
under the reference's names (its released weights), loaded directly.
Orbax checkpoint directories are not read by the port.
"""

from __future__ import annotations

import logging
import os
import time
from contextlib import contextmanager

import numpy as np
import torch

from rohm_tpu_torch.body.model import SmplxModel, load_smplx_npz, synthetic_model
from rohm_tpu_torch.data.amass import AmassClipDataset, load_noise_dict
from rohm_tpu_torch.models import PoseNet, TrajNet
from rohm_tpu_torch.parallel.mesh import (
    DataMesh,
    barrier,
    broadcast_object,
    data_parallel_mesh,
    launched,
    spawn,
)
from rohm_tpu_torch.reprs.stats import save_stats
from rohm_tpu_torch.utils.convert_flax import posenet_state_dict, trajnet_state_dict
from rohm_tpu_torch.utils.runlog import make_logdir, save_params_json, setup_logger

log = logging.getLogger("rohm_tpu_torch.cli")

# reference train_trajnet.py:86-92
AMASS_TRAIN_DATASETS = [
    "HumanEva", "HDM05", "MoSh", "Transitions", "ACCAD", "BMLhandball",
    "BMLmovi", "BMLrub", "CMU", "DFaust", "Eyes_Japan_Dataset", "PosePrior",
    "SSM", "GRAB", "SOMA",
]
AMASS_TEST_DATASETS = ["TCDHands", "TotalCapture", "SFU"]


class PhaseTimer:
    """Host-clock seconds per named phase of a CLI run, summed over
    repeats. `t0 = timer("name", t0)` closes the phase that began at t0 and
    returns the start of the next; `summary()` adds the unaccounted rest
    ("other") and the run's "total", rounded to 0.01 s."""

    def __init__(self):
        self.start = time.perf_counter()
        self.seconds = {}

    def __call__(self, name: str, t0: float) -> float:
        self.seconds[name] = self.seconds.get(name, 0.0) + (time.perf_counter() - t0)
        return time.perf_counter()

    def summary(self) -> dict:
        total = time.perf_counter() - self.start
        return {**{k: round(v, 2) for k, v in self.seconds.items()},
                "other": round(total - sum(self.seconds.values()), 2), "total": round(total, 2)}


# batches of device outputs a CLI keeps in flight: the host prepares the
# next batch while the card finishes this one's decode
MAX_PENDING = 3


def keep_in_flight(pending: list, entry, drain) -> None:
    """Queue one batch's device outputs and drain (copy to the host) the
    oldest ones beyond MAX_PENDING."""
    pending.append(entry)
    while len(pending) > MAX_PENDING:
        drain(pending.pop(0))


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


def _run_rank(mesh: DataMesh, body, args):
    """One spawned rank of run_data_parallel. What crosses back must
    pickle: a train loop comes back as its run directory."""
    out = body(args, mesh)
    return getattr(out, "logdir", out)


def run_data_parallel(body, args):
    """--data_parallel=True: run `body(args, mesh)` as one rank of a
    data-parallel job and return rank 0's result.

    - Under a launcher that set the torchrun variables (RANK, WORLD_SIZE,
      LOCAL_RANK, MASTER_ADDR, MASTER_PORT) this process joins that group,
      on cuda:LOCAL_RANK (the CPU with --device=cpu).
    - Otherwise, with more than one card visible and no --device=cpu, it
      starts one process per card itself (parallel.spawn, a rendezvous on
      localhost) and returns rank 0's result (a train loop's run directory).
    - Otherwise the job is this one process: a group of one rank on
      --device, which runs the same code path as a larger mesh.
    """
    cpu = str(args.device).lower() == "cpu"
    if launched():
        device = "cpu" if cpu else torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    elif not cpu and torch.cuda.device_count() > 1:
        return spawn(_run_rank, torch.cuda.device_count(), (body, args))[0]
    else:
        device = resolve_device(args.device)
    mesh = data_parallel_mesh(device)
    try:
        return body(args, mesh)
    finally:
        mesh.close()


@contextmanager
def rank_zero_first(mesh: DataMesh | None):
    """Run the block on rank 0 first, then on the other ranks, so what it
    writes (a synthetic tree, the derived-array caches, the stats) is in
    place before they read it."""
    if mesh is not None and mesh.rank != 0:
        barrier(mesh)
    yield
    if mesh is not None and mesh.rank == 0:
        barrier(mesh)


def open_run_dir(args, mesh: DataMesh | None):
    """A train CLI's run directory: (logdir, logger, TensorBoard writer or
    None). Rank 0 makes `<save_dir>/<id>/` with params.json and the run
    log and tells the other ranks its path; they write nothing there and
    log nowhere."""
    if mesh is not None and mesh.rank != 0:
        return broadcast_object(None, mesh), logging.getLogger(f"rohm_tpu_torch.rank{mesh.rank}"), None
    logdir = make_logdir(args.save_dir)
    broadcast_object(logdir, mesh)
    logger = setup_logger(logdir)
    save_params_json(logdir, args)
    logger.info("RUNDIR: %s", logdir)
    try:
        from tensorboardX import SummaryWriter

        writer = SummaryWriter(log_dir=logdir)
    except ImportError:
        writer = None
    return logdir, logger, writer


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


def load_eval_noise(args) -> dict | None:
    """--load_noise: the preset noise of data/eval_noise_smplx/
    smplx_noise_level_<--load_noise_level>.pkl. Where that file is absent
    the CLI draws fresh noise: a warning, args.load_noise set to False and
    None returned."""
    if not args.load_noise:
        return None
    noise_path = os.path.join("data", "eval_noise_smplx", f"smplx_noise_level_{args.load_noise_level}.pkl")
    if os.path.exists(noise_path):
        return load_noise_dict(noise_path)
    print(f"[WARN] preset noise pkl not found at {noise_path}; sampling fresh noise")
    args.load_noise = False
    return None


def amass_stats_dir(model_path: str, data_kw: dict) -> str:
    """The directory of the normalization stats (AMASS_mean.pkl,
    AMASS_std.pkl). They travel with a trained checkpoint (reference
    test_amass_full.py:91-92), so the checkpoint's directory where it holds
    them; else they are computed from the clean repr of the train split of
    `data_kw`'s tree (AmassClipDataset's data arguments) and saved under
    `<tree>/_stats_cache/`, in a directory keyed like the derived-array
    cache ("amass_torch_<key>", never the JAX package's "amass_<key>")."""
    stats_dir = os.path.dirname(model_path) if model_path else None
    if stats_dir and os.path.exists(os.path.join(stats_dir, "AMASS_mean.pkl")):
        return stats_dir
    ds_stats = AmassClipDataset(split="train", task="pose", logdir=None, input_noise=False, **data_kw)
    key = (os.path.splitext(os.path.basename(ds_stats._cache_path))[0]
           if ds_stats._cache_path else "torch_default")
    stats_dir = os.path.join(data_kw["preprocessed_amass_root"], "_stats_cache", key)
    if not os.path.exists(os.path.join(stats_dir, "AMASS_mean.pkl")):
        save_stats(stats_dir, ds_stats.mean, ds_stats.std)
    return stats_dir


def _seeded(make, seed: int | None):
    """make() with its random init drawn from a generator seeded with
    `seed` (the global one is left as it was); without, from the global
    generator."""
    if seed is None:
        return make()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return make()


MODEL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_dtype(args) -> torch.dtype:
    """--model_dtype: the compute dtype of PoseNet and TrajNet, float32 by
    default (rohm_tpu/cli/common.py:48-55). Parameters, checkpoints and
    the GroupNorm/LayerNorm statistics stay float32 in either."""
    name = getattr(args, "model_dtype", None) or "float32"
    if name not in MODEL_DTYPES:
        raise ValueError(f"--model_dtype={name!r}: expected one of {sorted(MODEL_DTYPES)}")
    return MODEL_DTYPES[name]


def build_trajnet(args, traj_feat_dim: int, trajcontrol: bool = False,
                  seed: int | None = None) -> TrajNet:
    """Hyperparameters as constructed by the reference entry scripts
    (train_trajnet.py:128-142: time_dim=32, mid_dim=512). `seed` as in
    build_posenet."""
    return _seeded(lambda: TrajNet(
        traj_feat_dim=traj_feat_dim,
        cond_dim=traj_feat_dim,
        mid_dim=getattr(args, "mid_dim", None) or 512,
        time_dim=32,
        trajcontrol=trajcontrol,
        dtype=model_dtype(args),
    ), seed)


def build_posenet(args, seed: int | None = None) -> PoseNet:
    """Reference train_posenet.py:116-128: latent 512, ff 1024, 8 layers,
    4 heads, dropout 0.1 (train mode only). With `seed`, the random init
    is drawn from a generator seeded with it (the global one is left as it
    was); without, from the global generator."""
    return _seeded(lambda: PoseNet(
        latent_dim=getattr(args, "latent_dim", None) or 512,
        ff_size=1024,
        num_layers=8,
        num_heads=4,
        dropout=0.1,
        dtype=model_dtype(args),
    ), seed)


# the U-Net encoder and mid blocks the TrajControl branch copies
# (reference train_trajnet.py:149-164)
_CONTROL_COPIES = tuple(f"enc{i}" for i in range(1, 5)) + tuple(
    f"downsample{i}" for i in range(1, 5)) + ("mid_block1", "mid_block2")


def bootstrap_trajcontrol(control_state: dict, backbone_state: dict) -> dict:
    """Copy a pretrained U-Net into a TrajControl model's state_dict: the
    backbone's entries verbatim (condition encoder, U-Net, time MLP, final
    conv), plus its diffusion encoder and mid blocks (`diff_enc1-4`,
    `diff_downsample1-4`, `diff_mid_block1-2`) duplicated into the branch as
    `controlnet.control_*` (reference train_trajnet.py:149-164). The six zero
    convs keep the control state's values (zero at init). Returns a new
    state_dict."""
    out = dict(control_state)
    for key, val in backbone_state.items():
        if key in out:
            out[key] = val
        block = key[len("diff_"):].split(".", 1)[0] if key.startswith("diff_") else None
        if block in _CONTROL_COPIES:
            out["controlnet.control_" + key[len("diff_"):]] = val
    return out


def _load_torch_state_dict(model: torch.nn.Module, path: str) -> None:
    """A torch state_dict under the reference's names (a released `.pt`,
    or a `torch.save` of one of the port's modules): a parameter the model
    expects and the file lacks raises; keys the model does not use (a
    positional-table buffer, another branch) are ignored with a warning.
    Never `load_state_dict(strict=True)` on the raw file."""
    device = next(model.parameters()).device
    sd = torch.load(path, map_location=device, weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"checkpoint {path!r} holds a {type(sd).__name__}, not a state_dict")
    expected = model.state_dict()
    missing = [k for k in expected if k not in sd]
    if missing:
        raise KeyError(
            f"checkpoint {path} is missing parameter(s) the model expects: "
            f"{missing[:8]}{'...' if len(missing) > 8 else ''} "
            "(wrong architecture flags, or not a state_dict of this net)"
        )
    unused = sorted(k for k in sd if k not in expected)
    if unused:
        log.warning("checkpoint %s has %d key(s) the model does not use: %s",
                    path, len(unused), unused[:8])
    model.load_state_dict({k: sd[k] for k in expected}, strict=True)


def load_pretrained(model: torch.nn.Module, path: str) -> None:
    """Load a checkpoint into a TrajNet, TrajControl or PoseNet, strictly: a
    parameter the model expects and the file lacks raises (silently keeping
    random init would produce garbage metrics with rc=0); keys the model
    does not use are ignored. The route follows what `path` is: a `*.npz`
    file holds flattened flax params (the port's and the JAX package's
    training checkpoints); any other file is a torch state_dict (the
    reference's released weights, named without an extension in the
    shipped YAMLs); a directory (an orbax checkpoint) is refused."""
    if os.path.isdir(path):
        raise ValueError(
            f"checkpoint {path!r} is a directory: the port reads flattened flax params "
            "saved as .npz ('/'-separated keys, e.g. np.savez(path, **flax.traverse_util."
            "flatten_dict(params, sep='/'))) or a torch state_dict file; orbax checkpoint "
            "directories are not read"
        )
    if not path.endswith(".npz"):
        _load_torch_state_dict(model, path)
        return
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
