"""The port's AMASS CLIs against the JAX package's, end to end on the CPU.

Both `test_amass_full.main` functions run in one tmp directory (no body-model
weights there, so both take the synthetic SMPL-X model) on the same
synthetic tree, with the same `.npz` checkpoints saved from JAX-initialised
params, and the same replayed diffusion noise: each package's
`RohmPipeline.run_batch` is wrapped (in the test only) to pass the same
`preset_noise`. Tiny widths and steps; one inference iteration (the second
iteration's TrajControl path is held against the JAX package by
tests/test_torch_pipeline*.py). Then both `eval_amass_full` CLIs score the
pickles.
"""

import os
import pickle
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "cfg_files" / "test_cfg" / "amass_occ_leg_noise_3.yaml")
CLIP_LEN, STEPS_TRAJ, STEPS_POSE, ITERS = 17, 3, 4, 1


def _preset_noise(b: int, t_traj: int, tf: int) -> dict:
    rng = np.random.default_rng(11)
    shapes = {
        "traj_init": (ITERS, b, t_traj, tf),
        "traj_step": (ITERS, STEPS_TRAJ, b, t_traj, tf),
        "pose_init": (ITERS, b, t_traj - 1, 294),
        "pose_step": (ITERS, STEPS_POSE, b, t_traj - 1, 294),
    }
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def _with_noise(run_batch):
    def wrapped(self, traj_cond, *args, **kwargs):
        kwargs["preset_noise"] = _preset_noise(*np.shape(traj_cond))
        return run_batch(self, traj_cond, *args, **kwargs)
    return wrapped


def _checkpoints(ckpt_dir: Path) -> tuple[dict, dict]:
    """JAX-initialised TrajNet, TrajControl and PoseNet params (zero leaves
    woken, so the ControlNet taps and biases count) as flattened-flax .npz.
    TrajNet's params are TrajControl's outside its ControlNet branch (the
    same names and shapes), which spares compiling a third init program.
    Returns (paths, the init params by model kind)."""
    import flax
    import jax

    from rohm_tpu.cli import common as jcommon

    args = SimpleNamespace(mid_dim=64, latent_dim=32)
    rng = np.random.default_rng(0)
    control = jax.tree.map(np.asarray, jcommon.init_trajnet_params(
        jcommon.build_trajnet(args, 13, True), CLIP_LEN, 0))
    made = {
        "trajnet": {"params": {k: v for k, v in control["params"].items() if k != "ControlNet_0"}},
        "trajcontrol": control,
        "posenet": jax.tree.map(np.asarray, jcommon.init_posenet_params(
            jcommon.build_posenet(args), CLIP_LEN, 0)),
    }
    paths = {}
    for name, params in made.items():
        flat = flax.traverse_util.flatten_dict(params, sep="/")
        flat = {k: (0.05 * rng.standard_normal(v.shape)).astype(np.float32) if not v.any() else v
                for k, v in flat.items()}
        os.makedirs(ckpt_dir / name, exist_ok=True)
        paths[name] = str(ckpt_dir / name / f"{name}.npz")
        np.savez(paths[name], **flat)
    return paths, made


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from rohm_tpu.cli import test_amass_full as jcli
    from rohm_tpu.data import write_synthetic_amass as jax_write_amass
    from rohm_tpu.pipeline import RohmPipeline as JaxPipeline
    from rohm_tpu.body import synthetic_model as jax_synthetic_model
    from rohm_tpu_torch.cli import test_amass_full as tcli
    from rohm_tpu_torch.pipeline import RohmPipeline

    tmp = tmp_path_factory.mktemp("cli")
    ckpt, inits = _checkpoints(tmp / "ckpt")

    # the JAX CLI initialises each model (then loads the checkpoint over
    # it) with the very calls made above; hand it those results instead of
    # compiling the same init programs a second time
    def init_trajnet_params(model, clip_len, seed=0):
        return inits["trajcontrol" if model.trajcontrol else "trajnet"]

    def init_posenet_params(model, clip_len, seed=0):
        return inits["posenet"]

    # one tree for both (each CLI writes its own only where none exists)
    jax_write_amass(str(tmp / "amass"), jax_synthetic_model(),
                    datasets={n: 1 for n in ("TCDHands", "TotalCapture", "SFU")}, seq_len=CLIP_LEN + 4)
    argv = [
        f"--config={CONFIG}", "--synthetic_data=True", f"--dataset_root={tmp / 'amass'}",
        f"--clip_len={CLIP_LEN}", "--batch_size=4", "--max_batches=1",
        f"--diffusion_steps_trajnet={STEPS_TRAJ}", f"--diffusion_steps_posenet={STEPS_POSE}",
        "--mid_dim=64", "--latent_dim=32", "--load_noise=False", "--mask_scheme=full",
        f"--sample_iter={ITERS}", "--seed=0",
        f"--model_path_trajnet={ckpt['trajnet']}", f"--model_path_trajnet_control={ckpt['trajcontrol']}",
        f"--model_path_posenet={ckpt['posenet']}",
    ]
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        mp.setattr(jcli, "init_trajnet_params", init_trajnet_params)
        mp.setattr(jcli, "init_posenet_params", init_posenet_params)
        mp.setattr(JaxPipeline, "run_batch", _with_noise(JaxPipeline.run_batch))
        mp.setattr(RohmPipeline, "run_batch", _with_noise(RohmPipeline.run_batch))
        jpath = jcli.main(argv + [f"--save_root={tmp / 'res_jax'}"])
        tpath, timing = tcli.run(argv + [f"--save_root={tmp / 'res_torch'}", "--device=cpu"])
    with open(jpath, "rb") as f:
        jdata = pickle.load(f)
    with open(tpath, "rb") as f:
        tdata = pickle.load(f)
    return jpath, tpath, jdata, tdata, timing


def test_cli_pickle_name_and_keys(runs):
    jpath, tpath, jdata, tdata, timing = runs
    assert os.path.basename(tpath) == os.path.basename(jpath)
    assert set(tdata) == set(jdata) == {
        "mask_scheme", "repr_name_list", "repr_dim_dict",
        "rec_ric_data_clean_list", "rec_ric_data_noisy_list",
        "rec_ric_data_rec_list_from_abs_traj", "rec_ric_data_rec_list_from_smpl",
        "motion_repr_clean_list", "motion_repr_noisy_list", "motion_repr_rec_list",
    }
    assert tdata["mask_scheme"] == jdata["mask_scheme"] == "full"
    assert tdata["repr_name_list"] == jdata["repr_name_list"]
    assert tdata["repr_dim_dict"] == jdata["repr_dim_dict"]
    assert set(timing) == {"body_model_load", "dataset_build", "model_init", "batch_host_prep",
                           "batch_dispatch", "device_wait_and_collect", "result_pickle_write",
                           "other", "total"}


def test_cli_arrays_match_jax(runs):
    """The inputs to the pickle (clean and noisy reprs and their joints)
    are FK and the encoder in f32 in each framework, normalized by stats
    each package computed from the same tree: measured <= 1.6e-6. The
    reconstruction went through 3 TrajNet and 4 guided PoseNet steps with
    the same noise and weights, f32 on both sides, so only summation order
    differs and no threshold of the skating loss flips at that size:
    measured <= 6.8e-5 on reprs up to |2|."""
    *_, jdata, tdata, _ = runs
    for key in sorted(set(jdata) - {"mask_scheme", "repr_name_list", "repr_dim_dict"}):
        a, b = tdata[key], jdata[key]
        assert a.shape == b.shape and a.dtype == b.dtype, key
        assert np.isfinite(a).all(), key
        assert a.shape[0] == 3 and a.shape[1] == CLIP_LEN - 2, key  # 3 clips, padded batch trimmed
        tol = 1e-3 if "_rec_" in key or key.startswith("motion_repr_rec") else 1e-5
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=key)


def test_eval_cli_matches_jax(runs, capsys):
    from rohm_tpu.cli import eval_amass_full as jeval
    from rohm_tpu_torch.cli import eval_amass_full as teval

    jpath, tpath, *_ = runs
    capsys.readouterr()
    jm = jeval.main([f"--saved_data_path={jpath}"])
    jout = capsys.readouterr().out.splitlines()[1:]
    tm = teval.main([f"--saved_data_path={tpath}"])
    tout = capsys.readouterr().out.splitlines()[1:]
    # the same metric lines, label for label
    assert [line.split(":")[0] for line in tout] == [line.split(":")[0] for line in jout]
    assert len(tout) == 8
    assert set(tm) == set(jm)
    for k in jm:
        if np.isnan(jm[k]):  # an empty window (traj_mask_ratio 0) is nan in both
            assert np.isnan(tm[k]), k
            continue
        # metrics of joints that agree to 1e-3 m: MPJPE in mm to ~1, the
        # thresholded ratios exactly or by one frame in 3 x 14
        assert abs(tm[k] - jm[k]) <= max(1.0, 0.02 * abs(jm[k])), (k, tm[k], jm[k])


# ---------------------------------------------------------------------------
# flags and checkpoints
# ---------------------------------------------------------------------------


def test_device_flag_never_moves_to_the_cpu_by_itself():
    from rohm_tpu_torch.cli.common import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    missing = torch.cuda.device_count()  # the first index with no device
    with pytest.raises(RuntimeError, match="--device=cpu"):
        resolve_device(str(missing))


def _relay(monkeypatch, tcli):
    """Fake the server's client; a relaying CLI must not resolve a device."""
    import rohm_tpu_torch.serve as serve

    relayed = []
    monkeypatch.setattr(serve, "run_cli", lambda cmd, fwd: relayed.append((cmd, fwd)) or "served")
    if hasattr(tcli, "resolve_device"):
        monkeypatch.setattr(tcli, "resolve_device", lambda spec: pytest.fail("resolved a device"))
    return relayed


@pytest.mark.parametrize("flag", ["--via_server=True"])
def test_unported_test_flags_raise(flag, monkeypatch):
    """--via_server is ported: the run goes to the server's client with the
    flag stripped, before any device is resolved; run() returns the served
    pickle path and no timing (the server prints it)."""
    from rohm_tpu_torch.cli import test_amass_full as tcli

    relayed = _relay(monkeypatch, tcli)
    assert tcli.run([flag, "--device=cpu"]) == ("served", None)
    assert tcli.main(["--device=cpu", flag]) == "served"
    assert relayed == [("test_amass_full", ["--device=cpu"])] * 2


@pytest.mark.parametrize("flag", ["--visualize=True", "--render=True", "--via_server=True"])
def test_unported_eval_flags_raise(flag, runs, monkeypatch):
    """All three are ported. --visualize reaches open3d and --render
    pyrender (here on a body model with faces, which the synthetic one
    lacks), which neither this host nor the card's machine has: each raises
    the JAX package's error after the metrics. --via_server relays."""
    import dataclasses

    from rohm_tpu_torch.cli import common
    from rohm_tpu_torch.cli import eval_amass_full as teval

    tpath = runs[1]
    if flag == "--via_server=True":
        relayed = _relay(monkeypatch, teval)
        assert teval.main([flag, f"--saved_data_path={tpath}"]) == "served"
        assert relayed == [("eval_amass_full", [f"--saved_data_path={tpath}"])]
        return
    resolve = common.resolve_body_model
    monkeypatch.setattr(common, "resolve_body_model", lambda path, device: dataclasses.replace(
        resolve(path, device), faces=np.zeros((1, 3), np.int64)))
    error = (ImportError, "pyrender \\+ trimesh are required") if flag == "--render=True" else (
        ModuleNotFoundError, "open3d")
    with pytest.raises(error[0], match=error[1]):
        teval.main([flag, f"--saved_data_path={tpath}"])


def test_checkpoint_routes(tmp_path):
    from rohm_tpu_torch.cli.common import build_posenet, load_or_init

    model = build_posenet(SimpleNamespace(latent_dim=32))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(FileNotFoundError, match="allow_missing_ckpt"):
        load_or_init(model, str(tmp_path / "nope.npz"))
    load_or_init(model, str(tmp_path / "nope.npz"), allow_missing=True)  # warns, keeps init
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    os.makedirs(tmp_path / "orbax_ckpt")
    with pytest.raises(ValueError, match=r"\.npz"):
        load_or_init(model, str(tmp_path / "orbax_ckpt"))
    np.savez(tmp_path / "partial.npz", **{"params/Dense_0/kernel": np.zeros((32, 32), np.float32)})
    with pytest.raises(KeyError, match="missing parameter"):
        load_or_init(model, str(tmp_path / "partial.npz"))
