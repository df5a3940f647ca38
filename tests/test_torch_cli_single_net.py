"""The port's single-net test CLIs against the JAX package's, end to end on
the CPU.

`test_posenet.main` and `test_trajnet.main` of both packages run in one tmp
directory (no body-model weights there, so both take the synthetic SMPL-X
model) on one synthetic tree, with the same `.npz` checkpoints saved from
JAX-initialised params, and the same diffusion noise: `p_sample_loop` as
each package's `train.steps` calls it is wrapped (in the test only) to pass
x_T and the per-step noise drawn from a numpy generator seeded by the
shape. PoseNet runs plain, guided with early stop, and fused (the port's
plain versions of K1's kernels here; JAX's K1 in interpret mode, at
tests/test_ops.py's width D = 64); TrajNet with the infill mask and as
TrajControl. Tiny steps and widths.
"""

import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

CLIP_LEN = 17
TEST_DATASETS = ("TCDHands", "TotalCapture", "SFU")
POSENET_CASES = {  # name -> extra flags
    "plain": ["--diffusion_steps=4"],
    # 24 steps, so that early stop (20) still runs 4, all of them guided (t <= 50)
    "guided_early_stop": ["--diffusion_steps=24", "--cond_fn_with_grad=True", "--early_stop=True"],
    "fused": ["--diffusion_steps=3", "--fused_posenet=True"],
}
TRAJNET_CASES = {
    "infill": ["--infill_traj=True", "--max_infill_ratio=0.5"],
    "trajcontrol": ["--trajcontrol=True"],
}


def _replay(p_sample_loop, as_array):
    """p_sample_loop with x_T and step_noise drawn from numpy, seeded by the
    sample's shape and the schedule's length."""
    def wrapped(model_fn, sched, shape, key, **kw):
        rng = np.random.default_rng(int(np.prod(shape)) + sched.num_timesteps)
        kw["noise"] = as_array(rng.standard_normal(tuple(shape)).astype(np.float32))
        kw["step_noise"] = as_array(
            rng.standard_normal((sched.num_timesteps, *shape)).astype(np.float32))
        return p_sample_loop(model_fn, sched, shape, key, **kw)
    return wrapped


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tree, the checkpoints (PoseNet D = 64, TrajNet and TrajControl
    mid_dim 64, zero leaves woken) with the train split's stats beside them
    (as a trained run directory holds them; both CLIs then skip the train
    split) and the init params by model kind."""
    import flax
    import jax

    from rohm_tpu.body import synthetic_model as jax_synthetic_model
    from rohm_tpu.cli import common as jcommon
    from rohm_tpu.data import write_synthetic_amass as jax_write_amass

    from rohm_tpu_torch.body import synthetic_model
    from rohm_tpu_torch.data import AmassClipDataset
    from rohm_tpu_torch.reprs.stats import save_stats

    tmp = tmp_path_factory.mktemp("single_net")
    jax_write_amass(str(tmp / "amass"), jax_synthetic_model(),
                    datasets={n: 1 for n in TEST_DATASETS}, seq_len=CLIP_LEN + 4)
    stats = AmassClipDataset(synthetic_model(), str(tmp / "amass"), list(TEST_DATASETS), split="train",
                             task="pose", clip_len=CLIP_LEN)
    args = SimpleNamespace(mid_dim=64, latent_dim=64)
    control = jax.tree.map(np.asarray, jcommon.init_trajnet_params(
        jcommon.build_trajnet(args, 13, True), CLIP_LEN, 0))
    inits = {
        "trajnet": {"params": {k: v for k, v in control["params"].items() if k != "ControlNet_0"}},
        "trajcontrol": control,
        "posenet": jax.tree.map(np.asarray, jcommon.init_posenet_params(
            jcommon.build_posenet(args), CLIP_LEN, 0)),
    }
    rng = np.random.default_rng(0)
    ckpt = {}
    for name, params in inits.items():
        flat = flax.traverse_util.flatten_dict(params, sep="/")
        flat = {k: (0.05 * rng.standard_normal(v.shape)).astype(np.float32) if not v.any() else v
                for k, v in flat.items()}
        os.makedirs(tmp / "ckpt" / name)
        ckpt[name] = str(tmp / "ckpt" / name / f"{name}.npz")
        np.savez(ckpt[name], **flat)
        save_stats(str(tmp / "ckpt" / name), stats.mean, stats.std)
    return tmp, ckpt, inits


def _run_both(tmp, inits, jcli, tcli, argv_j, argv_t):
    """Both packages' main() in `tmp`, each sampler replaying the same noise.
    Returns each one's result and the lines it printed."""
    import contextlib
    import io

    import jax.numpy as jnp

    import rohm_tpu.train.steps as jsteps
    import rohm_tpu_torch.train.steps as tsteps

    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        # the JAX CLIs initialise each model (then load the checkpoint over
        # it) with the calls the fixture made: hand them those results
        # instead of compiling the same init programs again
        if hasattr(jcli, "init_posenet_params"):
            mp.setattr(jcli, "init_posenet_params", lambda model, clip_len, seed=0: inits["posenet"])
        if hasattr(jcli, "init_trajnet_params"):
            mp.setattr(jcli, "init_trajnet_params", lambda model, clip_len, seed=0: inits[
                "trajcontrol" if model.trajcontrol else "trajnet"])
        mp.setattr(jsteps, "p_sample_loop", _replay(jsteps.p_sample_loop, jnp.asarray))
        mp.setattr(tsteps, "p_sample_loop", _replay(tsteps.p_sample_loop, torch.from_numpy))
        out = []
        for cli, argv in ((jcli, argv_j), (tcli, argv_t)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                result = cli.main(argv)
            out.append((result, buf.getvalue().splitlines()))
        return out


# ---------------------------------------------------------------------------
# test_posenet
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(POSENET_CASES))
def posenet_run(request, setup):
    from rohm_tpu.cli import test_posenet as jcli
    from rohm_tpu_torch.cli import test_posenet as tcli

    tmp, ckpt, inits = setup
    case = request.param
    argv = [
        f"--dataset_root={tmp / 'amass'}", f"--clip_len={CLIP_LEN}", "--batch_size=4",
        "--latent_dim=64", f"--model_path={ckpt['posenet']}", "--save_results=True",
        "--mask_scheme=lower", "--seed=0", *POSENET_CASES[case],
    ]
    import rohm_tpu_torch.train.steps as tsteps

    fused_calls = []
    with pytest.MonkeyPatch.context() as mp:
        apply = tsteps.posenet_apply_fused
        mp.setattr(tsteps, "posenet_apply_fused", lambda *a, **kw: fused_calls.append(1) or apply(*a, **kw))
        (jm, jout), (tm, tout) = _run_both(
            tmp, inits, jcli, tcli, argv + [f"--save_root={tmp / ('jax_' + case)}"],
            argv + [f"--save_root={tmp / ('torch_' + case)}", "--device=cpu"])
    # the fused case steps through K1's chain (its plain versions on the CPU)
    assert len(fused_calls) == (3 if case == "fused" else 0)
    pickles = []
    for root in (tmp / f"jax_{case}", tmp / f"torch_{case}"):
        (name,) = os.listdir(root)
        with open(root / name, "rb") as f:
            pickles.append((name, pickle.load(f)))
    return case, (jm, jout), (tm, tout), pickles


def test_posenet_mpjpe_matches_jax(posenet_run):
    """The global MPJPE of the reconstruction over 3 clips x 16 frames,
    returned and printed: measured <= 9e-8 m apart on ~0.05 m, held at
    1e-4 m."""
    case, (jm, jout), (tm, tout), _ = posenet_run
    assert np.isfinite(tm) and tm > 0
    assert abs(tm - jm) <= 1e-4, (case, tm, jm)
    line = f"mpjpe_global (mm): {tm * 1000:0.1f}"
    assert line in tout and [x.split(":")[0] for x in jout if x.startswith("mpjpe")] == ["mpjpe_global (mm)"]


def test_posenet_pickle_matches_jax(posenet_run):
    """The same name, keys and protocol-2 arrays. The clean and noisy inputs
    are FK and the encoder in f32 in each framework from one tree: measured
    <= 4.2e-7, held at 1e-5. The reconstructions went through 3-4 steps of
    the same noise and weights, f32 on both sides (the fused case: the
    plain versions of K1's kernels against K1 in interpret mode), so only
    summation order differs: measured <= 3.4e-5 on reprs up to |1.9| (the
    guided case; 3.9e-6 plain and fused) and 2.3e-6 m on joints, held at
    1e-3."""
    case, _, _, ((jname, jdata), (tname, tdata)) = posenet_run
    assert tname == jname == f"test_posenet_mask_lower_grad_{case == 'guided_early_stop'}_seed_0.pkl"
    assert set(tdata) == set(jdata) == {
        "mask_scheme", "repr_name_list", "repr_dim_dict", "rec_ric_data_clean_list",
        "rec_ric_data_rec_list_from_smpl", "motion_repr_clean_list", "motion_repr_rec_list",
        "rec_ric_data_noisy_list",
    }
    assert tdata["mask_scheme"] == jdata["mask_scheme"] == "lower"
    assert tdata["repr_name_list"] == jdata["repr_name_list"]
    assert tdata["repr_dim_dict"] == jdata["repr_dim_dict"]
    for key in sorted(set(jdata) - {"mask_scheme", "repr_name_list", "repr_dim_dict"}):
        a, b = tdata[key], jdata[key]
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32, key
        assert a.shape[:2] == (3, CLIP_LEN - 1) and np.isfinite(a).all(), key
        tol = 1e-3 if "_rec_" in key or key.endswith("rec_list") else 1e-5
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=f"{case} {key}")


# ---------------------------------------------------------------------------
# test_trajnet
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(TRAJNET_CASES))
def trajnet_run(request, setup):
    from rohm_tpu.cli import test_trajnet as jcli
    from rohm_tpu_torch.cli import test_trajnet as tcli

    tmp, ckpt, inits = setup
    case = request.param
    model = ckpt["trajcontrol" if case == "trajcontrol" else "trajnet"]
    argv = [f"--dataset_root={tmp / 'amass'}", f"--clip_len={CLIP_LEN}", "--batch_size=4",
            "--mid_dim=64", "--diffusion_steps=3", f"--model_path={model}", "--seed=0",
            *TRAJNET_CASES[case]]
    return (case, *_run_both(tmp, inits, jcli, tcli, argv, argv + ["--device=cpu"]))


def test_trajnet_results_match_jax(trajnet_run):
    """All 15 means: root rotation (rad), root x/y/z errors (m) from the
    three decodings, and the jitters (m/s^3, a third difference times
    30^3, so f32 rounding of positions ~1e-7 m reads as ~3e-3 there). The
    same noise, weights and infill draws: measured <= 1.8e-7 rad and
    9.2e-8 m, held at 1e-5; jitters measured <= 7.8e-3 on up to 1.6e4,
    held at 1e-2 plus 1e-5 of the value."""
    from rohm_tpu_torch.cli.test_trajnet import ERROR_KEYS

    case, (jres, _), (tres, _) = trajnet_run
    assert list(tres) == list(jres) == list(ERROR_KEYS)
    for k in ERROR_KEYS:
        assert np.isfinite(tres[k]), (case, k)
        tol = 1e-2 + 1e-5 * abs(jres[k]) if k.startswith("jitter") else 1e-5
        assert abs(tres[k] - jres[k]) <= tol, (case, k, tres[k], jres[k])


def test_trajnet_prints_the_same_lines(trajnet_run):
    """The printed summary: the same 8 labels in the same order."""
    _, (_, jout), (_, tout) = trajnet_run
    labels = [[x.split(":")[0] for x in out if x.startswith("root")] for out in (jout, tout)]
    assert labels[0] == labels[1] and len(labels[1]) == 8


# ---------------------------------------------------------------------------
# --visualize and --via_server
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cli", ["test_posenet", "test_trajnet"])
@pytest.mark.parametrize("flag", ["--visualize=True", "--via_server=True"])
def test_unported_flags_raise(cli, flag, setup, monkeypatch):
    """Both flags are ported. --visualize reaches open3d at the first batch,
    which neither this host nor the card's machine has: the JAX CLI's
    ModuleNotFoundError. --via_server hands argv without the flag to the
    server's client and returns what it returns, before the CLI resolves
    its device (no CUDA context in a relaying client)."""
    import importlib

    import rohm_tpu_torch.serve as serve

    tcli = importlib.import_module(f"rohm_tpu_torch.cli.{cli}")
    tmp, ckpt, _ = setup
    argv = [flag, "--device=cpu", f"--dataset_root={tmp / 'amass'}", f"--clip_len={CLIP_LEN}",
            "--batch_size=4", "--diffusion_steps=3", "--seed=0", "--max_batches=1"]
    argv += ([f"--model_path={ckpt['posenet']}", "--latent_dim=64"] if cli == "test_posenet"
             else [f"--model_path={ckpt['trajnet']}", "--mid_dim=64"])
    if flag == "--visualize=True":
        monkeypatch.chdir(tmp)
        with pytest.raises(ModuleNotFoundError, match="open3d"):
            tcli.main(argv)
        return
    relayed = []
    monkeypatch.setattr(serve, "run_cli", lambda cmd, fwd: relayed.append((cmd, fwd)) or "served")
    monkeypatch.setattr(tcli, "resolve_device", lambda spec: pytest.fail("resolved a device"))
    assert tcli.main(argv) == "served"
    assert relayed == [(cli, argv[1:])]


@pytest.mark.parametrize("cli", ["test_posenet", "test_trajnet"])
def test_no_cuda_device_raises(cli):
    """The default --device=0 on a host without that card raises; the CLI
    never moves to the CPU by itself."""
    import importlib

    tcli = importlib.import_module(f"rohm_tpu_torch.cli.{cli}")
    missing = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="--device=cpu"):
        tcli.main([f"--device={missing}"])
