"""The port's PoseNet training CLI end to end on the CPU (`--device=cpu`):
the shipped stage-1 YAML cut to tiny widths and steps, on a synthetic AMASS
tree, in each `--fused_train` mode. Checks the run directory (params.json,
the log, the stats pickles, `model{step:09d}.npz` checkpoints), resuming,
and the checkpoint route: the JAX package's `load_pretrained` reads the
port's checkpoint strictly, flax -> torch -> flax is the identity, and the
port's test CLI runs the trained weights."""

import json
import os
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from rohm_tpu.cli import common as jcommon
from rohm_tpu_torch.cli import test_amass_full, train_posenet
from rohm_tpu_torch.cli.common import build_posenet
from rohm_tpu_torch.models import PoseNet
from rohm_tpu_torch.train.checkpoint import latest_checkpoint, save_checkpoint
from rohm_tpu_torch.utils.convert_flax import posenet_flax_params, posenet_state_dict

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "cfg_files" / "train_cfg" / "posenet_train_stage1.yaml")
COMMON = [
    f"--config={CONFIG}", "--synthetic_data=True", "--debug=True", "--clip_len=17",
    "--batch_size=2", "--diffusion_steps=6", "--num_steps=4", "--save_interval=2",
    "--log_interval=3", "--latent_dim=32", "--seed=0", "--device=cpu",
]


def _run(tmp: Path, *extra) -> train_posenet.TrainLoopPoseNet:
    return train_posenet.main(COMMON + [f"--dataset_root={tmp / 'amass'}", f"--save_dir={tmp / 'runs'}",
                                        *extra])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One bf16-mode run that keeps its optimizer state."""
    tmp = tmp_path_factory.mktemp("train")
    return tmp, _run(tmp, "--fused_train=bfloat16", "--save_optimizer=True")


@pytest.mark.parametrize("mode", ["", "float32", "bfloat16"])
def test_train_cli_run_directory(mode, tmp_path):
    loop = _run(tmp_path, f"--fused_train={mode}")
    runs = os.listdir(tmp_path / "runs")
    assert len(runs) == 1
    logdir = tmp_path / "runs" / runs[0]
    files = os.listdir(logdir)
    assert {"params.json", "AMASS_mean.pkl", "AMASS_std.pkl"} <= set(files)
    # periodic saves at steps 2 and 4, the epoch loop's extra step, the final save
    assert sorted(f for f in files if f.startswith("model")) == [
        "model000000002.npz", "model000000004.npz", "model000000005.npz"]
    assert latest_checkpoint(str(logdir)).endswith("model000000005.npz")
    params = json.loads((logdir / "params.json").read_text())
    assert params["fused_train"] == mode and params["batch_size"] == 2  # the flag
    assert params["mask_scheme"] == "lower+upper+full" and params["weight_loss_foot_skating"] == 0.1  # the YAML
    log = (logdir / [f for f in files if f.startswith("run_") and f.endswith(".log")][0]).read_text()
    assert "RUNDIR" in log and "[train]  loss:" in log and "[eval]  loss:" in log and "model saved" in log
    assert all(torch.isfinite(v) for v in loop.last_losses.values())
    init = build_posenet(SimpleNamespace(latent_dim=32), seed=0)
    moved = [not torch.equal(a, b) for a, b in zip(init.parameters(), loop.state.model.parameters())]
    assert all(moved)
    assert loop.step == 5 and loop.state.step == 5


def test_resume_keeps_training(trained, tmp_path):
    tmp, loop = trained
    logdir = Path(loop.logdir)
    resumed = train_posenet.main(
        [f for f in COMMON if not f.startswith("--num_steps")]
        + [f"--dataset_root={tmp / 'amass'}", f"--save_dir={tmp_path / 'runs2'}", "--fused_train=bfloat16",
           f"--resume_from={logdir / 'model000000004.npz'}", "--num_steps=6"])
    assert resumed.step >= 6
    log = "".join(p.read_text() for p in (tmp_path / "runs2").rglob("run_*.log"))
    assert "restored params + optimizer state" in log
    a, b = loop.state.model.input_process.poseEmbedding.weight, resumed.state.model.input_process.poseEmbedding.weight
    assert a.shape == b.shape and not torch.allclose(a, b)


def test_resume_from_orbax_dir_raises(trained, tmp_path):
    tmp, _ = trained
    (tmp_path / "model000000004").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        _run(tmp, f"--resume_from={tmp_path / 'model000000004'}", f"--save_dir={tmp_path / 'runs'}")


def test_jax_load_pretrained_reads_the_checkpoint_strictly(trained):
    """rohm_tpu/cli/common.py::load_pretrained on the port's final
    checkpoint: every parameter the flax PoseNet expects is in the file
    (strict), with the port's trained values."""
    _, loop = trained
    path = latest_checkpoint(loop.logdir)
    args = SimpleNamespace(latent_dim=32, model_dtype="float32")
    like = jcommon.init_posenet_params(jcommon.build_posenet(args), 17, 0)
    loaded = jax.tree.map(np.asarray, jcommon.load_pretrained(like, path))
    want = posenet_flax_params(loop.state.model.state_dict(), 4)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path_): v
            for path_, v in jax.tree_util.tree_leaves_with_path(loaded)}
    assert sorted(flat) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    with np.load(path) as z:
        assert "opt_state/count" in z and int(z["opt_state/count"]) == loop.state.step


def test_flax_torch_flax_is_the_identity(tmp_path):
    args = SimpleNamespace(latent_dim=32, model_dtype="float32")
    params = jax.tree.map(np.asarray, jcommon.init_posenet_params(jcommon.build_posenet(args), 17, 3))
    port = PoseNet(latent_dim=32, ff_size=1024, num_layers=8, num_heads=4)
    port.load_state_dict(posenet_state_dict(params, num_layers=8))
    path = save_checkpoint(str(tmp_path), 7, port)
    assert path.endswith("model000000007.npz")
    flat = {"/".join(str(getattr(k, "key", k)) for k in p): v
            for p, v in jax.tree_util.tree_leaves_with_path(params)}
    with np.load(path) as z:
        assert sorted(z.files) == sorted(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)


def test_the_test_cli_runs_the_trained_checkpoint(trained, tmp_path):
    """Inference closes the loop: the port's test_amass_full reads the
    trained `.npz` and its run directory's stats."""
    _, loop = trained
    pkl, _ = test_amass_full.run([
        "--config=" + str(ROOT / "cfg_files" / "test_cfg" / "amass_occ_leg_noise_3.yaml"),
        "--synthetic_data=True", f"--dataset_root={tmp_path / 'amass'}", "--clip_len=17",
        "--batch_size=4", "--mid_dim=64", "--latent_dim=32", "--diffusion_steps_trajnet=3",
        "--diffusion_steps_posenet=4", "--load_noise=False", "--model_path_trajnet=",
        "--model_path_trajnet_control=", f"--model_path_posenet={latest_checkpoint(loop.logdir)}",
        "--device=cpu", f"--save_root={tmp_path / 'results'}", "--max_batches=1",
    ])
    assert os.path.exists(pkl)


def test_no_card_without_device_cpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device=0 would train on it")
    with pytest.raises(RuntimeError, match="--device=cpu"):
        _run(tmp_path, "--device=0")
