"""The port's TrajNet training CLI end to end on the CPU (`--device=cpu`):
the shipped YAMLs cut to tiny widths and steps (`--clip_len=17
--mid_dim=64 --batch_size=2 --diffusion_steps=6`) on a synthetic AMASS
tree. Checks the run directory (params.json, the log, the stats pickles,
`model{step:09d}.npz` checkpoints), resuming, the TrajControl fine-tune
from the vanilla checkpoint (the backbone bit for bit its bootstrap, the
branch moved) and the checkpoint route: the JAX package's
`load_pretrained` reads both layouts strictly, flax -> torch -> flax is
the identity, and the port's test CLI runs both trained checkpoints.

The debug tree has 4 train clips, 2 batches per epoch; 5 steps keep clear
of the epoch loop's extra step past a multiple of them."""

import json
import os
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from rohm_tpu.cli import common as jcommon
from rohm_tpu_torch.cli import test_amass_full, train_trajnet
from rohm_tpu_torch.cli.common import bootstrap_trajcontrol, build_trajnet, load_pretrained
from rohm_tpu_torch.models import TrajNet
from rohm_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from rohm_tpu_torch.train.state import create_train_state, trajcontrol_frozen_mask
from rohm_tpu_torch.utils.convert_flax import trajnet_flax_params, trajnet_state_dict

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = ROOT / "cfg_files" / "train_cfg"
VANILLA = f"--config={CFG / 'trajnet_train_vanilla_stage1.yaml'}"
TRAJCONTROL = f"--config={CFG / 'trajnet_ft_trajcontrol.yaml'}"
COMMON = [
    "--synthetic_data=True", "--debug=True", "--clip_len=17", "--mid_dim=64", "--batch_size=2",
    "--diffusion_steps=6", "--num_steps=5", "--save_interval=2", "--log_interval=3", "--seed=0",
    "--device=cpu",
]
ARGS = SimpleNamespace(mid_dim=64, model_dtype="float32")


def _run(tmp: Path, config: str, *extra, save_dir: str = "runs") -> train_trajnet.TrainLoopTrajNet:
    return train_trajnet.main([config, *COMMON, f"--dataset_root={tmp / 'amass'}",
                               f"--save_dir={tmp / save_dir}", *extra])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A vanilla run and the TrajControl fine-tune from its final
    checkpoint, both keeping their optimizer state."""
    tmp = tmp_path_factory.mktemp("train")
    vanilla = _run(tmp, VANILLA, "--save_optimizer=True")
    control = _run(tmp, TRAJCONTROL, "--save_optimizer=True",
                   f"--pretrained_backbone_path={latest_checkpoint(vanilla.logdir)}", save_dir="runs_control")
    return tmp, vanilla, control


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _flax_like(trajcontrol: bool):
    """The JAX package's TrajNet of the CLI's flags, its params' shapes
    (traced, not compiled)."""
    model = jcommon.build_trajnet(ARGS, 13, trajcontrol)
    kw = {"control_cond": np.zeros((1, 16, 272), np.float32)} if trajcontrol else {}
    z = np.zeros((1, 16, 13), np.float32)
    return jax.eval_shape(model.init, jax.random.PRNGKey(0), z, z, np.zeros(1, np.int32), **kw)


def _log(logdir) -> str:
    return "".join(p.read_text() for p in Path(logdir).glob("run_*.log"))


@pytest.mark.parametrize("infill", [False, True], ids=["stage1", "stage1_infill"])
def test_train_cli_run_directory(infill, tmp_path):
    """The run directory, periodic and final checkpoints, the log's train
    and eval losses; every parameter moved from the --seed init. With
    --start_infill_epoch=0 --mask_prob=1 every step masks its condition."""
    extra = ["--start_infill_epoch=0", "--mask_prob=1.0"] if infill else []
    loop = _run(tmp_path, VANILLA, *extra)
    runs = os.listdir(tmp_path / "runs")
    assert len(runs) == 1
    logdir = tmp_path / "runs" / runs[0]
    files = os.listdir(logdir)
    assert {"params.json", "AMASS_mean.pkl", "AMASS_std.pkl"} <= set(files)
    assert sorted(f for f in files if f.startswith("model")) == [
        "model000000002.npz", "model000000004.npz", "model000000005.npz"]
    params = json.loads((logdir / "params.json").read_text())
    assert params["mid_dim"] == 64 and params["trajcontrol"] is False  # the flag, the YAML
    assert params["weight_loss_root_rot_cos_smooth_from_abs_traj"] == 1.0
    assert params["start_infill_epoch"] == (0 if infill else 10**20)
    log = _log(logdir)
    assert "RUNDIR" in log and "[train]  loss:" in log and "[eval]  loss:" in log and "model saved" in log
    assert all(torch.isfinite(v) for v in loop.last_losses.values())
    init = build_trajnet(ARGS, 13, False, seed=0)
    assert all(not torch.equal(a, b) for a, b in zip(init.parameters(), loop.state.model.parameters()))
    assert loop.step == 5 and loop.state.step == 5
    # the curriculum's draws: none before start_infill_epoch, one uniform and a mask per step after
    if infill:
        assert loop.rng.bit_generator.state != np.random.default_rng(0).bit_generator.state
    else:
        assert loop.rng.bit_generator.state == np.random.default_rng(0).bit_generator.state


def test_trajcontrol_finetune_freezes_the_backbone(trained):
    """Every tensor outside `controlnet.` is bit for bit the bootstrapped
    value (the vanilla checkpoint's), every branch tensor moved (the zero
    convs included); the checkpoint's moments are the branch's alone."""
    _, vanilla, control = trained
    backbone = build_trajnet(ARGS, 13, False, seed=0)
    load_pretrained(backbone, latest_checkpoint(vanilla.logdir))
    start = bootstrap_trajcontrol(build_trajnet(ARGS, 13, True, seed=0).state_dict(), backbone.state_dict())
    assert all(not start[k].any() for k in start if "zero_conv" in k)
    for name, p in control.state.model.named_parameters():
        if name.startswith("controlnet."):
            assert not torch.equal(p.detach(), start[name]), name
        else:
            assert torch.equal(p.detach(), start[name]), name
            assert torch.equal(p.detach(), vanilla.state.model.state_dict()[name]), name
    with np.load(latest_checkpoint(control.logdir)) as z:
        moments = [k for k in z.files if k.startswith("opt_state/mu/")]
        assert moments and all(k.startswith("opt_state/mu/params/ControlNet_0/") for k in moments)
        assert len(moments) == sum(n.startswith("controlnet.") for n, _ in control.state.model.named_parameters())
        assert int(z["opt_state/count"]) == control.state.step == 5
    assert "bootstrapped ControlNet" in _log(control.logdir)


@pytest.mark.parametrize("which", ["vanilla", "trajcontrol"])
def test_resume_keeps_training(trained, tmp_path, which):
    """--resume_from restores the params and the AdamW moments (in a
    TrajControl run, the branch's) and trains on from the file's step."""
    tmp, vanilla, control = trained
    loop = vanilla if which == "vanilla" else control
    config = VANILLA if which == "vanilla" else TRAJCONTROL
    extra = [] if which == "vanilla" else [f"--pretrained_backbone_path={latest_checkpoint(vanilla.logdir)}"]
    resumed = train_trajnet.main(
        [config, *[f for f in COMMON if not f.startswith("--num_steps")], f"--dataset_root={tmp / 'amass'}",
         f"--save_dir={tmp_path / 'runs2'}", f"--resume_from={Path(loop.logdir) / 'model000000004.npz'}",
         "--num_steps=7", *extra])
    assert resumed.step >= 7
    assert "restored params + optimizer state" in _log(resumed.logdir)
    a = loop.state.model.diff_final_conv[1].weight
    b = resumed.state.model.diff_final_conv[1].weight
    assert a.shape == b.shape and torch.equal(a, b) == (which == "trajcontrol")  # frozen in TrajControl
    a, b = loop.state.model.diff_enc1.blocks[0].block[0].weight, resumed.state.model.diff_enc1.blocks[0].block[0].weight
    assert torch.equal(a, b) == (which == "trajcontrol")


@pytest.mark.parametrize("which", ["vanilla", "trajcontrol"])
def test_jax_load_pretrained_reads_the_checkpoint_strictly(trained, which):
    """rohm_tpu/cli/common.py::load_pretrained on the port's final
    checkpoint: every parameter the flax TrajNet (or TrajControl) expects
    is in the file (strict), with the port's trained values."""
    _, vanilla, control = trained
    loop = vanilla if which == "vanilla" else control
    trajcontrol = which == "trajcontrol"
    loaded = _flat(jax.tree.map(np.asarray, jcommon.load_pretrained(_flax_like(trajcontrol),
                                                                    latest_checkpoint(loop.logdir))))
    want = trajnet_flax_params(loop.state.model.state_dict())
    assert sorted(loaded) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)


@pytest.mark.parametrize("which", ["vanilla", "trajcontrol"])
def test_checkpoint_restores_params_and_moments(trained, which):
    """load_checkpoint of a run's final `.npz` into a fresh model and
    optimizer: every parameter and every AdamW moment (in a TrajControl run
    the branch's alone) bit for bit the run's, and the step count."""
    _, vanilla, control = trained
    loop = vanilla if which == "vanilla" else control
    trajcontrol = which == "trajcontrol"
    model = build_trajnet(ARGS, 13, trajcontrol, seed=1)
    state = create_train_state(model, trainable=trajcontrol_frozen_mask(model) if trajcontrol else None)
    assert load_checkpoint(latest_checkpoint(loop.logdir), model, state.optimizer)
    for (name, a), b in zip(loop.state.model.named_parameters(), model.parameters()):
        assert torch.equal(a, b), name
    names = {p: n for n, p in model.named_parameters()}
    held = loop.state.optimizer.state
    want = {n: held[p] for n, p in loop.state.model.named_parameters() if p in held}
    got = {names[p]: st for p, st in state.optimizer.state.items()}
    assert sorted(got) == sorted(want) and all(n.startswith("controlnet.") for n in got) == trajcontrol
    for n, st in want.items():
        assert torch.equal(got[n]["exp_avg"], st["exp_avg"]), n
        assert torch.equal(got[n]["exp_avg_sq"], st["exp_avg_sq"]), n
        assert float(got[n]["step"]) == float(st["step"]) == loop.state.step


@pytest.mark.parametrize("trajcontrol", [False, True], ids=["trajnet", "trajcontrol"])
def test_flax_torch_flax_is_the_identity(tmp_path, trajcontrol):
    """Random flax params of the JAX TrajNet's shapes -> the port's model
    (trajnet_state_dict) -> its checkpoint (trajnet_flax_params): the same
    keys and values, bit for bit."""
    rng = np.random.default_rng(2)
    flat = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in _flat(_flax_like(trajcontrol)).items()}
    port = TrajNet(traj_feat_dim=13, cond_dim=13, mid_dim=64, trajcontrol=trajcontrol)
    port.load_state_dict(trajnet_state_dict(flat, trajcontrol=trajcontrol))
    path = save_checkpoint(str(tmp_path), 7, port)
    assert path.endswith("model000000007.npz")
    with np.load(path) as z:
        assert sorted(z.files) == sorted(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)


def test_the_test_cli_runs_both_trained_checkpoints(trained, tmp_path):
    """Inference closes the loop: the port's test_amass_full reads the
    trained TrajNet and TrajControl `.npz` files."""
    _, vanilla, control = trained
    pkl, _ = test_amass_full.run([
        "--config=" + str(ROOT / "cfg_files" / "test_cfg" / "amass_occ_leg_noise_3.yaml"),
        "--synthetic_data=True", f"--dataset_root={tmp_path / 'amass'}", "--clip_len=17",
        "--batch_size=4", "--mid_dim=64", "--latent_dim=32", "--diffusion_steps_trajnet=3",
        "--diffusion_steps_posenet=4", "--load_noise=False",
        f"--model_path_trajnet={latest_checkpoint(vanilla.logdir)}",
        f"--model_path_trajnet_control={latest_checkpoint(control.logdir)}", "--model_path_posenet=",
        "--device=cpu", f"--save_root={tmp_path / 'results'}", "--max_batches=1",
    ])
    assert os.path.exists(pkl)


def test_backbone_and_model_together_raise(trained, tmp_path):
    """As in the JAX CLI: a TrajControl fine-tune takes a backbone or a
    whole model, not both."""
    tmp, _, control = trained
    with pytest.raises(ValueError, match="cannot set both"):
        _run(tmp, TRAJCONTROL, "--load_pretrained_model=True",
             f"--pretrained_model_path={latest_checkpoint(control.logdir)}", save_dir=str(tmp_path / "runs"))


def test_no_card_without_device_cpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device=0 would train on it")
    with pytest.raises(RuntimeError, match="--device=cpu"):
        _run(tmp_path, VANILLA, "--device=0")
