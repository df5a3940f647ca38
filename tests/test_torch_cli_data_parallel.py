"""`--data_parallel=True` through the port's four CLIs, on the CPU with
`--device=cpu`: two ranks, each a `python -m rohm_tpu_torch.cli.<name>`
process launched with the torchrun variables set (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT on a free localhost port), against the
single-process run of the same CLI. Each gives the single-process result:
the same pickle or checkpoint names and keys, the arrays within the stated
tolerance; and only rank 0 writes. Without the launcher variables the CLI
runs a mesh of one rank, bit for bit the single-process run.
"""

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_torch_cli_prox_egobody import _checkpoints

from rohm_tpu_torch.body import synthetic_model
import torch_dp_workers as workers
from test_torch_train_trajnet import is_gauge
from torch_dp_record import record_gradients

from rohm_tpu_torch.cli import test_amass_full, test_prox_egobody, train_posenet, train_trajnet
from rohm_tpu_torch.cli.common import run_data_parallel
from rohm_tpu_torch.parallel import mesh as mesh_mod
from rohm_tpu_torch.parallel.mesh import free_port
from rohm_tpu_torch.train.checkpoint import latest_checkpoint

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LR = 1e-4  # the train YAMLs' learning rate


def torchrun(module, argv: list, world: int = 2, timeout: float = 300, record: Path | None = None) -> list:
    """`python -m <module> argv` as `world` ranks with the torchrun
    variables set; every rank's combined output. With `record`, each rank
    runs through torch_dp_record.py, which saves its optimizer steps'
    gradients there. Fails on a nonzero exit or a rank that outlives
    `timeout` (it is killed)."""
    port = str(free_port())
    procs = []
    run = [str(ROOT / "tests" / "torch_dp_record.py"), module.__name__] if record else ["-m", module.__name__]
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
        if record:
            env["ROHM_GRAD_RECORD"] = str(record)
        procs.append(subprocess.Popen([sys.executable, *run, *argv, "--data_parallel=True"],
                                      cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


COLLECTIVE_TIMEOUT_S = 10  # forced on the spawned ranks below


@pytest.fixture
def two_cards(monkeypatch):
    """run_data_parallel's own start-up as on a host with two cards: the
    parent sees two devices and spawns two ranks (on the CPU here, gloo),
    whose collectives wait at most COLLECTIVE_TIMEOUT_S."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(mesh_mod, "DEFAULT_TIMEOUT_S", COLLECTIVE_TIMEOUT_S)
    for var in mesh_mod.LAUNCHER_VARS:
        monkeypatch.delenv(var, raising=False)


def test_spawned_job_outlasts_the_collective_timeout(two_cards):
    """--data_parallel=True with no launcher and two cards: the CLI spawns a
    rank per card. A job longer than the collective timeout runs to its
    end (the timeout bounds each collective, not the job), and the
    caller gets rank 0's result."""
    t0 = time.monotonic()
    out = run_data_parallel(workers.slow_job, SimpleNamespace(device="0", seconds=COLLECTIVE_TIMEOUT_S + 2,
                                                              lose_rank=None))
    assert time.monotonic() - t0 > COLLECTIVE_TIMEOUT_S
    assert out == {"rank": 0, "size": 2, "device": "cpu", "total": 3.0}


def test_spawned_job_with_a_lost_rank_fails(two_cards):
    """A spawned rank that exits without a result fails the run, long before
    the job would have ended."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exited with codes"):
        run_data_parallel(workers.slow_job, SimpleNamespace(device="0", seconds=300, lose_rank=1))
    assert time.monotonic() - t0 < 120


def _same_pickles(a: str, b: str, atol: float) -> None:
    with open(a, "rb") as f:
        ref = pickle.load(f)
    with open(b, "rb") as f:
        got = pickle.load(f)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert got[k].shape == v.shape, k
            np.testing.assert_allclose(got[k], v, atol=atol, rtol=0, err_msg=k)
        else:
            assert got[k] == v, k


AMASS = [
    f"--config={ROOT / 'cfg_files' / 'test_cfg' / 'amass_occ_leg_noise_3.yaml'}", "--synthetic_data=True",
    "--clip_len=17", "--batch_size=4", "--mid_dim=64", "--latent_dim=32", "--diffusion_steps_trajnet=3",
    "--diffusion_steps_posenet=4", "--load_noise=False", "--model_path_trajnet=",
    "--model_path_trajnet_control=", "--model_path_posenet=", "--device=cpu",
]


def test_amass_cli_two_ranks(tmp_path):
    """test_amass_full (3 clips in a bucket of 4, 2 per rank, the skating
    guidance over both): rank 0 writes the single-process pickle, same name
    and keys, arrays within 1e-4 (the guidance's sums in two parts;
    measured equal), and nothing else is written."""
    argv = AMASS + [f"--dataset_root={tmp_path / 'amass'}"]
    single, _ = test_amass_full.run(argv + [f"--save_root={tmp_path / 'single'}"])
    outs = torchrun(test_amass_full, argv + [f"--save_root={tmp_path / 'dp'}"])
    assert "results saved to" in outs[0] and "results saved to" not in outs[1]
    assert os.listdir(tmp_path / "dp") == [os.path.basename(single)]
    _same_pickles(single, str(tmp_path / "dp" / os.path.basename(single)), atol=1e-4)


@pytest.mark.parametrize("fused", ["False", "int8"])
def test_amass_cli_one_rank_is_the_single_process_run(tmp_path, fused):
    """Without launcher variables, --data_parallel=True on --device=cpu runs
    a mesh of one rank in this process: bit for bit the single-process
    pickle, in the plain and the int8 mode (the plain versions here)."""
    argv = AMASS + [f"--dataset_root={tmp_path / 'amass'}", f"--fused_posenet={fused}"]
    single, _ = test_amass_full.run(argv + [f"--save_root={tmp_path / 'single'}"])
    one, _ = test_amass_full.run(argv + [f"--save_root={tmp_path / 'dp'}", "--data_parallel=True"])
    assert os.path.basename(one) == os.path.basename(single)
    _same_pickles(single, one, atol=0.0)
    assert not torch.distributed.is_initialized()  # the CLI closed its group


def test_prox_cli_two_ranks(tmp_path):
    """test_prox_egobody on a synthetic PROX recording (3 windows in a bucket
    of 4), the 'prox' guidance (2-D reprojection and skating) over the
    global batch, 24 steps with early stop: rank 0 writes the
    single-process pickle, arrays within 1e-3 (the guidance sums in two
    parts, at weights 3e5 and 1e5), and nothing else is written."""
    from rohm_tpu_torch.data import write_synthetic_prox

    body = synthetic_model()
    ckpt = _checkpoints(tmp_path / "ckpt", body)
    write_synthetic_prox(str(tmp_path / "init"), str(tmp_path / "base"), body, n_frames=47)
    argv = [f"--config={ROOT / 'cfg_files' / 'test_cfg' / 'prox_rgb.yaml'}", "--device=cpu",
            f"--dataset_root={tmp_path / 'base'}", f"--init_root={tmp_path / 'init'}", "--clip_len=17",
            "--batch_size=4", "--mid_dim=64", "--latent_dim=32", "--diffusion_steps_trajnet=3",
            "--diffusion_steps_posenet=24", f"--model_path_trajnet={ckpt['trajnet']}",
            f"--model_path_trajnet_control={ckpt['trajnet_control']}", f"--model_path_posenet={ckpt['posenet']}",
            "--recording_name=MPH11_00034_01"]
    single, _ = test_prox_egobody.run(argv + [f"--save_root={tmp_path / 'single'}"])
    torchrun(test_prox_egobody, argv + [f"--save_root={tmp_path / 'dp'}"])
    rel = os.path.relpath(single, tmp_path / "single")
    assert [str(p.relative_to(tmp_path / "dp")) for p in (tmp_path / "dp").rglob("*") if p.is_file()] == [rel]
    _same_pickles(single, str(tmp_path / "dp" / rel), atol=1e-3)


TRAIN = {
    "posenet": (train_posenet, "posenet_train_stage1.yaml", ["--latent_dim=32", "--num_steps=4"]),
    "trajnet": (train_trajnet, "trajnet_train_vanilla_stage1.yaml", ["--mid_dim=64", "--num_steps=5"]),
}


def _logged_losses(logdir: Path) -> dict:
    """The last value of every '[train]'/'[eval]' line of a run log."""
    out = {}
    for line in "".join(p.read_text() for p in logdir.glob("run_*.log")).splitlines():
        for tag in ("[train]", "[eval]"):
            if f"] {tag}  " in line:
                key, val = line.split(f"] {tag}  ")[1].split(": ")
                out[f"{tag} {key}"] = float(val)
    return out


@pytest.mark.parametrize("net", sorted(TRAIN))
def test_train_cli_two_ranks(tmp_path, net):
    """train_posenet / train_trajnet (batch 2, 1 clip per rank; the skating
    loss and the eval during training over the global batch): rank 0 writes
    the one run directory, with the single-process files and checkpoint
    names and keys; the logged train and eval losses are the
    single-process ones (relative 1e-4); every rank's gradient at every
    step is the single-process one, and the checkpoint's parameters agree
    with it (the gates below)."""
    cli, cfg, extra = TRAIN[net]
    argv = [f"--config={ROOT / 'cfg_files' / 'train_cfg' / cfg}", "--synthetic_data=True", "--debug=True",
            "--clip_len=17", "--batch_size=2", "--diffusion_steps=6", "--save_interval=2", "--log_interval=3",
            "--seed=0", "--device=cpu", f"--dataset_root={tmp_path / 'amass'}", *extra]
    (tmp_path / "grads").mkdir()
    with record_gradients(str(tmp_path / "grads" / "single.npz")):
        loop = cli.main(argv + [f"--save_dir={tmp_path / 'single'}"])
    torchrun(cli, argv + [f"--save_dir={tmp_path / 'dp'}"], record=tmp_path / "grads")
    runs = os.listdir(tmp_path / "dp")
    assert len(runs) == 1
    dp_dir, single_dir = tmp_path / "dp" / runs[0], Path(loop.logdir)

    def files(d):
        return sorted(f if not f.startswith(("run_", "events.")) else f.split("_")[0].split(".")[0]
                      for f in os.listdir(d))

    assert files(dp_dir) == files(single_dir)
    ref, got = _logged_losses(single_dir), _logged_losses(dp_dir)
    assert sorted(got) == sorted(ref) and any(k.startswith("[eval]") for k in ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    # every rank's gradient at every optimizer step is the single-process
    # one, to 2e-3 of each tensor's largest entry (measured 6.1e-6 for
    # PoseNet, 4.3e-4 for TrajNet after 5 steps): a gradient off by any
    # factor fails; the gauge biases, whose gradient is 0 up to rounding,
    # excepted
    with np.load(tmp_path / "grads" / "single.npz") as z:
        ref = dict(z)
    assert len(ref) == loop.step * sum(1 for p in loop.model.parameters() if p.requires_grad)
    for rank in range(2):
        with np.load(tmp_path / "grads" / f"rank{rank}.npz") as z:
            got = dict(z)
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            if not is_gauge(k.split("/", 1)[1], v):
                assert np.abs(got[k] - v).max() <= 2e-3 * np.abs(v).max(), (rank, k)
    # the checkpoint: AdamW moves an entry by about lr a step whatever the
    # size of its gradient, so an entry whose gradient is near 0 may drift
    # by a few lr between two sound runs. So the gate counts entries: of all
    # the entries outside the gauge biases (and the attention's key biases,
    # whose gradient is also 0 up to rounding), at most 2 % are off by more
    # than 1e-3 lr (measured 1e-5 for PoseNet, 0.55 % for TrajNet); steps
    # on a wrong gradient move far more
    with np.load(latest_checkpoint(str(single_dir))) as a, np.load(latest_checkpoint(str(dp_dir))) as b:
        assert sorted(a.files) == sorted(b.files)
        off = total = 0
        for k in a.files:
            assert b[k].shape == a[k].shape and b[k].dtype == a[k].dtype, k
            if k.endswith("key/bias") or (k.endswith("Conv_0/bias") and "Conv1dBlock" in k and a[k].shape == (8,)):
                continue
            off += int((np.abs(b[k] - a[k]) > 1e-3 * LR + 2**-22 * np.abs(a[k])).sum())
            total += a[k].size
        assert off <= 0.02 * total, (off, total)
