"""Both train loops stop at --num_steps exactly (`_TrainLoop.run_loop`).

The JAX loops (rohm_tpu/train/loop.py) break out of the epoch only, so
where num_steps is a multiple of the batches per epoch they take one step
more (and may save once more). The port's loops do not. The PoseNet and
TrajNet CLIs run on the CPU on the debug synthetic tree (4 train clips,
batch 2: 2 batches per epoch) for 4 steps (a multiple: where the JAX loop
would take a fifth) and 5 (not one), saving every 2 steps with the
optimizer state: the loop's step, the checkpoints' names and the AdamW
step count in the last checkpoint must all be num_steps.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from rohm_tpu_torch.cli import train_posenet, train_trajnet
from rohm_tpu_torch.train.checkpoint import latest_checkpoint

torch.set_num_threads(1)

CFG = Path(__file__).resolve().parents[1] / "cfg_files" / "train_cfg"
NETS = {
    "posenet": (train_posenet, CFG / "posenet_train_stage1.yaml", ["--latent_dim=32"]),
    "trajnet": (train_trajnet, CFG / "trajnet_train_vanilla_stage1.yaml", ["--mid_dim=64"]),
}


@pytest.mark.parametrize("num_steps", [4, 5])
@pytest.mark.parametrize("net", list(NETS))
def test_loop_stops_at_num_steps(net, num_steps, tmp_path):
    cli, config, extra = NETS[net]
    loop = cli.main([
        f"--config={config}", "--synthetic_data=True", "--debug=True", "--clip_len=17", "--batch_size=2",
        "--diffusion_steps=6", f"--num_steps={num_steps}", "--save_interval=2", "--log_interval=100",
        "--seed=0", "--device=cpu", "--save_optimizer=True", f"--dataset_root={tmp_path / 'amass'}",
        f"--save_dir={tmp_path / 'runs'}", *extra,
    ])
    assert len(loop.train_dataset) // loop.batch_size == 2  # batches per epoch
    assert loop.step == num_steps and loop.state.step == num_steps
    files = sorted(f for f in os.listdir(loop.logdir) if f.startswith("model"))
    assert files == [f"model{s:09d}.npz" for s in sorted({2, 4, num_steps})]
    last = latest_checkpoint(loop.logdir)
    assert last.endswith(f"model{num_steps:09d}.npz")
    with np.load(last) as z:
        assert int(z["opt_state/count"]) == num_steps
