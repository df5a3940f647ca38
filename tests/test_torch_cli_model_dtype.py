"""The port's train CLIs with `--model_dtype=bfloat16` against the JAX
package's, on the CPU, on one synthetic tree at tiny widths (the modules'
and the steps' bf16 parity is in test_torch_model_dtype.py)."""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rohm_tpu.cli import train_posenet as jax_train_posenet
from rohm_tpu.cli import train_trajnet as jax_train_trajnet
from rohm_tpu.train.checkpoint import latest_checkpoint as jax_latest_checkpoint
from rohm_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from rohm_tpu_torch.cli import train_posenet, train_trajnet
from rohm_tpu_torch.train.checkpoint import latest_checkpoint

torch.set_num_threads(1)


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


ROOT = Path(__file__).resolve().parents[1]
CLI_CASES = {
    "posenet": (train_posenet, jax_train_posenet, "posenet_train_stage1.yaml",
                ["--latent_dim=32", "--num_steps=4"]),
    "trajnet": (train_trajnet, jax_train_trajnet, "trajnet_train_vanilla_stage1.yaml",
                ["--mid_dim=64", "--num_steps=5"]),
}


@pytest.mark.parametrize("net", sorted(CLI_CASES))
def test_train_cli_bf16_against_jax(net, tmp_path):
    """`--model_dtype=bfloat16` through both packages' train CLIs on one
    synthetic tree: the same run-directory files, params.json with the
    flag, the same stats, checkpoints with the same float32 keys and
    shapes, finite train and eval losses in both logs; and the port's
    modules ran in bf16 (the loop's model has dtype bfloat16). The two
    packages draw t, noise and masks from different generators, so the
    trained values are not compared."""
    port_cli, jax_cli, cfg, extra = CLI_CASES[net]
    common = [f"--config={ROOT / 'cfg_files' / 'train_cfg' / cfg}", "--synthetic_data=True", "--debug=True",
              "--clip_len=17", "--batch_size=2", "--diffusion_steps=6", "--log_interval=3", "--save_interval=100",
              "--seed=0", "--model_dtype=bfloat16", f"--dataset_root={tmp_path / 'amass'}", *extra]
    loop = port_cli.main(common + ["--device=cpu", f"--save_dir={tmp_path / 'port'}"])
    jloop = jax_cli.main(common + [f"--save_dir={tmp_path / 'jax'}"])
    assert loop.model.dtype == torch.bfloat16
    port_dir, jax_dir = Path(loop.logdir), Path(jloop.logdir)
    for name in ("AMASS_mean.pkl", "AMASS_std.pkl"):
        a, b = (np.load(d / name, allow_pickle=True) for d in (port_dir, jax_dir))
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6, err_msg=name)
    pj, jj = (json.loads((d / "params.json").read_text()) for d in (port_dir, jax_dir))
    assert pj["model_dtype"] == jj["model_dtype"] == "bfloat16"
    with np.load(latest_checkpoint(str(port_dir))) as z:
        port_ckpt = {k: z[k] for k in z.files if k.startswith("params/")}
    jax_ckpt = _flat(jax_load_checkpoint(jax_latest_checkpoint(str(jax_dir)))["params"])
    assert sorted(port_ckpt) == sorted(jax_ckpt)
    for k, v in jax_ckpt.items():
        assert port_ckpt[k].shape == v.shape and port_ckpt[k].dtype == np.asarray(v).dtype == np.float32
    for d in (port_dir, jax_dir):
        log = "".join(p.read_text() for p in d.glob("run_*.log"))
        for tag in ("[train]  loss:", "[eval]  loss:"):
            line = log.split(tag)[1].split("\n")[0]
            assert np.isfinite(float(line)), (d, tag)
