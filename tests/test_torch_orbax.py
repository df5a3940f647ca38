"""The JAX trainers' orbax checkpoints in the port (train/checkpoint.py::
read_orbax, through `load_checkpoint` and `cli/common.py::load_pretrained`).

For PoseNet, TrajNet and TrajControl at tiny widths: JAX-initialised params
and an AdamW state after one step on seeded gradients (the TrajControl one
through the JAX package's frozen-mask chain) are saved by the JAX package's
own `save_checkpoint` (an orbax directory) and, the same arrays, as the
`.npz` the port reads. The orbax route must give the port's modules and
optimizers bit for bit what the `.npz` route gives. Without tensorstore
the route raises ImportError naming it and the `.npz` route.
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

CLIP_LEN = 17
ARGS = SimpleNamespace(mid_dim=64, latent_dim=32, model_dtype="float32")
KINDS = ("posenet", "trajnet", "trajcontrol")


def _port_model(kind: str):
    from rohm_tpu_torch.cli.common import build_posenet, build_trajnet
    from rohm_tpu_torch.train.state import create_train_state, trajcontrol_frozen_mask

    model = build_posenet(ARGS, seed=1) if kind == "posenet" else build_trajnet(
        ARGS, 13, kind == "trajcontrol", seed=1)
    trainable = trajcontrol_frozen_mask(model) if kind == "trajcontrol" else None
    return model, create_train_state(model, trainable=trainable).optimizer


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """{kind: (orbax directory, .npz path)}."""
    import flax
    import jax

    from rohm_tpu.cli import common as jcommon
    from rohm_tpu.train.checkpoint import save_checkpoint
    from rohm_tpu.train.state import create_train_state, trajcontrol_frozen_mask

    tmp = tmp_path_factory.mktemp("orbax")
    rng = np.random.default_rng(0)
    out = {}
    for kind in KINDS:
        if kind == "posenet":
            params = jcommon.init_posenet_params(jcommon.build_posenet(ARGS), CLIP_LEN, 0)
        else:
            params = jcommon.init_trajnet_params(
                jcommon.build_trajnet(ARGS, 13, kind == "trajcontrol"), CLIP_LEN, 0)
        mask = trajcontrol_frozen_mask(params) if kind == "trajcontrol" else None
        state = create_train_state(params, lr=1e-3, frozen_mask=mask)
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        state = state.apply_gradients(grads=grads)
        run = tmp / kind
        run.mkdir()
        orbax_dir = save_checkpoint(str(run), 7, state.params, opt_state=state.opt_state)
        adam = state.opt_state[0][0] if kind == "trajcontrol" else state.opt_state[0]
        flat = {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(state.params, sep="/").items()}
        flat["opt_state/count"] = np.asarray(adam.count)
        for field in ("mu", "nu"):
            for k, v in flax.traverse_util.flatten_dict(getattr(adam, field), sep="/").items():
                flat[f"opt_state/{field}/{k}"] = np.asarray(v)
        npz = str(run / "model000000007.npz")
        np.savez(npz, **flat)
        out[kind] = (orbax_dir, npz)
    return out


def test_orbax_keys_are_the_npz_keys(saved):
    from rohm_tpu_torch.train.checkpoint import read_orbax

    for kind, (orbax_dir, npz) in saved.items():
        assert os.path.basename(orbax_dir) == "model000000007" and os.path.isdir(orbax_dir)
        got = read_orbax(orbax_dir)
        with np.load(npz) as z:
            want = dict(z)
        assert sorted(got) == sorted(want), kind
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), (kind, k)


@pytest.mark.parametrize("kind", KINDS)
def test_load_checkpoint_orbax_equals_npz(saved, kind):
    """Params and the AdamW state (step count, both moments of every
    parameter the optimizer holds: the ControlNet branch's alone for
    TrajControl) equal, bit for bit, and the step from the directory's name."""
    from rohm_tpu_torch.train.checkpoint import checkpoint_step, load_checkpoint

    orbax_dir, npz = saved[kind]
    loaded = []
    for path in (orbax_dir, npz):
        model, opt = _port_model(kind)
        assert load_checkpoint(path, model, opt)
        loaded.append((model, opt))
    (m_o, opt_o), (m_n, opt_n) = loaded
    sd_o, sd_n = m_o.state_dict(), m_n.state_dict()
    assert sd_o.keys() == sd_n.keys()
    assert all(torch.equal(sd_o[k], sd_n[k]) for k in sd_n)
    held = [p for g in opt_o.param_groups for p in g["params"]]
    assert held and len(opt_o.state) == len(held)
    if kind == "trajcontrol":  # the frozen backbone has no moments in the port
        names = {p: n for n, p in m_o.named_parameters()}
        assert all(names[p].startswith("controlnet.") for p in held)
    for p_o, p_n in zip(held, [p for g in opt_n.param_groups for p in g["params"]]):
        st_o, st_n = opt_o.state[p_o], opt_n.state[p_n]
        assert float(st_o["step"]) == float(st_n["step"]) == 1.0
        assert torch.equal(st_o["exp_avg"], st_n["exp_avg"]) and torch.equal(st_o["exp_avg_sq"], st_n["exp_avg_sq"])
    assert any(opt_o.state[p]["exp_avg"].abs().max() > 0 for p in held)
    assert checkpoint_step(orbax_dir) == checkpoint_step(orbax_dir + "/") == checkpoint_step(npz) == 7


@pytest.mark.parametrize("kind", KINDS)
def test_load_pretrained_orbax_equals_npz(saved, kind):
    from rohm_tpu_torch.cli.common import load_pretrained

    orbax_dir, npz = saved[kind]
    models = []
    for path in (orbax_dir, npz):
        model, _ = _port_model(kind)
        load_pretrained(model, path)
        models.append(model.state_dict())
    assert all(torch.equal(models[0][k], v) for k, v in models[1].items())


def test_no_tensorstore_raises(saved, monkeypatch):
    """Where tensorstore is absent (the card's machine) the route raises
    ImportError naming the package and the .npz route; a directory that is
    not an orbax checkpoint is a ValueError before that."""
    from rohm_tpu_torch.cli.common import load_pretrained
    from rohm_tpu_torch.train.checkpoint import read_orbax

    monkeypatch.setitem(sys.modules, "tensorstore", None)
    orbax_dir, _ = saved["posenet"]
    with pytest.raises(ImportError, match=r"tensorstore.*\.npz"):
        read_orbax(orbax_dir)
    model, _ = _port_model("posenet")
    with pytest.raises(ImportError, match="tensorstore"):
        load_pretrained(model, orbax_dir)
    with pytest.raises(ValueError, match="_METADATA"):
        read_orbax(os.path.dirname(orbax_dir))
