"""The released-weights route on the CPU: a torch state_dict saved with
`torch.save` (a random port PoseNet, TrajNet or TrajControl plus one
extra buffer key that no net uses, as a reference checkpoint may carry)
loads directly into the port (`load_pretrained`), and the JAX package
loads the same file after its `convert_torch_ckpt.convert_*` -> `.npz`;
both give the same outputs on one input. The port's converter CLI writes
the JAX converter CLI's `.npz`, and a missing key raises, naming it."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from rohm_tpu.cli import common as jcommon
from rohm_tpu.utils import convert_torch_ckpt as jconv
from rohm_tpu_torch.cli.common import build_posenet, build_trajnet, load_pretrained
from rohm_tpu_torch.utils import convert_torch_ckpt as tconv

torch.set_num_threads(1)

B, T = 2, 16
ARGS = SimpleNamespace(mid_dim=64, latent_dim=32)
EXTRA = "sequence_pos_encoder.pe"  # a buffer no net's parameters include


def _build(net: str, seed: int):
    if net == "posenet":
        return build_posenet(ARGS, seed=seed)
    return build_trajnet(ARGS, 13, net == "trajcontrol", seed=seed)


def _woken_state_dict(net: str) -> dict:
    """A random state_dict of the net, its all-zero tensors (TrajControl's
    zero convs) given small random values so every tensor counts."""
    rng = np.random.default_rng(2)
    sd = _build(net, seed=5).state_dict()
    return {k: torch.from_numpy(0.05 * rng.standard_normal(v.shape)).float() if not v.any() else v.clone()
            for k, v in sd.items()}


def _inputs(net: str):
    rng = np.random.default_rng(3)
    d = 294 if net == "posenet" else 13
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    cond = rng.standard_normal((B, T, d)).astype(np.float32)
    cc = rng.standard_normal((B, T, 272)).astype(np.float32) if net == "trajcontrol" else None
    return x, cond, cc, np.array([3, 77], np.int32)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Per net: the state_dict and its file (no extension, as the shipped
    YAMLs name the released checkpoints)."""
    tmp = tmp_path_factory.mktemp("pt")
    out = {}
    for net in ("posenet", "trajnet", "trajcontrol"):
        sd = _woken_state_dict(net)
        path = tmp / f"{net}_model000450000"
        torch.save({**sd, EXTRA: torch.randn(40, 1, 8)}, path)
        out[net] = (sd, str(path))
    return out


@pytest.mark.parametrize("net", ["posenet", "trajnet", "trajcontrol"])
def test_pt_route_matches_jax_after_its_converter(saved, net, tmp_path):
    """The port's model holds the file's tensors bit for bit (the extra key
    ignored with a warning); the JAX package's converter writes an `.npz`
    its strict `load_pretrained` reads; the two nets agree on one input:
    f32 on both sides, measured <= 1.2e-6 (all three),
    held as the model parity tests hold them (tests/test_torch_models.py)."""
    sd, path = saved[net]
    model = _build(net, seed=9)  # another init, overwritten by the load
    load_pretrained(model, path)
    got = model.state_dict()
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)

    raw = {k: v.numpy() for k, v in torch.load(path, weights_only=True).items()}
    if net == "posenet":
        flat = jconv.convert_posenet(raw, num_layers=8, num_heads=4, latent_dim=ARGS.latent_dim)
        jmodel = jcommon.build_posenet(ARGS)
    else:
        flat = jconv.convert_trajnet(raw, trajcontrol=net == "trajcontrol")
        jmodel = jcommon.build_trajnet(ARGS, 13, net == "trajcontrol")
    npz = tmp_path / "converted.npz"
    np.savez(npz, **flat)
    like = jax.tree.map(np.zeros_like, _unflatten(tconv.convert_posenet(sd) if net == "posenet"
                                                  else tconv.convert_trajnet(sd, net == "trajcontrol")))
    params = jcommon.load_pretrained(like, str(npz))

    x, cond, cc, t = _inputs(net)
    kw = {"control_cond": cc} if cc is not None else {}
    ref = np.asarray(jax.jit(jmodel.apply)(params, x, cond, t, **kw))
    tkw = {"control_cond": torch.from_numpy(cc)} if cc is not None else {}
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(t), **tkw).numpy()
    atol, rtol = (2e-5, 1e-5) if net == "posenet" else (1e-4, 1e-4)
    np.testing.assert_allclose(out, ref, atol=atol, rtol=rtol)


def _unflatten(flat: dict) -> dict:
    tree = {}
    for key, v in flat.items():
        node = tree
        *scopes, leaf = key.split("/")
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = v
    return tree


@pytest.mark.parametrize("net", ["trajnet", "trajcontrol", "posenet"])
def test_converter_cli_writes_the_jax_npz(saved, net, tmp_path):
    """Both converter CLIs on one file: the same keys, equal arrays. The
    JAX converter's PoseNet is fixed at the released 512 x 8 layers, so
    that case converts a full-width PoseNet."""
    if net == "posenet":
        sd = build_posenet(SimpleNamespace(latent_dim=512), seed=4).state_dict()
        path = tmp_path / "posenet_model000200000"
        torch.save({**sd, EXTRA: torch.randn(40, 1, 512)}, path)
        path = str(path)
    else:
        path = saved[net][1]
    flags = [f"--model={'posenet' if net == 'posenet' else 'trajnet'}", f"--torch_path={path}",
             f"--trajcontrol={net == 'trajcontrol'}"]
    jconv.main(flags + [f"--out_path={tmp_path / 'jax.npz'}"])
    tconv.main(flags + [f"--out_path={tmp_path / 'torch.npz'}"])
    with np.load(tmp_path / "jax.npz") as zj, np.load(tmp_path / "torch.npz") as zt:
        keys = sorted(zt.files)
        assert keys == sorted(zj.files)
        assert not any(EXTRA in k for k in keys)
        for k in keys:
            assert zt[k].dtype == zj[k].dtype and np.array_equal(zt[k], zj[k]), k
    if net == "trajnet":
        # a vanilla conversion of a TrajControl file skips the branch, as the JAX converter does
        tconv.main(["--model=trajnet", f"--torch_path={saved['trajcontrol'][1]}",
                    f"--out_path={tmp_path / 'branchless.npz'}"])
        with np.load(tmp_path / "branchless.npz") as z:
            assert sorted(z.files) == keys


@pytest.mark.parametrize("net", ["posenet", "trajcontrol"])
def test_missing_key_raises(saved, net, tmp_path):
    sd, _ = saved[net]
    gone = sorted(sd)[len(sd) // 2]
    path = tmp_path / "partial.pt"
    torch.save({k: v for k, v in sd.items() if k != gone}, path)
    with pytest.raises(KeyError, match=gone.replace(".", r"\.")):
        load_pretrained(_build(net, seed=9), str(path))


@pytest.mark.parametrize("name", ["diff_enc1.blocks.0.block.9.weight", "diff_enc2.time_mlp.2.bias"])
def test_unplaceable_net_key_raises_at_conversion(saved, name):
    """A key inside one of TrajNet's modules that the mapping cannot place
    is an error of the conversion, not a key to skip."""
    sd, _ = saved["trajnet"]
    with pytest.raises(KeyError):
        tconv.convert_trajnet({**sd, name: torch.zeros(3)})
