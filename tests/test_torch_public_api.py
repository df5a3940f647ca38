"""The port's public surface against the JAX package's, on the CPU.

- Every top-level public function and class of each JAX module has a
  counterpart at the top level of the port's module of the same path, or
  stands in NO_COUNTERPART with the reason; every name of the `__all__` of
  the JAX `evals`, `diffusion` and `reprs` packages is exported by the
  port's package of the same name.
- The functions that were last to be ported, against the JAX package on
  the same seeded numpy inputs: `trajnet_root_errors`, `accel_magnitude`,
  `p_sample_step` (given the JAX key's noise) and `repr_to_smplx_params`.
- The data-parallel mesh raises, naming device="cpu", when it is given no
  device and finds no card: it never moves to the CPU by itself.
"""

import ast
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rohm_tpu.diffusion import make_schedule as jax_make_schedule
from rohm_tpu.diffusion import p_sample_step as jax_p_sample_step
from rohm_tpu.evals import metrics as jax_metrics
from rohm_tpu.geometry import aa_to_rotmat as jax_aa_to_rotmat
from rohm_tpu.reprs import repr_to_smplx_params as jax_repr_to_smplx_params
from rohm_tpu.reprs import split_repr as jax_split_repr
from rohm_tpu_torch.diffusion import make_schedule, p_sample_step
from rohm_tpu_torch.evals import metrics
from rohm_tpu_torch.geometry.rotations import aa_to_rotmat
from rohm_tpu_torch.parallel import mesh as mesh_mod
from rohm_tpu_torch.reprs import repr_to_smplx_params, split_repr

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

# "<module path>::<name>" -> why the port has no counterpart of that name
NO_COUNTERPART = {
    "cli/common.py::init_posenet_params": "flax-side: jits model.init; the port's nn.Module builds its own parameters",
    "cli/common.py::init_trajnet_params": "flax-side: jits model.init; the port's nn.Module builds its own parameters",
    "cli/test_amass_full.py::decode_joints": "flax-side: wraps numpy into jnp for recover_from_repr, which the port "
                                             "calls on tensors directly",
    "models/blocks.py::Im2colConv": "a flax submodule: the port's Conv1dBlock holds an nn.Conv1d",
    "models/blocks.py::TimeMlp": "a flax submodule: the port's TrajNet holds it as time_mlp (nn.Sequential)",
    "models/blocks.py::ZeroConv1x1": "a flax submodule: the port's zero_conv1x1 returns a zeroed nn.Conv1d",
    "models/trajnet.py::CondEncoder": "a flax submodule: the port's TrajNet holds its blocks (cond_enc1-4)",
    "ops/transformer_layer_train.py::reference_layer": "a JAX test oracle of the fused training layer; the port "
                                                       "holds its kernels to its own plain versions",
    "parallel/mesh.py::shard_spec": "a jax.sharding spec; the port's mesh is one process per card",
    "parallel/mesh.py::replicated": "a jax.sharding spec; the port's mesh is one process per card",
    "train/checkpoint.py::load_params_into": "flax-side: restores a params subtree; the port loads state_dicts "
                                             "(load_pretrained)",
    "utils/runlog.py::enable_compilation_cache": "XLA's persistent compile cache; eager PyTorch compiles nothing per "
                                                 "run, and the kernel library is built once into _build/",
}


def _top_level(path: Path, public_defs_only: bool) -> set:
    """The names a module binds at its top level (public defs and classes
    only, if asked)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif public_defs_only:
            continue
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in out if not n.startswith("_")} if public_defs_only else out


def test_every_jax_public_name_has_a_counterpart():
    missing = []
    for jax_path in sorted((ROOT / "rohm_tpu").rglob("*.py")):
        rel = jax_path.relative_to(ROOT / "rohm_tpu")
        port_path = ROOT / "rohm_tpu_torch" / rel
        assert port_path.exists(), f"rohm_tpu/{rel} has no counterpart module"
        have = _top_level(port_path, public_defs_only=False)
        missing += [f"{rel.as_posix()}::{name}" for name in sorted(_top_level(jax_path, public_defs_only=True))
                    if name not in have and f"{rel.as_posix()}::{name}" not in NO_COUNTERPART]
    assert missing == []


def test_no_counterpart_list_is_current():
    """Every excluded name still exists in the JAX package and still lacks
    a counterpart in the port."""
    for key in NO_COUNTERPART:
        rel, name = key.split("::")
        assert name in _top_level(ROOT / "rohm_tpu" / rel, public_defs_only=True), key
        assert name not in _top_level(ROOT / "rohm_tpu_torch" / rel, public_defs_only=False), key


@pytest.mark.parametrize("package", ["evals", "diffusion", "reprs"])
def test_package_exports_match_jax(package):
    jax_all = importlib.import_module(f"rohm_tpu.{package}").__all__
    port = importlib.import_module(f"rohm_tpu_torch.{package}")
    assert sorted(port.__all__) == sorted(jax_all)
    assert all(hasattr(port, name) for name in jax_all)


# ---------------------------------------------------------------------------
# the last functions ported
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_heading", [False, True])
def test_trajnet_root_errors_matches_jax(with_heading):
    rng = np.random.default_rng(0)
    clean, rec = (rng.normal(size=(3, 40, 3)).cumsum(1).astype(np.float32) for _ in range(2))
    angles = [rng.uniform(-np.pi, np.pi, (3, 40)).astype(np.float32) for _ in range(2)] if with_heading else []
    got = metrics.trajnet_root_errors(clean, rec, *angles)
    want = jax_metrics.trajnet_root_errors(clean, rec, *angles)
    assert sorted(got) == sorted(want) and ("root_rot_err_deg" in got) == with_heading
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)


def test_accel_magnitude_matches_jax():
    rec = np.random.default_rng(1).normal(size=(2, 30, 22, 3)).astype(np.float32)
    np.testing.assert_allclose(metrics.accel_magnitude(rec), jax_metrics.accel_magnitude(rec), rtol=1e-6)


@pytest.mark.parametrize("t", [0, 1, 37])
def test_p_sample_step_matches_jax(t):
    """One reverse step on a 50-step cosine schedule, with a guidance shift;
    the port takes the noise the JAX key draws. At t == 0 no noise is
    added, on either side."""
    rng = np.random.default_rng(t)
    shape = (2, 9, 13)
    pred, x_t, shift = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    key = jax.random.PRNGKey(t)
    want = np.asarray(jax_p_sample_step(jax_make_schedule("cosine", 50), jnp.asarray(pred), jnp.asarray(x_t),
                                        jnp.asarray(t), key, jnp.asarray(shift)))
    noise = torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32)))
    got = p_sample_step(make_schedule("cosine", 50), torch.from_numpy(pred), torch.from_numpy(x_t), t,
                        noise=noise, mean_shift=torch.from_numpy(shift))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    if t == 0:
        np.testing.assert_array_equal(
            got.numpy(), p_sample_step(make_schedule("cosine", 50), torch.from_numpy(pred), torch.from_numpy(x_t),
                                       0, generator=torch.Generator().manual_seed(3),
                                       mean_shift=torch.from_numpy(shift)).numpy())


def test_p_sample_step_draws_from_the_generator():
    """With no noise given, the step draws from the generator: the same
    seed gives the same step, and the step is the mean plus sigma_t times
    that draw."""
    sched = make_schedule("cosine", 50)
    x_t, pred = torch.randn(2, 5, 13, generator=torch.Generator().manual_seed(0)).unbind(0)
    a, b = (p_sample_step(sched, pred, x_t, 20, generator=torch.Generator().manual_seed(5)) for _ in range(2))
    noise = torch.randn(x_t.shape, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, p_sample_step(sched, pred, x_t, 20, noise=noise), rtol=0, atol=0)


def test_repr_to_smplx_params_matches_jax():
    """A random denormalized repr: translation and betas exactly, the
    axis-angle rotations as rotation matrices (the angle-axis of a rotation
    by pi has two signs) within 1e-5."""
    x = np.random.default_rng(2).normal(size=(2, 7, 294)).astype(np.float32)
    got = repr_to_smplx_params(split_repr(torch.from_numpy(x)))
    want = jax_repr_to_smplx_params(jax_split_repr(jnp.asarray(x)))
    assert sorted(got) == sorted(want)
    assert got["global_orient"].shape == (2, 7, 3) and got["body_pose"].shape == (2, 7, 63)
    for k in ("transl", "betas"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k, n in (("global_orient", 1), ("body_pose", 21)):
        mats = aa_to_rotmat(got[k].reshape(2, 7, n, 3)).numpy()
        jax_mats = np.asarray(jax_aa_to_rotmat(jnp.asarray(want[k]).reshape(2, 7, n, 3)))
        np.testing.assert_allclose(mats, jax_mats, atol=1e-5, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# the mesh asks for the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for var in mesh_mod.LAUNCHER_VARS + ("LOCAL_RANK",):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("entry", ["data_parallel_mesh", "spawn"])
def test_mesh_without_a_card_raises(no_card, entry):
    call = {"data_parallel_mesh": lambda: mesh_mod.data_parallel_mesh(),
            "spawn": lambda: mesh_mod.spawn(print, 2)}[entry]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()
    assert not torch.distributed.is_initialized()
