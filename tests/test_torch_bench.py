"""The port's bench (rohm_tpu_torch.bench, the port of root bench.py)
against the JAX bench's chain, on the CPU at a small size.

The JAX chain is built from the same calls as root bench.py (the int8 prep,
`embed_cond` once, `posenet_apply_prepared` per step in `p_sample_loop`),
with the Pallas kernels in interpret mode. The two PRNGs differ, so both
chains get the same x_T and per-step noise through the samplers' replay
hooks (`noise=`, `step_noise=`).
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rohm_tpu.diffusion import make_schedule as jax_make_schedule
from rohm_tpu.diffusion import p_sample_loop as jax_p_sample_loop
from rohm_tpu.models import PoseNet as FlaxPoseNet
from rohm_tpu.ops import embed_cond as jax_embed_cond
from rohm_tpu.ops import posenet_apply_prepared as jax_apply_prepared
from rohm_tpu.ops import prepare_posenet_int8 as jax_prepare_int8
from rohm_tpu_torch import bench
from rohm_tpu_torch.models import PoseNet
from rohm_tpu_torch.ops import prepare_posenet_int8
from rohm_tpu_torch.utils.convert_flax import posenet_state_dict

torch.set_num_threads(1)

D, FF, LAYERS, HEADS = 32, 64, 2, 2
BATCH, FRAMES, STEPS = 2, 15, 4
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def models():
    model = FlaxPoseNet(latent_dim=D, ff_size=FF, num_layers=LAYERS, num_heads=HEADS)
    x = jnp.zeros((BATCH, FRAMES, 294), jnp.float32)
    params = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), x, x,
                                                            jnp.zeros((BATCH,), jnp.int32)))
    port = PoseNet(latent_dim=D, ff_size=FF, num_layers=LAYERS, num_heads=HEADS)
    port.load_state_dict(posenet_state_dict(params))
    return params, port


def _jax_chain(params, mega: bool, noise, step_noise):
    """root bench.py:55-65 at the small size, with the replayed noise."""
    prep = jax_prepare_int8(params, num_layers=LAYERS, mega=mega)
    cond = jnp.zeros((BATCH, FRAMES, 294), jnp.float32)
    cond_emb = jax_embed_cond(prep, cond)
    sched = jax_make_schedule("cosine", STEPS)

    def model_fn(xt, t):
        return jax_apply_prepared(prep, xt, cond, t, num_heads=HEADS, cond_emb=cond_emb, interpret=True)

    return np.asarray(jax_p_sample_loop(model_fn, sched, (BATCH, FRAMES, 294), jax.random.PRNGKey(1),
                                        noise=jnp.asarray(noise), step_noise=jnp.asarray(step_noise)))


@pytest.mark.parametrize("mega", [False, True], ids=["per_layer", "mega"])
def test_bench_chain_matches_jax(models, mega):
    params, port = models
    rng = np.random.default_rng(7)
    noise = rng.standard_normal((BATCH, FRAMES, 294)).astype(np.float32)
    step_noise = rng.standard_normal((STEPS, BATCH, FRAMES, 294)).astype(np.float32)
    ref = _jax_chain(params, mega, noise, step_noise)
    prepare = (lambda p: prepare_posenet_int8(p, mega=True)) if mega else prepare_posenet_int8
    sample = bench.make_chain(port, prepare, BATCH, FRAMES, STEPS, "cpu")
    out = sample(torch.Generator().manual_seed(0), noise=torch.from_numpy(noise),
                 step_noise=torch.from_numpy(step_noise)).numpy()
    assert out.shape == (BATCH, FRAMES, 294) and np.isfinite(out).all()
    # Each step's PoseNet output is within the int8 gates of
    # tests/test_torch_models.py (6e-2 / 1e-2: int8 codes and bf16
    # roundings flipped by another f32 summation order); the posterior mean
    # takes it with a weight below 1 and the noise is shared, so four steps
    # stay inside the same gates.
    dev = np.abs(out - ref)
    assert dev.max() < 6e-2 and dev.mean() < 1e-2, (dev.max(), dev.mean())
    # the condition's traj dims pass through the model unchanged, so those
    # columns of the sample agree to float32 rounding of the posterior math
    np.testing.assert_allclose(out[..., :22], ref[..., :22], atol=1e-5, rtol=1e-5)


def test_mega_and_per_layer_chains_bit_identical_on_cpu(models):
    _, port = models
    outs = []
    for prepare in (prepare_posenet_int8, lambda p: prepare_posenet_int8(p, mega=True)):
        sample = bench.make_chain(port, prepare, BATCH, FRAMES, STEPS, "cpu")
        outs.append(sample(torch.Generator().manual_seed(3)))
    assert torch.equal(*outs)


def _root_bench_keys() -> set:
    """The keys of the dict root bench.py passes to json.dumps."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dumps({...}) in root bench.py")


def test_report_prints_one_json_line_with_the_root_bench_keys(models, capsys):
    _, port = models
    result = bench.run(batch=BATCH, frames=FRAMES, steps=3, device="cpu", posenet=port, n_rep=1)
    assert result["sample"].shape == (BATCH, FRAMES, 294)
    bench.report(result)
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == _root_bench_keys() == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "denoise_steps_per_sec_per_chip" and line["value"] > 0
    assert line["unit"] == f"steps/s (PoseNet {D}d x{LAYERS}L, bs={BATCH}, T={FRAMES})"
    assert line["vs_baseline"] == round(result["value"] / bench.REF_A100_STEPS_PER_SEC, 3)
    assert "A100 band" in err


def test_unit_at_the_defaults_is_root_bench_s():
    """At its defaults the port's unit string is root bench.py's."""
    assert (bench.BATCH, bench.T, bench.STEPS) == (32, 143, 1000)
    src = (ROOT / "bench.py").read_text()
    assert 'f"steps/s (PoseNet 512d x8L, bs={BATCH}, T={T})"' in src
    port = PoseNet()
    assert f"steps/s (PoseNet {port.latent_dim}d x{port.num_layers}L, bs={bench.BATCH}, T={bench.T})" == \
        "steps/s (PoseNet 512d x8L, bs=32, T=143)"


def test_main_refuses_a_device_other_than_the_card():
    with pytest.raises(SystemExit, match="CUDA"):
        bench.main(["--device", "cpu"])
