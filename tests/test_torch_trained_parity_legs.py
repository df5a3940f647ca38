"""The port against the JAX package with trained weights, the legs config
(amass_occ_leg_noise_3.yaml: mask `lower`, guided), through both CLIs.

Both packages' `test_amass_full` run the first 4 clips of the fixture's
tree (tests/torch_trained/) on the CPU with full chains and the fixture's
replayed noise, then both `eval_amass_full`s score the pickles. Held: the
pickles' input arrays to 1e-5 (FK and encoding in each framework), the
metrics within rel 1e-2 or abs 1e-6 (tests/test_e2e_parity_trained.py's
bound), and the final pose repr's max |port - JAX| at most twice the JAX
pipeline's own max response to a 1e-5 perturbation of its TrajNet step
noise (see test_torch_trained_parity.py, the flagship config's twin).
`ground_pene_dist_mm`, the mean depth below the floor over every
toe-frame of the 4 clips (0.13 mm, carried by a few toe-frames), moves
under that lever by more than rel 1e-2 in the JAX package itself: it
passes within max(rel 1e-2 |JAX|, abs 1e-6, twice the largest response
of the JAX value to the lever draws of LEVER_SEEDS), as in the flagship
file.
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest

from tests.test_torch_trained_parity import (  # noqa: F401 (few_threads: a fixture)
    LEVER_RATIO, assert_batch_is_the_fixtures, check_metric, few_threads, lever_draws, recording,
)
from tests.torch_trained import fixture as fx

N = 4
CONFIG = "legs"


@pytest.fixture(scope="module")
def runs(tmp_path_factory, few_threads):
    from tests.torch_trained import build_fixture as bf

    from rohm_tpu.cli import eval_amass_full as jeval
    from rohm_tpu.cli import test_amass_full as jcli
    from rohm_tpu.pipeline import RohmPipeline as JaxPipeline
    from rohm_tpu_torch.cli import eval_amass_full as teval
    from rohm_tpu_torch.cli import test_amass_full as tcli
    from rohm_tpu_torch.pipeline import RohmPipeline

    tmp = tmp_path_factory.mktemp("trained_legs")
    fx.write_tree(tmp / "amass")
    noise = fx.preset_noise(N)
    calls = {"jax": [], "port": []}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        mp.setattr(JaxPipeline, "run_batch", recording(JaxPipeline.run_batch, calls["jax"], noise))
        mp.setattr(RohmPipeline, "run_batch", recording(RohmPipeline.run_batch, calls["port"], noise))
        for side, main, extra in (("jax", jcli.main, []), ("port", tcli.main, ["--device=cpu"])):
            out[side] = {"pickle": main(fx.cli_argv(CONFIG, tmp / "amass", tmp / f"res_{side}", N) + extra)}
    out["jax"]["metrics"] = jeval.main(fx.eval_argv(CONFIG, out["jax"]["pickle"]))
    out["port"]["metrics"] = teval.main(fx.eval_argv(CONFIG, out["port"]["pickle"]))
    for side in out:
        assert len(calls[side]) == 1
        out[side].update(calls[side][0])
        with open(out[side]["pickle"], "rb") as f:
            out[side]["saved"] = pickle.load(f)
    j = out["jax"]
    pipe = j["pipeline"]
    out.update(lever_draws(pipe, j["inputs"], noise, lambda pose: bf.score(
        pose, j["inputs"][1], pipe.mean, pipe.std, fx.config(CONFIG), pipe.body_model)))
    out["port_metrics"], out["jax_metrics"] = out["port"]["metrics"], out["jax"]["metrics"]
    return out


def test_pickles_inputs_match(runs):
    """Same names and keys; the clean and noisy arrays (FK and the encoder in
    f32 in each framework, on the same tree and stats) to 1e-5; each CLI's
    run_batch inputs are the fixture's batch."""
    jax_s, port_s = runs["jax"]["saved"], runs["port"]["saved"]
    assert runs["port"]["pickle"].split("/")[-1] == runs["jax"]["pickle"].split("/")[-1]
    assert set(port_s) == set(jax_s)
    inputs = [k for k, v in jax_s.items() if isinstance(v, np.ndarray) and "_rec_" not in k and "repr_rec" not in k]
    assert len(inputs) == 4
    for key in sorted(inputs):
        assert port_s[key].shape == jax_s[key].shape == (N,) + port_s[key].shape[1:], key
        np.testing.assert_allclose(port_s[key], jax_s[key], atol=1e-5, rtol=0, err_msg=key)
    for side in ("jax", "port"):
        assert_batch_is_the_fixtures(runs[side]["inputs"], CONFIG)


def test_eval_metric_names_match(runs):
    assert set(runs["port_metrics"]) == set(runs["jax_metrics"]) == set(fx.METRICS)


@pytest.mark.parametrize("metric", fx.METRICS)
def test_eval_metric_matches_jax(runs, metric):
    check_metric(runs, metric, CONFIG)


def test_final_pose_within_the_jax_lever(runs):
    jpose = runs["jax"]["pose"]
    cross = np.abs(runs["port"]["pose"] - jpose)
    lever = np.abs(runs["lever_pose"] - jpose)
    print(f"[trained-parity {CONFIG}] final pose |port - jax| max {cross.max():.3e} mean {cross.mean():.3e}; "
          f"JAX lever max {lever.max():.3e} mean {lever.mean():.3e}")
    assert np.isfinite(runs["port"]["pose"]).all()
    assert cross.max() <= LEVER_RATIO * lever.max(), (cross.max(), lever.max())
