"""The port against the JAX package with trained weights, the flagship
config: `test_amass_full --infill_traj=True`, mask `full`, guided.

The weights are tests/torch_trained/'s, trained by the JAX package
(build_fixture.py): contact outputs saturate there, so the skating
guidance's 0.5 threshold no longer sits under the contacts, as it does with
random weights (where the guided infill run was 3.05 apart between the
frameworks, tests/test_torch_cli_infill.py). The port's CLI runs the first
4 clips of the fixture's tree on the CPU with full chains (2 iterations of
100 TrajNet and 1000 PoseNet steps) and the fixture's replayed noise; its
`run_batch` inputs go through the JAX RohmPipeline(infill_traj=True) called
directly (the JAX CLI drops the flag), with the same params, stats and
noise. Held:
  - the inputs: the CLI's batch is the fixture's (FK in each framework);
  - the eval metrics: within rel 1e-2 or abs 1e-6, the bound the JAX
    package's own trained test holds (tests/test_e2e_parity_trained.py),
    but for `ground_pene_dist_mm` (below);
  - the final pose repr: the max |port - JAX| at most twice the JAX
    package's own max response to a 1e-5 perturbation of the TrajNet step
    noise (the lever of tests/test_e2e_parity.py::_perturbed_jax), drawn
    with the first of LEVER_SEEDS;
  - the fixture's contact margins (mean > 0.4, min > 0.2 per config).
`ground_pene_dist_mm` is the mean over every toe-frame of the 4 clips of
the depth below the floor: 0.13 mm here, carried by a few toe-frames, so
the JAX package's own value moves by up to 3.9e-2 (rel) under the 1e-5
lever, more than the rel 1e-2 bound. For this metric alone the port
passes when |port - JAX| <= max(JAX_REL |JAX|, JAX_ABS, LEVER_RATIO
max_seed |lever_seed - JAX|) over the lever draws of LEVER_SEEDS (each one
more JAX run_batch and score); its failure message gives the port's gap
beside each draw's response. Measured on the CPU: 8 of the 9 metrics
within 3e-3 in both configs, `ground_pene_dist_mm` 4.0e-2 apart here and
1.02e-2 in the legs config. The port's torch runs on 2 threads in these
files (as fast here as 8 for these small products, and lighter on a host
shared by parallel test workers).
"""

from __future__ import annotations

import numpy as np
import pytest

from tests.torch_trained import fixture as fx

N = 4
LEVER_EPS, LEVER_SEEDS, LEVER_RATIO = 1e-5, (7, 8, 9), 2.0
# the one metric gated against the spread of the JAX package's own lever
# response as well (module docstring)
LEVER_GATED = "ground_pene_dist_mm"
CONFIG = "flagship"
THREADS = 2


@pytest.fixture(scope="module")
def few_threads():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def lever_noise(noise: dict, seed: int = LEVER_SEEDS[0]) -> dict:
    """The replayed noise with the TrajNet step noise moved by LEVER_EPS."""
    rng = np.random.default_rng(seed)
    out = dict(noise)
    out["traj_step"] = noise["traj_step"] + np.float32(LEVER_EPS) * rng.standard_normal(
        noise["traj_step"].shape).astype(np.float32)
    return out


def assert_batch_is_the_fixtures(inputs: list, config: str) -> None:
    """run_batch's inputs as a CLI built them from the fixture's tree against
    the fixture's batch (built by the JAX package's dataset): FK and
    encoding in f32 in each framework, compared in the repr's own units
    (the stats' std undone) to 1e-5; the masks exactly."""
    from rohm_tpu.reprs.schema import TRAJ_ABS_INDEX
    from rohm_tpu.reprs.stats import load_stats

    _, std = load_stats(str(fx.FIXTURE_DIR))
    scale = {"traj_cond": std[np.asarray(TRAJ_ABS_INDEX)], "traj_clean": std, "pose_noisy": std}
    b = fx.batch(config, len(inputs[0]))
    for name, got in zip(fx.BATCH_INPUTS, inputs):
        if name in scale:
            err = np.abs((got - b[name]) * scale[name]).max()
            assert err <= 1e-5, (name, err)
        else:
            np.testing.assert_array_equal(got, b[name], err_msg=name)


def recording(run_batch, calls: list, noise: dict):
    """run_batch with `noise` replayed, each call's pipeline, inputs and
    outputs kept."""
    def wrapped(self, *args, **kw):
        kw["preset_noise"] = noise
        pose, traj = run_batch(self, *args, **kw)
        calls.append({"pipeline": self, "inputs": [np.array(a) for a in args[:5]],
                      "pose": np.asarray(pose), "traj": np.asarray(traj)})
        return pose, traj
    return wrapped


@pytest.fixture(scope="module")
def runs(tmp_path_factory, few_threads):
    from tests.torch_trained import build_fixture as bf

    from rohm_tpu.body import synthetic_model as jax_synthetic_model
    from rohm_tpu.reprs.stats import load_stats
    from rohm_tpu_torch.cli import eval_amass_full as teval
    from rohm_tpu_torch.cli import test_amass_full as tcli
    from rohm_tpu_torch.pipeline import RohmPipeline

    tmp = tmp_path_factory.mktemp("trained_flagship")
    fx.write_tree(tmp / "amass")
    noise = fx.preset_noise(N)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        mp.setattr(RohmPipeline, "run_batch", recording(RohmPipeline.run_batch, calls, noise))
        pkl = tcli.main(fx.cli_argv(CONFIG, tmp / "amass", tmp / "res", N) + ["--device=cpu"])
    port_metrics = teval.main(fx.eval_argv(CONFIG, pkl))
    assert len(calls) == 1

    cfg = fx.config(CONFIG)
    mean, std = load_stats(str(fx.FIXTURE_DIR))
    body = jax_synthetic_model()
    pipe = bf.pipeline(bf.load_params(), cfg, mean, std, body)
    b = dict(zip(fx.BATCH_INPUTS, calls[0]["inputs"]))
    b["pose_clean"] = b["traj_clean"]  # the CLI's pose and traj views share the clean repr
    jpose, jtraj, jax_metrics = bf.run_and_score(pipe, b, noise, cfg, body)
    lever = lever_draws(pipe, calls[0]["inputs"], noise,
                        lambda pose: bf.score(pose, b["pose_clean"], mean, std, cfg, body))
    return {"port": calls[0], "port_metrics": port_metrics, "pickle": pkl, "jax_pose": jpose, "jax_traj": jtraj,
            "jax_metrics": jax_metrics, **lever}


def lever_draws(pipe, inputs: list, noise: dict, score) -> dict:
    """The JAX pipeline again on `inputs` under each seed's lever
    (lever_noise), scored: the first seed's final pose ("lever_pose") and
    every seed's metrics ("lever_metrics_by_seed")."""
    import jax

    out = {"lever_metrics_by_seed": {}}
    for seed in LEVER_SEEDS:
        pose = np.asarray(pipe.run_batch(*inputs, jax.random.PRNGKey(0), preset_noise=lever_noise(noise, seed))[0])
        out["lever_metrics_by_seed"][seed] = score(pose)
        if seed == LEVER_SEEDS[0]:
            out["lever_pose"] = pose
    return out


def test_fixture_contacts_saturate():
    """The fixture's PoseNet, x0 prediction at t = 25: |c - 0.5| mean > 0.4
    and min > 0.2 under each config's evaluation mask, and in every clip."""
    margins = fx.meta()["contact_margin"]
    for name in fx.CONFIGS:
        m = margins[name]
        assert m["mean"] > 0.4 and m["min"] > 0.2 and min(m["per_clip_min"]) > 0.2, (name, m)


def test_cli_batch_is_the_fixtures(runs):
    pipe = runs["port"]["pipeline"]
    assert pipe.infill_traj is True and pipe.grad_type == "amass" and pipe.mask_scheme == "full"
    assert_batch_is_the_fixtures(runs["port"]["inputs"], CONFIG)


def check_metric(runs: dict, metric: str, config: str) -> None:
    """One eval metric of the port against the JAX package's within rel 1e-2
    or abs 1e-6 (fixture.JAX_REL, JAX_ABS); for LEVER_GATED also within
    LEVER_RATIO times the largest response of the JAX package's own value
    to the lever draws (module docstring). Each draw's value is printed
    beside the port's gap."""
    port, jax_m = runs["port_metrics"][metric], runs["jax_metrics"][metric]
    gap = abs(port - jax_m)
    scale = max(abs(jax_m), 1e-9)
    draws = {seed: m[metric] for seed, m in runs["lever_metrics_by_seed"].items()}
    responses = ", ".join(f"seed {seed} {v:.6f} (rel {abs(v - jax_m) / scale:.2e})" for seed, v in draws.items())
    report = (f"{metric}: port {port:.6f} jax {jax_m:.6f}, gap {gap:.3e} (rel {gap / scale:.2e}); "
              f"jax under the lever: {responses}")
    print(f"[trained-parity {config}] {report}")
    bound = max(fx.JAX_REL * abs(jax_m), fx.JAX_ABS)
    if metric == LEVER_GATED:
        bound = max(bound, LEVER_RATIO * max(abs(v - jax_m) for v in draws.values()))
        assert gap <= bound, f"{report}; bound {bound:.3e}"
    else:
        assert fx.metric_gaps({metric: port}, {metric: jax_m}, fx.JAX_REL, fx.JAX_ABS) == [], report


def test_metric_names_match(runs):
    assert set(runs["port_metrics"]) == set(runs["jax_metrics"]) == set(fx.METRICS)


@pytest.mark.parametrize("metric", fx.METRICS)
def test_metric_matches_jax(runs, metric):
    check_metric(runs, metric, CONFIG)


def test_final_pose_within_the_jax_lever(runs):
    cross = np.abs(runs["port"]["pose"] - runs["jax_pose"])
    lever = np.abs(runs["lever_pose"] - runs["jax_pose"])
    traj = np.abs(runs["port"]["traj"] - runs["jax_traj"]).max()
    print(f"[trained-parity {CONFIG}] final pose |port - jax| max {cross.max():.3e} mean {cross.mean():.3e}; "
          f"JAX lever max {lever.max():.3e} mean {lever.mean():.3e}; final traj max {traj:.3e}")
    assert np.isfinite(runs["port"]["pose"]).all()
    assert cross.max() <= LEVER_RATIO * lever.max(), (cross.max(), lever.max())
