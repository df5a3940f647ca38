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
    package's own trained test holds (tests/test_e2e_parity_trained.py);
  - the final pose repr: the max |port - JAX| at most twice the JAX
    package's own max response to a 1e-5 perturbation of the TrajNet step
    noise (the lever of tests/test_e2e_parity.py::_perturbed_jax);
  - the fixture's contact margins (mean > 0.4, min > 0.2 per config).
Measured on the CPU: 8 of the 9 metrics within 3e-3 in both configs;
`ground_pene_dist_mm` (a mean over all toe-frames of the depth below the
floor, 0.13 mm on these 4 clips) 4.0e-2 apart here and 1.02e-2 in the legs
config, where the JAX package against its own lever moves it by up to
3.5e-2: its case fails at this bound, with the lever's value beside it.
The port's torch runs on 2 threads in these files (as fast here as 8 for
these small products, and lighter on a host shared by parallel test
workers).
"""

from __future__ import annotations

import numpy as np
import pytest

from tests.torch_trained import fixture as fx

N = 4
LEVER_EPS, LEVER_SEED, LEVER_RATIO = 1e-5, 7, 2.0
CONFIG = "flagship"
THREADS = 2


@pytest.fixture(scope="module")
def few_threads():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def lever_noise(noise: dict) -> dict:
    """The replayed noise with the TrajNet step noise moved by LEVER_EPS."""
    rng = np.random.default_rng(LEVER_SEED)
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
    import jax

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
    lever_pose = np.asarray(pipe.run_batch(*calls[0]["inputs"], jax.random.PRNGKey(0),
                                           preset_noise=lever_noise(noise))[0])
    lever_metrics = bf.score(lever_pose, b["pose_clean"], mean, std, cfg, body)
    return {"port": calls[0], "port_metrics": port_metrics, "pickle": pkl, "jax_pose": jpose, "jax_traj": jtraj,
            "jax_metrics": jax_metrics, "lever_pose": lever_pose, "lever_metrics": lever_metrics}


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
    or abs 1e-6 (fixture.JAX_REL, JAX_ABS); the JAX package's own value
    under the lever is printed beside them."""
    port, jax_m, lever = (runs[k][metric] for k in ("port_metrics", "jax_metrics", "lever_metrics"))
    rel = abs(port - jax_m) / max(abs(jax_m), 1e-9)
    lever_rel = abs(lever - jax_m) / max(abs(jax_m), 1e-9)
    print(f"[trained-parity {config}] {metric}: port {port:.6f} jax {jax_m:.6f} (rel {rel:.2e}); "
          f"jax under the lever {lever:.6f} (rel {lever_rel:.2e})")
    assert fx.metric_gaps({metric: port}, {metric: jax_m}, fx.JAX_REL, fx.JAX_ABS) == [], (
        f"{metric}: port {port} against JAX {jax_m}, rel {rel:.2e}; the JAX package's own response to the "
        f"lever: {lever} (rel {lever_rel:.2e})")


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
