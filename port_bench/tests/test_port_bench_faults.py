"""The check refuses a broken timed path: a run at the tiny preset on the
CPU (the harness's look for a card skipped) with the port broken
underneath comes out not correct, once per fault that a reconstruction
cell can have. (It runs on one card: no exchange between chips to drop.)"""

import time

import pytest
import torch
from conftest import tiny
from harness import spec

CPU = torch.device("cpu")
SEED = 2**31 + 4242


def run_tiny(bench, workload="amass_leg3_int8.b256", batch_size=2):
    cell = tiny(spec.cell(workload, bench))
    cell["traffic"]["batch_size"] = batch_size
    return spec.driver(cell["config"]).run_cell(cell, SEED, 0.0, False, CPU, time.perf_counter())


def test_sound_run_is_correct(bench, few_threads):
    out = run_tiny(bench)
    assert out["correct"], out["checks"]


def test_step_returning_its_state_unchanged(bench, few_threads, monkeypatch):
    from rohm_tpu_torch.diffusion import sampler

    monkeypatch.setattr(sampler, "p_sample_step", lambda sched, pred, x_t, t, **kw: x_t)
    out = run_tiny(bench)
    assert not out["correct"], out["checks"]


def test_half_the_batch_left_out(bench, few_threads, monkeypatch):
    import rohm_tpu_torch.ops as ops

    orig = ops.posenet_apply_prepared

    def half(prep, x_t, cond, t, **kw):
        n = x_t.shape[0] // 2
        kw.pop("cond_emb", None)
        out = torch.zeros_like(x_t)
        out[:n] = orig(prep, x_t[:n], cond[:n], t, **kw)
        return out

    monkeypatch.setattr(ops, "posenet_apply_prepared", half)
    out = run_tiny(bench, batch_size=4)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("chain", [1, 2, 3])
def test_an_answer_altered_where_it_is_produced(bench, few_threads, monkeypatch, chain):
    """One clip's answer of a chain (its last step's output) moved by one
    standard deviation of its values."""
    from rohm_tpu_torch.diffusion import sampler

    orig = sampler.p_sample_step
    seen = {"chain": -1}

    def altered(sched, pred, x_t, t, **kw):
        if t == sched.num_timesteps - 1:
            seen["chain"] += 1
        out = orig(sched, pred, x_t, t, **kw)
        if t == 0 and seen["chain"] % 4 == chain and sched.num_timesteps > 3:
            out = out.clone()
            out[0] += out[0].std()
        return out

    monkeypatch.setattr(sampler, "p_sample_step", altered)
    out = run_tiny(bench)
    assert not out["correct"], out["checks"]


def test_loop_dropping_the_steps_result(bench, few_threads, monkeypatch):
    """A sampler loop that calls the posterior step but never takes its
    result: every recorded step is sound on its own and each chain answers
    one step from x_T; only the links between steps show it (on the f32
    cell, whose recorded steps agree with the reference to rounding)."""
    import rohm_tpu_torch.pipeline as pipeline
    from rohm_tpu_torch.diffusion import sampler

    def stuck_loop(model_fn, sched, shape, generator, guidance=(), early_stop_steps=0, mesh=None, **kw):
        def randn():
            return torch.randn(shape, generator=generator, device=generator.device)

        x = randn()
        tmap = sched.timestep_map.tolist()
        for t in range(sched.num_timesteps - 1, -1, -1):
            pred = model_fn(x, tmap[t])
            shift = sampler._guidance_shift(guidance, pred, t, sched.posterior_variance[t]) if guidance else None
            out = sampler.p_sample_step(sched, pred, x, t, noise=randn(), mean_shift=0.0 if shift is None else shift)
        return out

    monkeypatch.setattr(pipeline, "p_sample_loop", stuck_loop)
    out = run_tiny(bench, workload="amass_leg3_f32.b64")
    assert not out["correct"], out["checks"]
    checks = out["checks"]
    assert checks["link_gap"]["value"] > checks["link_gap"]["limit"]
    assert checks["start_gap"]["value"] == 0 and checks["step_gap"]["value"] <= checks["step_gap"]["limit"]


@pytest.mark.parametrize("workload", ["amass_leg3_int8.b256", "amass_leg3_f32.b64"])
def test_guidance_left_out(bench, few_threads, monkeypatch, workload):
    """The skating guidance dropped from the PoseNet chains: the reference
    adds its shift at every guided step the program ran unguided."""
    import rohm_tpu_torch.pipeline as pipeline

    monkeypatch.setattr(pipeline.RohmPipeline, "_guidance", lambda self, guidance_data: ())
    out = run_tiny(bench, workload=workload)
    assert not out["correct"], out["checks"]
