"""The PROX driver: PROX/EgoBody video evaluation batches through the port's
`RohmPipeline.run_batch` with the 'prox' guidance (2-D keypoint
reprojection plus foot skating), early stop, the data's visibility masks
and iteration 2 conditioned on iteration 1's outputs; closed loop, one
caller.

A batch holds consecutive windows of several synthetic recordings
(harness/video.py), each recording with its own camera, so the batch
carries one camera per row (cam_r [B, 3, 3], cam_t [B, 3]).

Set-up (timed as setup_s, from the process start to the first timed batch):
the synthetic body and the recordings from the seed, the three nets built
as `cli.test_prox_egobody` builds them and filled from the seed on the
card, the pipeline, and a warm-up on short schedules (unguided, then
guided: the guidance runs at t <= 100, so every warm-up PoseNet step is
guided and both terms' first autograd calls fall in set-up).

The window and the check are recon.py's, with the chain's states read
through `sampler.step_observers`: at steps drawn from the seed (each
chain's first and last, two more of each TrajNet chain, two guided and two
unguided of each PoseNet chain) the reference (reference/prox.py)
recomputes x_{t-1} from the program's x_t, its guidance's gradient taken
at the program's pred_x0. A PoseNet chain's last step is t = 20 (early
stop) and its answer that step's pred_x0; run_batch must return the last
chains' answers. `start_gap`, `link_gap` and `step_gap` are held to the
cell's limits (port_bench/limits/<workload>.json).
"""

from __future__ import annotations

import sys
import time
from dataclasses import fields, replace

import numpy as np
import torch

from harness import counts, inputs
from harness.spec import BENCH_DIR, load_module
from harness.trace import LAUNCH_CALLS
from harness.video import CAMERA_KEYS, make_recordings
from reference.prox import ProxReferencePipeline, last_step, replay_draws
from reference.reprojection import PROX_T_THRESH as GUIDED_BELOW  # the PROX guidance runs at t <= 100

recon = load_module(BENCH_DIR / "drivers" / "recon.py")
derive, _sync, PinnedPool, row_gaps = recon.derive, recon._sync, recon.PinnedPool, recon.row_gaps
SEED_BODY, SEED_POOL, SEED_BATCH, SEED_CHECK, SEED_SAMPLE = (recon.SEED_BODY, recon.SEED_POOL, recon.SEED_BATCH,
                                                            recon.SEED_CHECK, recon.SEED_SAMPLE)
BATCH_KEYS = ("traj_cond", "traj_clean", "pose_noisy", "pose_mask") + CAMERA_KEYS


def log(msg: str) -> None:
    print(f"[prox] {msg}", file=sys.stderr, flush=True)


class Program(recon.Program):
    """The port under test, built as recon's is, with the 'prox' guidance;
    run_batch hands the pipeline the batch's cameras and keypoints."""

    def __init__(self, cfg: dict, body_arrays: dict, mean, std, seed: int, device):
        super().__init__(cfg, body_arrays, mean, std, seed, device)
        self.pipeline.grad_type = cfg["grad_type"] if cfg["cond_fn_with_grad"] else None
        self.pipeline.early_stop_steps = cfg["early_stop_steps"]

    def run_batch(self, batch: dict, generator: torch.Generator):
        return self.pipeline.run_batch(batch["traj_cond"], batch["traj_clean"], batch["pose_noisy"],
                                       batch["pose_mask"], batch["traj_mask"], generator,
                                       guidance_data={k: batch[k] for k in CAMERA_KEYS})


def step_plan(seed: int, k: int, cfg: dict, n: int = 2) -> dict:
    """The steps of batch k whose states the check reads, drawn from the
    seed: of every chain its first step (from x_T) and its last (its
    answer), and n more; of a PoseNet chain n guided (t <= GUIDED_BELOW)
    and n unguided."""
    rng = np.random.default_rng([seed % 2**64, SEED_CHECK, k])
    plan = {}
    for c in range(2 * cfg["sample_iter"]):
        steps = cfg["diffusion_steps_posenet"] if c % 2 else cfg["diffusion_steps_trajnet"]
        last = last_step(c, cfg["early_stop_steps"])
        ts = {steps - 1, last}
        ranges = ([range(last + 1, min(GUIDED_BELOW, steps - 2) + 1), range(GUIDED_BELOW + 1, steps - 1)]
                  if c % 2 else [range(1, steps - 1)])
        for r in ranges:
            if len(r):
                ts |= {int(t) for t in rng.choice(np.asarray(r), min(n, len(r)), replace=False)}
        plan[c] = ts
    return plan


def reserve_records(pool: PinnedPool, shapes: dict, plan: dict, batches: int) -> None:
    """Buffers for `batches` batches of records of a plan like `plan`: x_t
    and x_{t-1} at every planned step, pred_x0 at the PoseNet chains'
    guided ones; `shapes` maps a chain's parity to its state's (shape,
    dtype)."""
    need = {}
    for c, ts in plan.items():
        if c % 2 in shapes:
            n = 2 * len(ts) + (sum(t <= GUIDED_BELOW for t in ts) if c % 2 else 0)
            need[shapes[c % 2]] = need.get(shapes[c % 2], 0) + n * batches
    for (shape, dtype), n in need.items():
        pool.reserve(shape, dtype, n)


class StepObserver:
    """Reads the chain's states at planned steps: a callable in
    rohm_tpu_torch.diffusion.sampler.step_observers (called after every
    step of every chain with (sched, t, x_t, x_{t-1}, pred_x0 where the
    step was guided, else None)) that keeps (x_t, x_{t-1}, pred_x0 or
    None) of the armed plan's steps on the host, in the pool's buffers. Of
    every planned step t > 0 it also holds x_{t-1} on the device until the
    chain's next step, and keeps per row the largest |difference| between
    the x_t that step starts from and it. Unarmed it notes each chain
    parity's state shape in `shapes` (for the pool)."""

    def __init__(self, pool: PinnedPool | None = None):
        from rohm_tpu_torch.diffusion import sampler

        self._observers = sampler.step_observers
        self.pool = pool or PinnedPool()
        self.plan, self.chain, self.shapes, self._held = None, -1, {}, None

    def __enter__(self):
        self._observers.append(self)
        return self

    def __exit__(self, *exc):
        self._observers.remove(self)
        return False

    def arm(self, plan: dict) -> tuple[dict, dict]:
        self.plan, self.records, self.links, self.chain, self._held = plan, {}, {}, -1, None
        return self.records, self.links

    def disarm(self) -> None:
        self.plan = self._held = None

    def __call__(self, sched, t, x_t, x_prev, pred_x0):
        if t == sched.num_timesteps - 1:
            self.chain += 1
        if self.plan is None:
            self.shapes.setdefault(self.chain % 2, (tuple(x_t.shape), x_t.dtype))
            return
        if self._held is not None:
            key, prev = self._held
            self._held = None
            if key == (self.chain, t):
                self.links[key] = (x_t - prev).abs().flatten(1).amax(1)
        if t in self.plan.get(self.chain, ()):
            keep = self.pool.keep
            self.records[(self.chain, t)] = (keep(x_t), keep(x_prev), None if pred_x0 is None else keep(pred_x0))
            if t > 0:
                self._held = ((self.chain, t - 1), x_prev.detach().clone())


def _reference(cfg: dict, body_arrays: dict, mean, std, seed: int, device, posenet_mode: str,
               layouts: dict) -> ProxReferencePipeline:
    """recon's reference nets, schedules and body in the PROX pipeline."""
    base = recon._reference(cfg, body_arrays, mean, std, seed, device, posenet_mode, layouts)
    return ProxReferencePipeline(**{f.name: getattr(base, f.name) for f in fields(base)} | {
        "guided": False, "prox_guided": cfg["cond_fn_with_grad"], "early_stop_steps": cfg["early_stop_steps"]})


def answer(c: int, records: dict, stop: int):
    """Chain c's answer from its records: a PoseNet chain's last pred_x0
    (early stop), a TrajNet chain's x_{-1} from step 0; None if not read."""
    rec = records.get((c, last_step(c, stop)))
    return None if rec is None else rec[2] if c % 2 else rec[1]


def with_tf32(model_fn):
    """model_fn with TF32 products on while it runs (the PoseNet-only
    control: a PoseNet whose f32 products fell to one TF32 pass)."""
    def fn(x_t, t):
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            return model_fn(x_t, t)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return fn


def check_batch(ref, batch: dict, batch_seed: int, records: dict, links: dict, returned: tuple,
                plan_keys: list, stop: int, device, tf32_posenet: bool = False) -> dict:
    """One batch's check from the program's states, as recon.check_batch:
    the start (exact), the links (exact; every planned step's successor
    starts from its output, run_batch returns the last traj chain's x_{-1}
    and the last pose chain's early-stopped pred_x0) and, at every recorded
    step, x_{t-1} recomputed by the reference from the program's x_t. With
    `tf32_posenet` the reference's PoseNet runs with TF32 products, and
    nothing else does."""
    b = batch["traj_cond"].shape[0]
    link_keys = {(c, t - 1) for c, t in plan_keys if t > last_step(c, stop)}
    chains_done = sorted({c for c, _ in records})
    missing = sorted((set(plan_keys) - set(records)) | (link_keys - set(links)))
    missing += [(c, "answer") for c in chains_done if answer(c, records, stop) is None]
    if missing:
        log(f"check: the program's states at {missing[:8]} were never read (the step observers were bypassed)")
        inf = torch.full((b,), float("inf"))
        return {"start": float("inf"), "link": float("inf"), "step": inf, "rows": inf, "link_rows": inf,
                "by_chain": {}}
    outputs = {c: answer(c, records, stop) for c in chains_done}
    link_rows = torch.stack([links[k].double().cpu() for k in sorted(link_keys)]).amax(0)
    for c, out in zip(chains_done[-2:], reversed(returned)):  # the last traj chain, then the last pose chain
        link_rows = torch.maximum(link_rows, (out.double() - outputs[c].double()).abs().flatten(1).amax(1))
    outputs = {c: v.to(device) for c, v in outputs.items()}
    chains = [ref.chain(c, batch, outputs) for c in chains_done]
    if tf32_posenet:
        chains = [replace(ch, model_fn=with_tf32(ch.model_fn)) if c % 2 else ch for c, ch in zip(chains_done, chains)]
    wanted = set(records) | {(c, ch.sched.num_timesteps) for c, ch in zip(chains_done, chains)}
    gen = torch.Generator(device=device).manual_seed(batch_seed)
    draws = replay_draws(gen, [(ch.shape, ch.sched.num_timesteps, last_step(c, stop))
                               for c, ch in zip(chains_done, chains)], wanted)
    start, gaps, by_chain = 0.0, [], {}
    for c, ch in zip(chains_done, chains):
        steps = ch.sched.num_timesteps
        start = max(start, float((records[(c, steps - 1)][0].to(device) - draws[(c, steps)]).abs().max()))
        for (rc, t), (x_t, x_prev, pred) in sorted(records.items()):
            if rc != c:
                continue
            guide_x0 = None if pred is None else pred.to(device)
            g = row_gaps(x_prev.to(device), ref.step(ch, t, x_t.to(device), draws[(c, t)], guide_x0))
            gaps.append(g)
            if float(g.max()) > by_chain.get(c, (0.0,))[0]:
                by_chain[c] = (float(g.max()), t)
    return {"start": start, "link": float(link_rows.max()), "step": torch.cat(gaps),
            "rows": torch.stack(gaps).amax(0).cpu(), "link_rows": link_rows, "by_chain": by_chain}


def make_inputs(cfg: dict, traffic: dict, seed: int, device):
    """Body arrays, the pool of distinct batches on the device (each of
    `recordings_per_batch` recordings of `windows_per_recording` windows),
    and the stats."""
    body_arrays, ref_body = inputs.make_body(derive(seed, SEED_BODY), device, cfg["body"]["num_verts"])
    b, n = traffic["batch_size"], traffic["pool_batches"]
    recs, wins = traffic["recordings_per_batch"], traffic["windows_per_recording"]
    if recs * wins != b:
        raise ValueError(f"{recs} recordings of {wins} windows do not make a batch of {b}")
    noise = {"global_orient_deg": cfg["noise_std_smplx_global_rot"], "body_pose_deg": cfg["noise_std_smplx_body_rot"],
             "transl": cfg["noise_std_smplx_trans"], "betas": cfg["noise_std_smplx_betas"]}
    pool = make_recordings(ref_body, recs * n, wins, cfg["clip_len"], cfg["window_size"], derive(seed, SEED_POOL),
                           noise, device)
    traj_mask = torch.ones(b, cfg["clip_len"] - 1, device=device)
    batches = [{k: torch.as_tensor(pool[k][i * b:(i + 1) * b], device=device) for k in BATCH_KEYS}
               | {"traj_mask": traj_mask} for i in range(n)]
    return body_arrays, {"mean": pool["mean"], "std": pool["std"]}, batches


def timed_window(prog: Program, batches: list, cfg: dict, seed: int, seconds: float, trace: bool, device,
                 obs: StepObserver, slots: int):
    """recon.timed_window with this driver's plan and observer: batches back
    to back until the first boundary at or after `seconds` (one batch with
    `trace`), `slots` of them recorded, a uniform sample drawn from the
    seed. Returns (window seconds, [(index, generator seed, seconds,
    records or None, plan, links, (pose, traj) as returned)], tracer)."""
    done = []
    tracer = None
    pick = np.random.default_rng([seed % 2**64, SEED_SAMPLE])
    held = [None] * slots
    _sync(device)
    if trace:
        from harness.trace import DeviceTrace

        tracer = DeviceTrace().__enter__()
    t0 = time.perf_counter()
    k = 0
    while True:
        batch_seed = derive(seed, SEED_BATCH, k)
        plan = step_plan(seed, k, cfg)
        slot = k if k < slots else int(pick.integers(0, k + 1))
        records = links = None
        if slot < slots:
            if held[slot] is not None:
                dropped = done[held[slot]]
                obs.pool.give(dropped[3])
                done[held[slot]] = dropped[:3] + (None, None, None) + dropped[6:]
            held[slot] = k
            records, links = obs.arm(plan)
        gen = torch.Generator(device=device).manual_seed(batch_seed)
        tb = time.perf_counter()
        pose, traj = prog.run_batch(batches[k % len(batches)], gen)
        pose, traj = pose.cpu(), traj.cpu()  # waits for the batch (and its records): its boundary
        t_end = time.perf_counter()
        obs.disarm()
        done.append((k, batch_seed, t_end - tb, records, plan, links, (pose, traj)))
        log(f"batch {k}: {t_end - tb:.3f} s")
        k += 1
        if trace or t_end - t0 >= seconds:
            break
    if tracer is not None:
        tracer.__exit__(None, None, None)
    return t_end - t0, done, tracer


def run_checks(cfg, body_arrays, stats, batches, done, seed, device, layouts, posenet_mode=None,
               tf32: str = "off") -> dict:
    """The reference's check of every recorded batch (recon.run_checks),
    with TF32 products "off", on everywhere ("all") or in the PoseNet
    alone ("posenet")."""
    ref = _reference(cfg, body_arrays, stats["mean"], stats["std"], seed, device,
                     posenet_mode or cfg["fused_posenet"], layouts)
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32 == "all"
    try:
        per_batch = [check_batch(ref, batches[k % len(batches)], batch_seed, records, links, returned,
                                 [(c, t) for c, ts in plan.items() for t in ts], cfg["early_stop_steps"], device,
                                 tf32_posenet=tf32 == "posenet")
                     for k, batch_seed, _, records, plan, links, returned in done if records is not None]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    by_chain = {}
    for r in per_batch:
        for c, v in r["by_chain"].items():
            by_chain[c] = max(by_chain.get(c, v), v)
    return {"start": max(r["start"] for r in per_batch), "link": max(r["link"] for r in per_batch),
            "step": torch.cat([r["step"] for r in per_batch]), "by_chain": by_chain, "per_batch": per_batch}


def launch_times(tracer, t0: int, t1: int) -> list:
    """The host start times (ns, the profiler's clock) of the launch calls
    in the traced window, sorted."""
    events = tracer._prof.profiler.kineto_results.events()
    return sorted(e.start_ns() for e in events if e.name() in LAUNCH_CALLS and t0 <= e.start_ns() < t1)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, process_start: float) -> dict:
    cfg, traffic, limits = cell["config"], cell["traffic"], cell["limits"]
    if (cfg["infill_traj"] or cfg["mask_scheme"] != "video" or not cfg["early_stop"]
            or cfg["grad_type"] != "prox"):
        raise ValueError("the prox driver runs the 'video' scheme with early stop and the 'prox' guidance")
    if traffic["loop"] != "closed" or traffic["callers"] != 1:
        raise ValueError("the prox driver runs a closed loop with one caller")
    if device.type == "cuda":
        torch.zeros(1, device=device)  # the allocator's statistics exist once the context does
        torch.cuda.reset_peak_memory_stats(device)
    body_arrays, stats, batches = make_inputs(cfg, traffic, seed, device)
    prog = Program(cfg, body_arrays, stats["mean"], stats["std"], seed, device)
    from rohm_tpu_torch import ops

    b = traffic["batch_size"]
    slots = 1 if trace else traffic["checked_batches"]
    with StepObserver() as obs:
        prog.warm_up(batches[0], traffic, seed)  # also shows the observer each chain's state shape
        if device.type == "cuda":
            reserve_records(obs.pool, obs.shapes, step_plan(seed, 0, cfg), slots)
        _sync(device)
        setup_s = time.perf_counter() - process_start
        launches_before = ops.launch_counts()
        window_s, done, tracer = timed_window(prog, batches, cfg, seed, seconds, trace, device, obs, slots)
    if obs.pool.misses:
        log(f"{obs.pool.misses} records were taken outside the set-up's pinned pool")
    launches = {name: n - launches_before.get(name, 0) for name, n in ops.launch_counts().items()
                if n != launches_before.get(name, 0)}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    layouts = prog.layouts
    del prog
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    gaps = run_checks(cfg, body_arrays, stats, batches, done, seed, device, layouts)
    log(f"check: start {gaps['start']!r}; link {gaps['link']!r}; step gaps median {float(gaps['step'].median()):.3e} "
        f"max {float(gaps['step'].max()):.3e}; worst per chain (gap, step) {gaps['by_chain']}; "
        f"{time.perf_counter() - t_check:.1f} s")
    checks = {"start_gap": {"value": gaps["start"], "limit": limits["start_gap"]},
              "link_gap": {"value": gaps["link"], "limit": limits["link_gap"]},
              "step_gap": {"value": float(gaps["step"].max()), "limit": limits["step_gap"]}}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    failed = sum(b if not r["start"] <= limits["start_gap"] else
                 int((~((r["rows"] <= limits["step_gap"]) & (r["link_rows"] <= limits["link_gap"]))).sum())
                 for r in gaps["per_batch"])

    pose_steps = cfg["diffusion_steps_posenet"] - cfg["early_stop_steps"]
    result = {
        "correct": correct, "attempted": len(done) * b, "failed": failed, "checks": checks,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)},
        "end_to_end": {"recon_clips_per_s": len(done) * b / window_s, "setup_s": setup_s},
        "batch_seconds": [d[2] for d in done],
        "checked_batches": [d[0] for d in done if d[3] is not None],
    }
    if tracer is not None:
        s = tracer.summary
        result["device"].update({"busy_s": s["busy_s"], "window_s": s["window_s"]})
        result["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
        log(f"traced kernels (launches): {s['kernel_launches']}")
        log(f"traced: {s['launch_calls']} launch calls, busy {s['busy_s']:.3f} of {s['window_s']:.3f} s; "
            f"port launches {launches}")
        result["trace_context"] = {
            "trace": s, "batches": len(done), "port_launches": launches,
            "least_batch_s": counts.batch_least_seconds(
                cfg["fused_posenet"], b, cfg["clip_len"] - 2, cfg["clip_len"] - 1, pose_steps,
                cfg["diffusion_steps_trajnet"], cfg["sample_iter"], cfg["trajnet"]["traj_feat_dim"],
                cfg["trajnet"]["mid_dim"]),
            "kernel_bounds": counts.posenet_kernel_launches(cfg["fused_posenet"], b, cfg["clip_len"] - 1),
            "forwards": len(done) * cfg["sample_iter"] * pose_steps,
            "guided_steps": len(done) * cfg["sample_iter"] * (
                min(GUIDED_BELOW, cfg["diffusion_steps_posenet"] - 1) - cfg["early_stop_steps"] + 1),
            "launch_ns": launch_times(tracer, tracer.window_start_ns, tracer.window_end_ns),
        }
    return result


def run(cell: dict, args, process_start: float) -> dict:
    device = torch.device("cuda", 0)
    log(f"card: {recon.power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, process_start)
    log(f"setup_s {out['end_to_end']['setup_s']:.3f}; batches {out['batch_seconds']}")
    return out


def readings(cell: dict, seeds: list, device) -> list:
    """For each seed, one batch at the cell's own size through the program,
    then the check's numbers against the reference and against two controls
    (the reference in the precision below the configuration's, in the
    program's place, from the same states): TF32 products everywhere
    (`control_*`), and in the PoseNet alone (`posenet_control_*`), the
    program whose K1 products fell to one TF32 pass. No timing."""
    cfg, traffic = cell["config"], cell["traffic"]
    ctl = cfg["control"]
    out = []
    for seed in seeds:
        body_arrays, stats, batches = make_inputs(cfg, traffic, seed, device)
        prog = Program(cfg, body_arrays, stats["mean"], stats["std"], seed, device)
        with StepObserver() as obs:
            _, done, _ = timed_window(prog, batches, cfg, seed, 0.0, False, device, obs, 1)
        layouts = prog.layouts
        del prog
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = run_checks(cfg, body_arrays, stats, batches, done, seed, device, layouts)
        con = run_checks(cfg, body_arrays, stats, batches, done, seed, device, layouts,
                         posenet_mode=ctl["posenet"], tf32="all" if ctl["tf32"] else "off")
        pcon = run_checks(cfg, body_arrays, stats, batches, done, seed, device, layouts,
                          posenet_mode=ctl["posenet"], tf32="posenet")
        row = {"seed": seed, "start_gap": ref["start"], "link_gap": ref["link"], "step_gap": float(ref["step"].max()),
               "step_gap_median": float(ref["step"].median()), "by_chain": ref["by_chain"],
               "control_start_gap": con["start"], "control_step_gap": float(con["step"].max()),
               "control_by_chain": con["by_chain"], "posenet_control_step_gap": float(pcon["step"].max()),
               "posenet_control_by_chain": pcon["by_chain"], "batch_s": done[0][2]}
        log(f"reading {row}")
        out.append(row)
    return out
