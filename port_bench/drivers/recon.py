"""The reconstruction driver: AMASS evaluation batches through the port's
`RohmPipeline.run_batch`, closed loop, one caller.

Set-up (timed as setup_s, from the process start to the first timed batch):
the synthetic body and the input pool from the seed, the three nets built
as `cli.test_amass_full` builds them and filled from the seed on the card,
the pipeline, and a warm-up that runs the same modules at the cell's
shapes on short schedules (guided and unguided), so every kernel is built
and every shape seen before the window.

The window: batches back to back, each with its own generator seed, each
ending when its outputs are on the host; it ends at the first batch
boundary at or after --seconds. recon_clips_per_s is the clips completed
over the window's length. With --trace, one batch is profiled instead.

The check, after the window, with the program's state freed: in the
completed batches (all of them, or a sample of the traffic's
`checked_batches` drawn from the seed where the window holds more) the
states at steps drawn from the seed (read through StepRecorder while the
batch ran, copied as they are taken into page-locked host buffers that
set-up allocated) are recomputed one step by the plain reference
(port_bench/reference) from the program's own x_t, on the same inputs,
weights, body and replayed draws; each such step's successor must start from its output, and
run_batch must return the last chains' outputs. `start_gap`, `link_gap`
and `step_gap` are held to the cell's limits
(port_bench/limits/<workload>.json).
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from harness import counts, inputs, weights
from reference.pipeline import replay_draws

# what each seed derived from --seed feeds
(SEED_BODY, SEED_POOL, SEED_TRAJNET, SEED_TRAJCONTROL, SEED_POSENET, SEED_BATCH, SEED_CHECK, SEED_WARM,
 SEED_SAMPLE) = range(9)
GUIDED_BELOW = 50  # the AMASS guidance runs at t <= 50


def derive(seed: int, *tags: int) -> int:
    return int(np.random.default_rng([seed % 2**64, *tags]).integers(0, 2**62))


def log(msg: str) -> None:
    print(f"[recon] {msg}", file=sys.stderr, flush=True)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The port under test: its nets, body model and pipeline, built from
    the configuration."""

    def __init__(self, cfg: dict, body_arrays: dict, mean, std, seed: int, device):
        from rohm_tpu_torch.body.model import SMPLX_PARENTS, make_model
        from rohm_tpu_torch.cli.common import build_posenet, build_trajnet
        from rohm_tpu_torch.diffusion.schedule import make_schedule
        from rohm_tpu_torch.pipeline import RohmPipeline

        self._make_schedule = make_schedule
        self.cfg, self.device = cfg, device
        args = _NetArgs(cfg)
        tf = cfg["trajnet"]["traj_feat_dim"]
        with torch.device(device):
            nets = {"trajnet": build_trajnet(args, tf, False), "trajcontrol": build_trajnet(args, tf, True),
                    "posenet": build_posenet(args)}
        for name, tag in (("trajnet", SEED_TRAJNET), ("trajcontrol", SEED_TRAJCONTROL), ("posenet", SEED_POSENET)):
            nets[name] = nets[name].to(device).eval()
            weights.fill(nets[name], derive(seed, tag))
        self.layouts = {k: weights.layout(v) for k, v in nets.items()}
        self.pipeline = RohmPipeline(
            trajnet=nets["trajnet"], trajcontrol=nets["trajcontrol"], posenet=nets["posenet"],
            sched_traj=self.schedule(cfg["diffusion_steps_trajnet"]),
            sched_pose=self.schedule(cfg["diffusion_steps_posenet"]),
            body_model=make_model(body_arrays, SMPLX_PARENTS, device),
            mean=torch.as_tensor(mean, device=device), std=torch.as_tensor(std, device=device),
            repr_abs_only=cfg["repr_abs_only"], traj_feat_dim=tf, sample_iter=cfg["sample_iter"],
            early_stop=cfg["early_stop"], grad_type="amass" if cfg["cond_fn_with_grad"] else None,
            mask_scheme=cfg["mask_scheme"], input_noise=cfg["input_noise"], infill_traj=cfg["infill_traj"],
            iter2_cond_noisy_pose=cfg["iter2_cond_noisy_pose"],
            iter2_cond_noisy_traj=cfg["iter2_cond_noisy_traj"], fused_posenet=cfg["fused_posenet"],
        )

    def schedule(self, steps: int):
        return self._make_schedule(self.cfg["noise_schedule"], steps, self.cfg["timestep_respacing_eval"],
                                   device=self.device)

    def run_batch(self, batch: dict, generator: torch.Generator):
        return self.pipeline.run_batch(batch["traj_cond"], batch["traj_clean"], batch["pose_noisy"],
                                       batch["pose_mask"], batch["traj_mask"], generator)

    def warm_up(self, batch: dict, traffic: dict, seed: int) -> None:
        """Both chains on short schedules at the cell's shapes, unguided and
        guided (the guidance runs at t <= 50 only, so a short schedule is
        guided at every step)."""
        p = self.pipeline
        full = (p.sched_traj, p.sched_pose, p.grad_type)
        p.sched_traj = self.schedule(traffic["warmup_traj_steps"])
        p.sched_pose = self.schedule(traffic["warmup_pose_steps"])
        try:
            for grad_type in (None, full[2]):
                p.grad_type = grad_type
                gen = torch.Generator(device=self.device).manual_seed(derive(seed, SEED_WARM))
                [o.cpu() for o in self.run_batch(batch, gen)]
        finally:
            p.sched_traj, p.sched_pose, p.grad_type = full
        _sync(self.device)


class _NetArgs:
    """The attributes cli.common's build functions read from parsed CLI args."""

    def __init__(self, cfg: dict):
        self.mid_dim = cfg["trajnet"]["mid_dim"]
        self.latent_dim = cfg["posenet"]["latent_dim"]
        self.model_dtype = "float32"


def _reference(cfg: dict, body_arrays: dict, mean, std, seed: int, device, posenet_mode: str, layouts: dict):
    from reference.body import SMPLX_PARENTS, make_model
    from reference.pipeline import ReferencePipeline
    from reference.posenet import PoseNet
    from reference.schedule import make_schedule
    from reference.trajnet import TrajNet

    tf, t, pn = cfg["trajnet"]["traj_feat_dim"], cfg["trajnet"], cfg["posenet"]
    with torch.device(device):
        nets = {
            "trajnet": TrajNet(tf, tf, t["mid_dim"], t["time_dim"], trajcontrol=False),
            "trajcontrol": TrajNet(tf, tf, t["mid_dim"], t["time_dim"], trajcontrol=True),
            "posenet": PoseNet(latent_dim=pn["latent_dim"], ff_size=pn["ff_size"], num_layers=pn["num_layers"],
                               num_heads=pn["num_heads"]),
        }
    for name, tag in (("trajnet", SEED_TRAJNET), ("trajcontrol", SEED_TRAJCONTROL), ("posenet", SEED_POSENET)):
        nets[name] = nets[name].to(device).eval()
        weights.fill(nets[name], derive(seed, tag), expected_layout=layouts[name])
    return ReferencePipeline(
        trajnet=nets["trajnet"], trajcontrol=nets["trajcontrol"], posenet=nets["posenet"],
        sched_traj=make_schedule(cfg["noise_schedule"], cfg["diffusion_steps_trajnet"], device=device),
        sched_pose=make_schedule(cfg["noise_schedule"], cfg["diffusion_steps_posenet"], device=device),
        body_model=make_model(body_arrays, SMPLX_PARENTS, device),
        mean=torch.as_tensor(mean, device=device), std=torch.as_tensor(std, device=device),
        posenet_mode=posenet_mode, repr_abs_only=cfg["repr_abs_only"], traj_feat_dim=tf,
        sample_iter=cfg["sample_iter"], guided=cfg["cond_fn_with_grad"], mask_scheme=cfg["mask_scheme"],
        input_noise=cfg["input_noise"], iter2_cond_noisy_pose=cfg["iter2_cond_noisy_pose"],
        iter2_cond_noisy_traj=cfg["iter2_cond_noisy_traj"],
    )


def row_gaps(out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per row (clip): ||out - ref|| / ||ref|| over all its frames and dims."""
    diff = (out.double() - ref.double()).flatten(1).norm(dim=1)
    return diff / ref.double().flatten(1).norm(dim=1).clamp_min(1e-30)


def step_plan(seed: int, k: int, traj_steps: int, pose_steps: int, sample_iter: int,
              guided_below: int = GUIDED_BELOW, n: int = 2) -> dict:
    """The steps of batch k whose states the check reads, drawn from the
    seed: of every chain its first step (from x_T) and its last (its
    answer), and n more; of a PoseNet chain n guided (t <= guided_below)
    and n unguided."""
    rng = np.random.default_rng([seed % 2**64, SEED_CHECK, k])
    plan = {}
    for c in range(2 * sample_iter):
        steps = pose_steps if c % 2 else traj_steps
        ts = {steps - 1, 0}
        ranges = ([range(1, min(guided_below, steps - 2) + 1), range(guided_below + 1, steps - 1)] if c % 2
                  else [range(1, steps - 1)])
        for r in ranges:
            if len(r):
                ts |= {int(t) for t in rng.choice(np.asarray(r), min(n, len(r)), replace=False)}
        plan[c] = ts
    return plan


class PinnedPool:
    """Page-locked host buffers for the check's records, allocated in
    set-up. Allocating them as the records are taken (cudaHostAlloc, tens
    of milliseconds for a state of the b256 cell) held the host up inside
    the window while the card ran dry. A buffer goes back to the pool when
    its batch's records are dropped; a shape the pool lacks is allocated as
    before, and counted in `misses`."""

    def __init__(self):
        self.free, self.misses = {}, 0

    def reserve(self, shape: tuple, dtype: torch.dtype, n: int) -> None:
        """n buffers of one shape, carved from one allocation."""
        if n:
            slab = torch.empty((n, *shape), dtype=dtype, pin_memory=True)
            self.free.setdefault((tuple(shape), dtype), []).extend(slab.unbind(0))

    def take(self, x: torch.Tensor) -> torch.Tensor:
        bufs = self.free.get((tuple(x.shape), x.dtype))
        if bufs:
            return bufs.pop()
        self.misses += 1
        return torch.empty(x.shape, dtype=x.dtype, pin_memory=True)

    def give(self, records: dict) -> None:
        for rec in records.values():
            for buf in rec:
                if buf is not None and buf.is_pinned():
                    self.free.setdefault((tuple(buf.shape), buf.dtype), []).append(buf)

    def keep(self, x: torch.Tensor) -> torch.Tensor:
        """A copy of x as it stands at this point of its stream, off the
        card, without waiting on the device."""
        if x.device.type != "cuda":
            return x.detach().clone()
        return self.take(x).copy_(x, non_blocking=True)


def reserve_records(pool: PinnedPool, shapes: dict, plan: dict, batches: int) -> None:
    """Buffers for `batches` batches of records of a plan like `plan`: x_t
    and x_{t-1} at every planned step, pred_x0 at the PoseNet chains'
    guided ones; `shapes` maps a chain's parity (0 TrajNet, 1 PoseNet) to
    its state's (shape, dtype)."""
    need = {}
    for c, ts in plan.items():
        if c % 2 in shapes:
            n = 2 * len(ts) + (sum(t <= GUIDED_BELOW for t in ts) if c % 2 else 0)
            need[shapes[c % 2]] = need.get(shapes[c % 2], 0) + n * batches
    for (shape, dtype), n in need.items():
        pool.reserve(shape, dtype, n)


class StepRecorder:
    """Reads the chain's states at planned steps: wraps the port's posterior
    step (rohm_tpu_torch.diffusion.sampler.p_sample_step, called once per
    step of every chain) and keeps (x_t, x_{t-1}, pred_x0 where the step
    is guided, else None) of the armed plan's steps on the host, in the
    pool's buffers. Of every planned step t > 0 it also holds x_{t-1} on
    the device until step t-1 is called, and keeps per row the largest
    |difference| between the x_t that step t-1 starts from and it (0 for a
    chain that moves forward). Unarmed it passes the call through and
    notes each chain parity's state shape in `shapes` (for the pool)."""

    def __init__(self, pool: PinnedPool | None = None):
        from rohm_tpu_torch.diffusion import sampler

        self._sampler = sampler
        self._orig = sampler.p_sample_step
        self.pool = pool or PinnedPool()
        self.plan, self.chain, self.shapes = None, -1, {}

    def __enter__(self):
        self._sampler.p_sample_step = self
        return self

    def __exit__(self, *exc):
        self._sampler.p_sample_step = self._orig
        return False

    def arm(self, plan: dict) -> tuple[dict, dict]:
        self.plan, self.records, self.links, self.chain, self._held = plan, {}, {}, -1, None
        return self.records, self.links

    def disarm(self) -> None:
        self.plan = self._held = None

    def __call__(self, sched, pred_xstart, x_t, t, noise=None, generator=None, mean_shift=0.0):
        out = self._orig(sched, pred_xstart, x_t, t, noise=noise, generator=generator, mean_shift=mean_shift)
        if t == sched.num_timesteps - 1:
            self.chain += 1
        if self.plan is None:
            self.shapes.setdefault(self.chain % 2, (tuple(x_t.shape), x_t.dtype))
            return out
        if self._held is not None:
            key, prev = self._held
            self._held = None
            if key == (self.chain, t):
                self.links[key] = (x_t - prev).abs().flatten(1).amax(1)
        if t in self.plan.get(self.chain, ()):
            guided = torch.is_tensor(mean_shift)
            keep = self.pool.keep
            self.records[(self.chain, t)] = (keep(x_t), keep(out), keep(pred_xstart) if guided else None)
            if t > 0:
                self._held = ((self.chain, t - 1), out.detach().clone())
        return out


def check_batch(ref, inputs: dict, batch_seed: int, records: dict, links: dict, returned: tuple,
                plan_keys: list, device) -> dict:
    """One batch's check from the program's states: the start (each chain's
    x_T against the reference's replay of the generator; exact); the links
    (every planned step's successor starts from its output, and run_batch
    returns the last traj and pose chains' outputs; exact); and, at every
    recorded step, x_{t-1} recomputed by the reference from the program's
    x_t (its own denoiser on a condition it builds from the program's
    earlier chain outputs, its guidance's gradient taken at the program's
    pred_x0, its posterior step, its draw) against the program's. Returns
    {"start": max |diff|, "link": max |diff|, "step": per-row gaps of every
    recorded step, "rows": each clip's worst step gap, "link_rows": each
    clip's worst link, "by_chain": worst per chain}."""
    b = inputs["traj_cond"].shape[0]
    link_keys = {(c, t - 1) for c, t in plan_keys if t > 0}
    missing = sorted((set(plan_keys) - set(records)) | (link_keys - set(links)))
    if missing:
        log(f"check: the program's states at {missing[:8]} were never read (the step wrapper was bypassed)")
        inf = torch.full((b,), float("inf"))
        return {"start": float("inf"), "link": float("inf"), "step": inf, "rows": inf, "link_rows": inf,
                "by_chain": {}}
    chains_done = sorted({c for c, _ in records})
    link_rows = torch.stack([links[k].double().cpu() for k in sorted(link_keys)]).amax(0)
    for c, out in zip(chains_done[-2:], reversed(returned)):  # the last traj chain, then the last pose chain
        gap = (out.double() - records[(c, 0)][1].double()).abs().flatten(1).amax(1)
        link_rows = torch.maximum(link_rows, gap)
    outputs = {c: records[(c, 0)][1].to(device) for c in chains_done}
    chains = [ref.chain(c, inputs, outputs) for c in chains_done]
    wanted = {(c, t) for c, t in records} | {(c, ch.sched.num_timesteps) for c, ch in zip(chains_done, chains)}
    gen = torch.Generator(device=device).manual_seed(batch_seed)
    draws = replay_draws(gen, [(ch.shape, ch.sched.num_timesteps) for ch in chains], wanted)
    start, gaps, by_chain = 0.0, [], {}
    for c, ch in zip(chains_done, chains):
        steps = ch.sched.num_timesteps
        x_first = records[(c, steps - 1)][0].to(device)
        start = max(start, float((x_first - draws[(c, steps)]).abs().max()))
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
    """Body arrays, the pool of distinct batches on the device, and the stats."""
    body_arrays, ref_body = inputs.make_body(derive(seed, SEED_BODY), device, cfg["body"]["num_verts"])
    b, n = traffic["batch_size"], traffic["pool_batches"]
    noise = {"global_orient_deg": cfg["noise_std_smplx_global_rot"], "body_pose_deg": cfg["noise_std_smplx_body_rot"],
             "transl": cfg["noise_std_smplx_trans"], "betas": cfg["noise_std_smplx_betas"]}
    pool = inputs.make_pool(ref_body, b * n, cfg["clip_len"], derive(seed, SEED_POOL), noise, device)
    mask = torch.as_tensor(inputs.lower_pose_mask(b, cfg["clip_len"] - 2), device=device)
    traj_mask = torch.ones(b, cfg["clip_len"] - 1, device=device)
    batches = [{k: torch.as_tensor(pool[k][i * b:(i + 1) * b], device=device)
                for k in ("traj_cond", "traj_clean", "pose_noisy")} | {"pose_mask": mask, "traj_mask": traj_mask}
               for i in range(n)]
    return body_arrays, {"mean": pool["mean"], "std": pool["std"]}, batches


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def timed_window(prog: Program, batches: list, cfg: dict, seed: int, seconds: float, trace: bool, device,
                 rec: StepRecorder, slots: int):
    """Batches back to back until the first boundary at or after `seconds`
    (one batch with `trace`). The first `slots` batches are recorded at
    their planned steps; each later batch k replaces a recorded one with
    probability slots / (k + 1), drawn from the seed, so the recorded
    batches are a uniform sample of the window's. Returns (window seconds,
    [(index, generator seed, seconds, records or None, plan, links, (pose,
    traj) as returned)], tracer)."""
    done = []
    tracer = None
    pick = np.random.default_rng([seed % 2**64, SEED_SAMPLE])
    held = [None] * slots  # the index in `done` of the batch whose records each slot holds
    _sync(device)
    if trace:
        from harness.trace import DeviceTrace

        tracer = DeviceTrace().__enter__()
    t0 = time.perf_counter()
    k = 0
    while True:
        batch_seed = derive(seed, SEED_BATCH, k)
        plan = step_plan(seed, k, cfg["diffusion_steps_trajnet"], cfg["diffusion_steps_posenet"],
                         cfg["sample_iter"])
        slot = k if k < slots else int(pick.integers(0, k + 1))
        records = links = None
        if slot < slots:
            if held[slot] is not None:
                dropped = done[held[slot]]
                rec.pool.give(dropped[3])
                done[held[slot]] = dropped[:3] + (None, None, None) + dropped[6:]
            held[slot] = k
            records, links = rec.arm(plan)
        gen = torch.Generator(device=device).manual_seed(batch_seed)
        tb = time.perf_counter()
        pose, traj = prog.run_batch(batches[k % len(batches)], gen)
        pose, traj = pose.cpu(), traj.cpu()  # waits for the batch (and its records): its boundary
        t_end = time.perf_counter()
        rec.disarm()
        done.append((k, batch_seed, t_end - tb, records, plan, links, (pose, traj)))
        log(f"batch {k}: {t_end - tb:.3f} s")
        k += 1
        if trace or t_end - t0 >= seconds:
            break
    if tracer is not None:
        tracer.__exit__(None, None, None)
    return t_end - t0, done, tracer


def run_checks(cfg, body_arrays, stats, batches, done, seed, device, layouts, posenet_mode=None,
               tf32: bool = False) -> dict:
    """The reference's check of every recorded batch: the worst start
    difference, the worst link and the per-row step gaps of all recorded
    steps."""
    ref = _reference(cfg, body_arrays, stats["mean"], stats["std"], seed, device,
                     posenet_mode or cfg["fused_posenet"], layouts)
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        per_batch = [check_batch(ref, batches[k % len(batches)], batch_seed, records, links, returned,
                                 [(c, t) for c, ts in plan.items() for t in ts], device)
                     for k, batch_seed, _, records, plan, links, returned in done if records is not None]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    by_chain = {}
    for r in per_batch:
        for c, v in r["by_chain"].items():
            by_chain[c] = max(by_chain.get(c, v), v)
    return {"start": max(r["start"] for r in per_batch), "link": max(r["link"] for r in per_batch),
            "step": torch.cat([r["step"] for r in per_batch]),
            "by_chain": by_chain, "per_batch": per_batch}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, process_start: float) -> dict:
    cfg, traffic, limits = cell["config"], cell["traffic"], cell["limits"]
    if cfg["infill_traj"] or cfg["mask_scheme"] != "lower" or cfg["early_stop"]:
        raise ValueError("the recon driver runs the 'lower' scheme without infill or early stop")
    if traffic["loop"] != "closed" or traffic["callers"] != 1:
        raise ValueError("the recon driver runs a closed loop with one caller")
    if device.type == "cuda":
        torch.zeros(1, device=device)  # the allocator's statistics exist once the context does
        torch.cuda.reset_peak_memory_stats(device)
    body_arrays, stats, batches = make_inputs(cfg, traffic, seed, device)
    prog = Program(cfg, body_arrays, stats["mean"], stats["std"], seed, device)
    from rohm_tpu_torch import ops

    b = traffic["batch_size"]
    slots = 1 if trace else traffic["checked_batches"]
    with StepRecorder() as rec:
        prog.warm_up(batches[0], traffic, seed)  # also shows the recorder each chain's state shape
        if device.type == "cuda":
            reserve_records(rec.pool, rec.shapes, step_plan(seed, 0, cfg["diffusion_steps_trajnet"],
                            cfg["diffusion_steps_posenet"], cfg["sample_iter"]), slots)
        _sync(device)
        setup_s = time.perf_counter() - process_start
        launches_before = ops.launch_counts()
        window_s, done, tracer = timed_window(prog, batches, cfg, seed, seconds, trace, device, rec, slots)
    if rec.pool.misses:
        log(f"{rec.pool.misses} records were taken outside the set-up's pinned pool")
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
    # a clip fails when a recorded step or a link of it is over its limit (NaN
    # too), or its batch's start is
    failed = sum(b if not r["start"] <= limits["start_gap"] else
                 int((~((r["rows"] <= limits["step_gap"]) & (r["link_rows"] <= limits["link_gap"]))).sum())
                 for r in gaps["per_batch"])

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
                cfg["fused_posenet"], b, cfg["clip_len"] - 2, cfg["clip_len"] - 1,
                cfg["diffusion_steps_posenet"], cfg["diffusion_steps_trajnet"], cfg["sample_iter"],
                cfg["trajnet"]["traj_feat_dim"], cfg["trajnet"]["mid_dim"]),
            "kernel_bounds": counts.posenet_kernel_launches(cfg["fused_posenet"], b, cfg["clip_len"] - 1),
            "forwards": len(done) * cfg["sample_iter"] * cfg["diffusion_steps_posenet"],
        }
    return result


def run(cell: dict, args, process_start: float) -> dict:
    device = torch.device("cuda", 0)
    log(f"card: {power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, process_start)
    log(f"setup_s {out['end_to_end']['setup_s']:.3f}; batches {out['batch_seconds']}")
    return out


def readings(cell: dict, seeds: list, device) -> list:
    """For each seed, one batch at the cell's own size through the program,
    then the check's numbers against the reference and against the control
    (the reference in the precision below the configuration's, in the
    program's place, from the same states). No timing."""
    cfg, traffic = cell["config"], cell["traffic"]
    ctl = cfg["control"]
    out = []
    for seed in seeds:
        body_arrays, stats, batches = make_inputs(cfg, traffic, seed, device)
        prog = Program(cfg, body_arrays, stats["mean"], stats["std"], seed, device)
        with StepRecorder() as rec:
            _, done, _ = timed_window(prog, batches, cfg, seed, 0.0, False, device, rec, 1)
        layouts = prog.layouts
        del prog
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = run_checks(cfg, body_arrays, stats, batches, done, seed, device, layouts)
        con = run_checks(cfg, body_arrays, stats, batches, done, seed, device, layouts,
                         posenet_mode=ctl["posenet"], tf32=ctl["tf32"])
        row = {"seed": seed, "start_gap": ref["start"], "link_gap": ref["link"], "step_gap": float(ref["step"].max()),
               "step_gap_median": float(ref["step"].median()), "by_chain": ref["by_chain"],
               "control_start_gap": con["start"], "control_step_gap": float(con["step"].max()),
               "control_by_chain": con["by_chain"]}
        log(f"reading {row}")
        out.append(row)
    return out
