"""Rank bodies for the port's data-parallel tests (tests/test_torch_data_parallel.py).

Each function runs as one rank of `rohm_tpu_torch.parallel.spawn` on the
CPU (gloo): it gets the mesh and numpy inputs for the GLOBAL batch, runs
its rows through the port, and returns numpy arrays. This module imports
no JAX, so a spawned rank starts quickly.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from rohm_tpu_torch.body import synthetic_model
from rohm_tpu_torch.diffusion import make_schedule
from rohm_tpu_torch.models import PoseNet, TrajNet
from rohm_tpu_torch.models.guidance import (
    GUIDANCE_2D_JOINTS,
    camera_inverses,
    projection_2d_loss_fn,
    prox_guidance,
    skating_loss_fn,
)
from rohm_tpu_torch.models.losses import foot_skating_loss, posenet_losses
from rohm_tpu_torch.parallel import (
    barrier,
    broadcast_object,
    draw_rows,
    gather_rows,
    global_sum,
    shard_batch,
    shard_rows,
    sum_gradients,
)
from rohm_tpu_torch.pipeline import GUIDANCE_DATA_KEYS, RohmPipeline, shard_guidance_data
from rohm_tpu_torch.train.state import create_train_state
from rohm_tpu_torch.train.steps import make_posenet_grads_fn, make_trajnet_grads_fn


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def collectives(mesh, x: np.ndarray) -> dict:
    """Every helper of the mesh on a global [N, 3] array."""
    torch.set_num_threads(1)
    rows = shard_rows(_t(x), mesh)
    batch = shard_batch({"x": x, "scalar": 7, "y": _t(x)[:, :1]}, mesh)
    leaf = rows.clone().requires_grad_()
    total = global_sum((leaf ** 2).sum(), mesh)
    (grad,) = torch.autograd.grad(total, leaf)
    p = torch.nn.Parameter(torch.zeros(2))
    p.grad = torch.full((2,), float(mesh.rank + 1))
    sum_gradients([p], mesh)
    gen = torch.Generator().manual_seed(3)
    drawn = draw_rows(lambda shape: torch.randn(shape, generator=gen), (2, 5), mesh)
    after = torch.randn(1, generator=gen)  # the generator moved as for the global draw
    barrier(mesh)
    return {
        "rows": _np(rows), "batch_x": batch["x"], "batch_scalar": batch["scalar"], "batch_y": _np(batch["y"]),
        "gathered": _np(gather_rows(rows, mesh)), "gathered_ax1": _np(gather_rows(rows.t(), mesh, axis=1)),
        "total": _np(total), "grad": _np(grad), "grad_sum": _np(p.grad), "drawn": _np(drawn), "after": _np(after),
        "broadcast": broadcast_object({"rank": mesh.rank}, mesh), "size": mesh.size, "rank": mesh.rank,
    }


def guidance_terms(mesh, joints, contact, x, mean, std, cameras: dict, out, clean, weights) -> dict:
    """foot_skating_loss, the two guidance losses and posenet_losses on this
    rank's rows: values and gradients for those rows, gathered."""
    torch.set_num_threads(1)
    body = synthetic_model(num_verts=64, seed=3)
    res = {}
    j = shard_rows(_t(joints), mesh).requires_grad_()
    c = shard_rows(_t(contact), mesh)
    loss = foot_skating_loss(j, c, mesh)
    (g,) = torch.autograd.grad(loss, j)
    res["skating"], res["skating_grad"] = _np(loss), _np(gather_rows(g, mesh))
    xr = shard_rows(_t(x), mesh).requires_grad_()
    loss = skating_loss_fn(xr, _t(mean), _t(std), body, mesh)
    (g,) = torch.autograd.grad(loss, xr)
    res["guide_skating"], res["guide_skating_grad"] = _np(loss), _np(gather_rows(g, mesh))
    cano, cam_r_inv = camera_inverses(shard_rows(_t(cameras["transf_matrix"]), mesh), _t(cameras["cam_r"]))
    xr = shard_rows(_t(x), mesh).requires_grad_()
    loss = projection_2d_loss_fn(
        xr, _t(mean), _t(std), body, cano, cam_r_inv, _t(cameras["cam_t"]),
        *(shard_rows(_t(cameras[k]), mesh) for k in ("focal_length", "camera_center", "keypoints_2d")),
        torch.as_tensor(GUIDANCE_2D_JOINTS), mesh)
    (g,) = torch.autograd.grad(loss, xr)
    res["proj_grad"] = _np(gather_rows(g, mesh))
    o = shard_rows(_t(out), mesh).requires_grad_()
    losses = posenet_losses(o, shard_rows(_t(clean), mesh), _t(mean), _t(std), body, weights, mesh=mesh)
    (g,) = torch.autograd.grad(losses["loss"], o)
    res["losses"] = {k: float(v.detach()) for k, v in losses.items()}
    res["losses_grad"] = _np(gather_rows(g, mesh))
    return res


def prox_terms(mesh, x, mean, std, guidance_data: dict) -> dict:
    """Both 'prox' guidance terms on this rank's rows, their inputs sharded
    as RohmPipeline.run_batch shards them (a per-row camera too): per term
    name, the loss and the gathered row gradient."""
    torch.set_num_threads(1)
    body = synthetic_model(num_verts=64, seed=3)
    gd = shard_guidance_data({k: _t(v) for k, v in guidance_data.items()}, mesh)
    res = {}
    for spec in prox_guidance(_t(mean), _t(std), body, *(gd[k] for k in GUIDANCE_DATA_KEYS), mesh=mesh):
        xr = shard_rows(_t(x), mesh).requires_grad_()
        loss = spec.loss_fn(xr)
        (g,) = torch.autograd.grad(loss, xr)
        res[spec.name] = (_np(loss), _np(gather_rows(g, mesh)))
    return res


def posenet_step(mesh, state_dict, cfg: dict, batch, t, noise, masks, mean, std, weights, mode, skating,
                 lr) -> dict:
    """make_posenet_grads_fn (fused_train `mode`) on this rank's rows with
    the given global t, noise and keep-masks, then one AdamW step."""
    torch.set_num_threads(1)
    model = PoseNet(**cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    fn = make_posenet_grads_fn(model, make_schedule("cosine", 1000), _t(mean), _t(std),
                               synthetic_model(num_verts=64, seed=3), weights, mode, mesh)
    keep, layers = masks
    rows = (None if keep is None else shard_rows(torch.from_numpy(keep), mesh),
            [tuple(shard_rows(torch.from_numpy(m), mesh) for m in lm) for lm in layers])
    grads, losses = fn(model, {k: shard_rows(_t(v), mesh) for k, v in batch.items()},
                       shard_rows(torch.from_numpy(t).long(), mesh), shard_rows(_t(noise), mesh), rows,
                       torch.tensor(float(skating)))
    out = {"grads": {k: _np(v) for k, v in grads.items()}, "losses": {k: float(v) for k, v in losses.items()}}
    create_train_state(model, lr, 0.0).apply_gradients()
    out["params"] = {k: _np(v) for k, v in model.state_dict().items()}
    return out


def trajnet_step(mesh, state_dict, cfg: dict, batch, t, noise, mean, std, weights, abs_only, lr) -> dict:
    """make_trajnet_grads_fn on this rank's rows, then one AdamW step."""
    torch.set_num_threads(1)
    model = TrajNet(**cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    fn = make_trajnet_grads_fn(model, make_schedule("cosine", 100), _t(mean), _t(std),
                               synthetic_model(num_verts=64, seed=3), weights, abs_only, cfg["traj_feat_dim"],
                               mesh)
    grads, losses = fn(model, {k: shard_rows(_t(v), mesh) for k, v in batch.items()},
                       shard_rows(torch.from_numpy(t).long(), mesh), shard_rows(_t(noise), mesh))
    out = {"grads": {k: _np(v) for k, v in grads.items()}, "losses": {k: float(v) for k, v in losses.items()}}
    create_train_state(model, lr, 0.0).apply_gradients()
    out["params"] = {k: _np(v) for k, v in model.state_dict().items()}
    return out


def pipeline_batch(mesh, state_dicts: dict, mean, std, inputs, noise, fused, guided, steps) -> tuple:
    """One RohmPipeline(mesh=) batch of the slice of test_torch_pipeline.py
    (2 iterations, the 'amass' guidance if `guided`) with the global inputs
    and replayed noise."""
    torch.set_num_threads(1)
    models = {
        "trajnet": TrajNet(traj_feat_dim=13, cond_dim=13, mid_dim=64),
        "trajcontrol": TrajNet(traj_feat_dim=13, cond_dim=13, mid_dim=64, trajcontrol=True),
        "posenet": PoseNet(latent_dim=32, ff_size=64, num_layers=2, num_heads=2),
    }
    for k, m in models.items():
        m.load_state_dict({n: torch.from_numpy(v) for n, v in state_dicts[k].items()})
        m.eval()
    pipe = RohmPipeline(
        **models, sched_traj=make_schedule("cosine", steps[0]), sched_pose=make_schedule("cosine", steps[1]),
        body_model=synthetic_model(num_verts=64, seed=0), mean=_t(mean), std=_t(std), repr_abs_only=True,
        traj_feat_dim=13, sample_iter=2, grad_type="amass" if guided else None, mask_scheme="lower", input_noise=True,
        iter2_cond_noisy_pose=True, iter2_cond_noisy_traj=True, fused_posenet=fused, mesh=mesh)
    pose, traj = pipe.run_batch(*inputs, torch.Generator().manual_seed(0), preset_noise=noise)
    return _np(pose), _np(traj)


def slow_job(args, mesh) -> dict:
    """A CLI body (`run_data_parallel`) that runs for args.seconds before its
    first collective, then sums the ranks' numbers (1 + 2 + ...); with
    args.lose_rank set, that rank exits at once without a result."""
    if mesh.rank == args.lose_rank:
        os._exit(3)
    time.sleep(args.seconds)
    total = global_sum(torch.tensor(float(mesh.rank + 1)), mesh)
    barrier(mesh)
    return {"rank": mesh.rank, "size": mesh.size, "device": str(mesh.device), "total": float(total)}
