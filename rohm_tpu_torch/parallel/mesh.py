"""A 1-D data-parallel mesh of processes: the port of rohm_tpu/parallel/mesh.py.

`data_parallel_mesh()` joins (or makes) the torch.distributed group of the
job and returns a `DataMesh`: the group, this process's rank, the number
of ranks and the device this rank computes on. Batches are split on their
leading axis (`shard_rows`, `shard_batch`), outputs are gathered back to
every rank (`gather_rows`), reductions over the batch are taken over the
global batch (`global_sum`) and gradients are summed over ranks
(`sum_gradients`). NCCL joins cards; gloo joins CPU processes, and also
ranks that share one card, where NCCL refuses. With gloo, a tensor on a
card is staged through host memory for every collective.

Start-up, in this order: an explicit `init_method` with `rank` and
`world_size`; the variables a launcher such as torchrun sets (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), each rank on
cuda:LOCAL_RANK; otherwise a group of one process. `spawn` starts one
process per rank itself. Every group gets a timeout for each collective,
so a lost rank fails the run instead of hanging it; a job as a whole may
run as long as it needs.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue as queue_mod
import socket
import time
import traceback
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this fails the run (a lost rank)
DEFAULT_TIMEOUT_S = 600
POLL_S = 1.0  # how often spawn looks at its ranks while it waits
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclass(frozen=True)
class DataMesh:
    """The data axis: `size` processes, this one `rank`, computing on `device`."""

    group: object  # the torch.distributed process group
    rank: int
    size: int
    device: torch.device

    @property
    def staged(self) -> bool:
        """gloo on a card: collectives go through a host copy."""
        return self.device.type == "cuda" and dist.get_backend(self.group) == "gloo"

    def close(self) -> None:
        """Destroy the group this mesh made."""
        if dist.is_initialized():
            dist.destroy_process_group()


def launched() -> bool:
    """True under a launcher that set the torchrun variables."""
    return all(v in os.environ for v in LAUNCHER_VARS)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def data_parallel_mesh(device=None, backend: str | None = None, init_method: str | None = None,
                       rank: int | None = None, world_size: int | None = None,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> DataMesh:
    """The mesh over every process of the job (start-up order in the module
    docstring). device: this rank's device (default cuda:LOCAL_RANK when
    CUDA is present, else the CPU); backend: "nccl" on a card, "gloo" on
    the CPU unless given; timeout_s: the wait of each collective. Raises
    if this process is already in a group."""
    if dist.is_initialized():
        raise RuntimeError("this process is already in a torch.distributed group")
    if device is None:
        device = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
                  if torch.cuda.is_available() else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if init_method is not None:
        if rank is None or world_size is None:
            raise ValueError("an explicit init_method needs rank and world_size")
    elif launched():
        init_method, rank, world_size = "env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        init_method, rank, world_size = f"tcp://127.0.0.1:{free_port()}", 0, 1
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    group = dist.group.WORLD
    return DataMesh(group, dist.get_rank(group), dist.get_world_size(group), device)


# ---------------------------------------------------------------------------
# rows of a batch
# ---------------------------------------------------------------------------


def shard_rows(x, mesh: DataMesh | None, axis: int = 0):
    """This rank's rows of `x` (a tensor or numpy array) along `axis`, whose
    length must divide by the mesh size. No mesh: `x` itself."""
    if mesh is None:
        return x
    n = x.shape[axis]
    if n % mesh.size:
        raise ValueError(f"batch of {n} rows does not split over {mesh.size} ranks")
    b = n // mesh.size
    return x[(slice(None),) * axis + (slice(mesh.rank * b, (mesh.rank + 1) * b),)]


def shard_batch(batch: dict, mesh: DataMesh | None) -> dict:
    """This rank's rows of every leading-batch array of a batch dict (other
    values pass through)."""
    if mesh is None:
        return batch
    return {k: shard_rows(v, mesh) if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim else v
            for k, v in batch.items()}


def draw_rows(draw: Callable, shape: tuple, mesh: DataMesh | None, axis: int = 0):
    """`draw(shape)` for this rank's `shape`: the draw is taken at the
    global shape (`axis` times the mesh size) and this rank keeps its rows,
    so every rank's generator advances as in a single-process run."""
    if mesh is None:
        return draw(tuple(shape))
    full = list(shape)
    full[axis] *= mesh.size
    return shard_rows(draw(tuple(full)), mesh, axis)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _all_reduce_sum(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    buf = x.detach().to("cpu" if mesh.staged else x.device, copy=True).contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.to(x.device)


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce_sum(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def global_sum(x: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """The sum of `x` over ranks (elementwise), on every rank. The gradient
    that reaches `x` is the gradient of that global sum with respect to
    this rank's share: the identity. So a rank that differentiates a
    global loss gets the gradient for its own rows, and the ranks' shares
    of a parameter gradient add up (`sum_gradients`) to the global one."""
    if mesh is None:
        return x
    return _GlobalSum.apply(x, mesh)


def gather_rows(x: torch.Tensor, mesh: DataMesh | None, axis: int = 0) -> torch.Tensor:
    """Every rank's rows of `x`, concatenated along `axis` in rank order, on
    every rank (the inverse of shard_rows). No mesh: `x` itself."""
    if mesh is None:
        return x
    src = x.detach().to("cpu" if mesh.staged else x.device).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts, dim=axis).to(x.device)


def sum_gradients(params, mesh: DataMesh | None) -> None:
    """Sum the `.grad` of every parameter over ranks, in place, in one
    collective. Each rank's gradient is its share of the global loss's
    (global_sum), so the sum is the global gradient and every rank's
    optimizer then takes the same step."""
    if mesh is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = _all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), mesh)
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()


def barrier(mesh: DataMesh | None) -> None:
    """Wait for every rank (a one-element all-reduce, on any backend)."""
    if mesh is not None:
        _all_reduce_sum(torch.zeros(1, device=mesh.device), mesh)


def broadcast_object(obj, mesh: DataMesh | None, src: int = 0):
    """Rank `src`'s picklable `obj`, on every rank."""
    if mesh is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=mesh.group)
    return box[0]


# ---------------------------------------------------------------------------
# one process per rank
# ---------------------------------------------------------------------------


def _spawned(rank, world_size, init_method, device, backend, timeout_s, fn, args, results):
    mesh = data_parallel_mesh(device, backend, init_method, rank, world_size, timeout_s)
    try:
        out = fn(mesh, *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        mesh.close()
    results.put((rank, True, out))


def spawn(fn: Callable, world_size: int, args: tuple = (), devices=None, backend: str | None = None,
          init_method: str | None = None, timeout_s: float | None = None,
          deadline_s: float | None = None) -> list:
    """Run `fn(mesh, *args)` in `world_size` new processes (the spawn start
    method), one rank each, and return their results in rank order. fn and
    args must pickle (fn at module level), and so must each result: return
    numpy arrays or plain Python values. devices: one per rank (default
    cuda:rank with CUDA, else the CPU); init_method: a rendezvous URL
    (default a free localhost port); timeout_s: each collective's wait
    (default DEFAULT_TIMEOUT_S). The job itself has no time limit unless a
    deadline_s is given. A rank that raises or exits without a result, or
    a deadline that passes, ends every rank and raises."""
    if devices is None:
        devices = ([torch.device("cuda", r) for r in range(world_size)] if torch.cuda.is_available()
                   else [torch.device("cpu")] * world_size)
    timeout_s = DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s
    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_spawned, daemon=True,
                         args=(r, world_size, init_method, devices[r], backend, timeout_s, fn, args,
                               results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = None if deadline_s is None else time.monotonic() + deadline_s
    out, failure, lost_before = {}, None, set()
    try:
        while len(out) < world_size and failure is None:
            try:
                rank, ok, value = results.get(timeout=POLL_S)
            except queue_mod.Empty:
                # a rank that exited: the result it sent before exiting has had a poll to arrive
                lost = {r for r, p in enumerate(procs) if r not in out and p.exitcode is not None}
                if deadline is not None and time.monotonic() >= deadline:
                    failure = f"ranks {sorted(set(range(world_size)) - set(out))} gave no result in {deadline_s} s"
                elif lost & lost_before:
                    gone = sorted(lost & lost_before)
                    failure = f"ranks {gone} exited with codes {[procs[r].exitcode for r in gone]} and no result"
                lost_before = lost
                continue
            if ok:
                out[rank] = value
            else:
                failure = f"rank {rank} failed:\n{value}"
        for p in procs:
            if failure is None:
                p.join(timeout_s)  # then killed below, and its exit code fails the run
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if failure is None and any(p.exitcode != 0 for p in procs):
        failure = f"exit codes {[p.exitcode for p in procs]}"
    if failure is not None:
        raise RuntimeError(f"data-parallel run of {world_size} ranks: {failure}")
    return [out[r] for r in range(world_size)]
