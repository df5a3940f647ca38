"""Data parallelism over processes, one per card (torch.distributed).

The port of rohm_tpu/parallel/. The JAX package splits a batch over a 1-D
'data' mesh of devices driven by one program, and GSPMD takes every
reduction over the global batch. Here each card has its own process and
runs its rows of the batch; the collectives that stand in for GSPMD are
explicit: `gather_rows` for outputs, `global_sum` for a reduction over the
batch, `sum_gradients` before the optimizer step. Random draws are taken at
the global shape by every rank from the same seeded generator, and each
rank keeps its rows (`draw_rows`), so a run gives the single-process
result whatever the number of ranks.
"""

from rohm_tpu_torch.parallel.mesh import (
    DataMesh,
    barrier,
    broadcast_object,
    data_parallel_mesh,
    draw_rows,
    gather_rows,
    global_sum,
    launched,
    shard_batch,
    shard_rows,
    spawn,
    sum_gradients,
)

__all__ = [
    "DataMesh",
    "barrier",
    "broadcast_object",
    "data_parallel_mesh",
    "draw_rows",
    "gather_rows",
    "global_sum",
    "launched",
    "shard_batch",
    "shard_rows",
    "spawn",
    "sum_gradients",
]
