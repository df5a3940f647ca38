"""Run a module of the port as `python -m` would, recording the gradient of
every optimizer step (TrainState.apply_gradients) to
`$ROHM_GRAD_RECORD/rank<RANK>.npz` (keys `<step>/<parameter>`).

    python tests/torch_dp_record.py rohm_tpu_torch.cli.train_posenet --flag=...

`record_gradients()` does the same inside a test process.
"""

from __future__ import annotations

import contextlib
import os
import runpy
import sys

import numpy as np

from rohm_tpu_torch.train.state import TrainState


@contextlib.contextmanager
def record_gradients(path: str):
    """Record each optimizer step's `.grad` of every parameter; save them to
    `path` when the block ends."""
    steps, apply = [], TrainState.apply_gradients

    def recording(self):
        steps.append({n: p.grad.detach().cpu().numpy().copy()
                      for n, p in self.model.named_parameters() if p.grad is not None})
        return apply(self)

    TrainState.apply_gradients = recording
    try:
        yield steps
    finally:
        TrainState.apply_gradients = apply
        np.savez(path, **{f"{i}/{n}": g for i, grads in enumerate(steps) for n, g in grads.items()})


if __name__ == "__main__":
    module = sys.argv[1]
    sys.argv = [module] + sys.argv[2:]
    out = os.path.join(os.environ["ROHM_GRAD_RECORD"], f"rank{os.environ.get('RANK', 0)}.npz")
    with record_gradients(out):
        runpy.run_module(module, run_name="__main__", alter_sys=True)
