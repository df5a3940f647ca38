"""Train state: the model and its AdamW optimizer.

The port of rohm_tpu/train/state.py. The JAX package's optimizer is
`optax.adamw(lr, weight_decay=weight_decay)`: b1 = 0.9, b2 = 0.999,
eps = 1e-8 added outside the square root, bias-corrected moments and
decoupled weight decay (p <- p - lr * (update + wd * p)).
`torch.optim.AdamW` computes the same update when every one of those is
passed explicitly; its own default weight decay is 0.01, the CLI's is 0.0.
The `frozen_mask` of the JAX package (TrajControl fine-tuning) is not
ported: it belongs to TrajNet training.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8


@dataclass
class TrainState:
    """The model (its parameters and their `.grad`), the optimizer, and the
    number of optimizer steps taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    def apply_gradients(self) -> "TrainState":
        """One AdamW update from the gradients in the parameters' `.grad`."""
        self.optimizer.step()
        self.step += 1
        return self


def create_train_state(model: torch.nn.Module, lr: float = 1e-4,
                       weight_decay: float = 0.0) -> TrainState:
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=ADAMW_BETAS, eps=ADAMW_EPS,
                            weight_decay=weight_decay)
    return TrainState(model=model, optimizer=opt)
