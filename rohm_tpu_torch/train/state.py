"""Train state: the model and its AdamW optimizer.

The port of rohm_tpu/train/state.py. The JAX package's optimizer is
`optax.adamw(lr, weight_decay=weight_decay)`: b1 = 0.9, b2 = 0.999,
eps = 1e-8 added outside the square root, bias-corrected moments and
decoupled weight decay (p <- p - lr * (update + wd * p)).
`torch.optim.AdamW` computes the same update when every one of those is
passed explicitly; its own default weight decay is 0.01, the CLI's is 0.0.

The TrajControl freeze (`frozen_mask`, reference train_trajnet.py:167-175):
the JAX package chains `optax.masked(set_to_zero)` after AdamW, so a frozen
leaf takes no update and no decay. Here AdamW is given the trainable
parameters alone and the frozen ones stop requiring gradients: they stay
bit for bit as they were, and their weight gradients are not computed
(gradients still flow through their activations into the branch). optax
keeps moments for the frozen leaves; this optimizer holds none for them.
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


def create_train_state(model: torch.nn.Module, lr: float = 1e-4, weight_decay: float = 0.0,
                       trainable: dict | None = None) -> TrainState:
    """AdamW over the model's parameters. trainable: optional {parameter
    name: bool} (True = trainable, `trajcontrol_frozen_mask`); the others
    are frozen."""
    params = []
    for name, p in model.named_parameters():
        if trainable is None or trainable[name]:
            params.append(p)
        else:
            p.requires_grad_(False)
    opt = torch.optim.AdamW(params, lr=lr, betas=ADAMW_BETAS, eps=ADAMW_EPS, weight_decay=weight_decay)
    return TrainState(model=model, optimizer=opt)


def trajcontrol_frozen_mask(model: torch.nn.Module) -> dict:
    """{parameter name: True (= trainable)} for the ControlNet branch only.

    Mirrors the reference freeze of everything outside `controlnet.`
    (train_trajnet.py:167-175): the shared condition encoder, the time MLP,
    the U-Net and its final conv are frozen."""
    return {name: name.startswith("controlnet.") for name, _ in model.named_parameters()}
