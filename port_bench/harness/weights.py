"""Random weights from the seed, made on the device in one draw per net.

The same rule fills the port's modules and the reference's: parameters in
sorted name order take consecutive slices of one normal draw; a weight of
two or more dims is scaled by 1/sqrt(fan in), a norm's scale is 1 plus
0.1 of its slice, every other vector 0.1 of its slice. Both sides must
hold the same names and shapes, which `fill` checks.
"""

from __future__ import annotations

import math

import torch


def layout(module: torch.nn.Module) -> list[tuple[str, tuple]]:
    return sorted((name, tuple(p.shape)) for name, p in module.named_parameters())


@torch.no_grad()
def fill(module: torch.nn.Module, seed: int, expected_layout: list | None = None) -> None:
    params = dict(module.named_parameters())
    order = layout(module)
    if expected_layout is not None and order != expected_layout:
        missing = sorted(set(expected_layout) ^ set(order))[:6]
        raise ValueError(f"parameter layouts differ between the two sides: {missing}")
    device = next(iter(params.values())).device
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for _, s in order), generator=gen, device=device)
    at = 0
    for name, shape in order:
        n = math.prod(shape)
        chunk = flat[at:at + n].view(shape)
        at += n
        if len(shape) >= 2:
            value = chunk / math.sqrt(math.prod(shape[1:]))
        elif name.endswith("weight"):
            value = 1.0 + 0.1 * chunk
        else:
            value = 0.1 * chunk
        params[name].copy_(value)
