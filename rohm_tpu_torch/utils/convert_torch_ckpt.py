"""Torch -> flax checkpoint conversion for the released RoHM weights.

The port of rohm_tpu/utils/convert_torch_ckpt.py: the same CLI, writing the
same `.npz` (the same "/"-separated keys under "params/", equal arrays),
built with the port's own `trajnet_flax_params` / `posenet_flax_params`
(rohm_tpu_torch/utils/convert_flax.py). The port's modules carry the
reference's state_dict names, so a released `.pt` also loads directly into
them (`rohm_tpu_torch.cli.common.load_pretrained`); this converter is for
the JAX package and for tools that read `.npz`.

Keys the converted net does not use (a positional-table buffer, or the
`controlnet.*` branch when converting a vanilla TrajNet) are skipped, as
the JAX converter skips them; a key of one of the net's modules that the
mapping cannot place raises here, not later in a strict loader.

Usage:
  python -m rohm_tpu_torch.utils.convert_torch_ckpt --model=trajnet \\
      --torch_path=model000450000.pt --out_path=trajnet.npz [--trajcontrol=True]
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from rohm_tpu_torch.utils.convert_flax import _TRAJNET_SCOPES, posenet_flax_params, trajnet_flax_params

log = logging.getLogger("rohm_tpu_torch.convert")

POSENET_NUM_HEADS = 4  # reference train_posenet.py:116-128


def _is_trajnet_param(name: str, trajcontrol: bool) -> bool:
    """Whether `name` lies in one of the converted net's modules."""
    if name.startswith("controlnet.") and not trajcontrol:
        return False
    return any(name.startswith(prefix + ".") for prefix in _TRAJNET_SCOPES)


def convert_trajnet(state_dict: dict, trajcontrol: bool = False) -> dict:
    """TrajNet (+ControlNet branch) state_dict -> flat flax params."""
    used = {k: v for k, v in state_dict.items() if _is_trajnet_param(k, trajcontrol)}
    skipped = sorted(set(state_dict) - set(used))
    if skipped:
        log.warning("skipping %d key(s) a TrajNet%s does not use: %s", len(skipped),
                    " (TrajControl)" if trajcontrol else "", skipped[:8])
    return trajnet_flax_params(used)


def convert_posenet(state_dict: dict, num_heads: int = POSENET_NUM_HEADS) -> dict:
    """PoseNet state_dict -> flat flax params (any width and depth; the
    heads are the reference's 4)."""
    return posenet_flax_params(state_dict, num_heads=num_heads)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model", choices=["trajnet", "posenet"], required=True)
    parser.add_argument("--torch_path", required=True)
    parser.add_argument("--out_path", required=True)
    parser.add_argument("--trajcontrol", default=False,
                        type=lambda x: str(x).lower() in ["true", "1"])
    args = parser.parse_args(argv)

    state_dict = torch.load(args.torch_path, map_location="cpu", weights_only=True)
    if args.model == "trajnet":
        flat = convert_trajnet(state_dict, args.trajcontrol)
    else:
        flat = convert_posenet(state_dict)
    np.savez(args.out_path, **flat)
    print(f"wrote {len(flat)} arrays -> {args.out_path}")


if __name__ == "__main__":
    main()
