"""Flax <-> PyTorch weight bridge.

Turns the JAX package's flax param trees (nested dicts of numpy arrays, e.g.
`jax.tree.map(np.asarray, params)`) into state_dicts of the port's modules,
and a JAX `SmplxModel` into the port's body container. The torch parameter
names are the reference's state_dict names, i.e. the inverse of
rohm_tpu/utils/convert_torch_ckpt.py, so flax -> torch -> flax through that
converter is the identity. `posenet_flax_params` and `trajnet_flax_params`
go the other way (the port's own copies of that converter's
`convert_posenet` and `convert_trajnet`): the port's training checkpoints
are flattened flax params, the format the JAX package's `load_pretrained`
reads. Layout rules (flax -> torch):

  Dense kernel [in, out]          -> Linear weight [out, in]
  Conv kernel [k, in, out]        -> Conv1d weight [out, in, k]
  Upsample1d kernel [k, in, out]  -> ConvTranspose1d weight [in, out, k]
  MHA query/key/value [D, H, dh]  -> in_proj_weight [3D, D] rows
  MHA out [H, dh, D]              -> out_proj.weight [D, D]
  GroupNorm/LayerNorm scale/bias  -> weight/bias

No import of jax: the inputs are numpy arrays (or anything np.asarray takes).
"""

from __future__ import annotations

import numpy as np
import torch

from rohm_tpu_torch.body.model import SmplxModel, make_model


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _params(flax_params) -> dict:
    flat = _flatten(flax_params)
    return {k[len("params/"):] if k.startswith("params/") else k: v for k, v in flat.items()}


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _conv(k):  # flax [k, in, out] -> torch Conv1d [out, in, k]
    return _t(np.transpose(k, (2, 1, 0)))


def _dense(k):  # flax [in, out] -> torch Linear [out, in]
    return _t(np.asarray(k).T)


def _conv_t(k):  # flax [k, in, out] -> torch ConvTranspose1d [in, out, k]
    return _t(np.transpose(k, (1, 2, 0)))


def _rtb(p: dict, scope: str, prefix: str, out: dict) -> None:
    """ResidualTemporalBlock scope -> reference RTB state_dict entries."""
    for i in (0, 1):
        c = f"{scope}/Conv1dBlock_{i}"
        out[f"{prefix}.blocks.{i}.block.0.weight"] = _conv(p[f"{c}/Conv_0/kernel"])
        out[f"{prefix}.blocks.{i}.block.0.bias"] = _t(p[f"{c}/Conv_0/bias"])
        out[f"{prefix}.blocks.{i}.block.2.weight"] = _t(p[f"{c}/GroupNorm_0/scale"])
        out[f"{prefix}.blocks.{i}.block.2.bias"] = _t(p[f"{c}/GroupNorm_0/bias"])
    if f"{scope}/Dense_0/kernel" in p:
        out[f"{prefix}.time_mlp.1.weight"] = _dense(p[f"{scope}/Dense_0/kernel"])
        out[f"{prefix}.time_mlp.1.bias"] = _t(p[f"{scope}/Dense_0/bias"])
    if f"{scope}/Conv_0/kernel" in p:
        out[f"{prefix}.residual_conv.weight"] = _conv(p[f"{scope}/Conv_0/kernel"])
        out[f"{prefix}.residual_conv.bias"] = _t(p[f"{scope}/Conv_0/bias"])


def _conv_entry(p: dict, scope: str, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _conv(p[f"{scope}/kernel"])
    out[f"{prefix}.bias"] = _t(p[f"{scope}/bias"])


def _unet_branch(p: dict, flax_scope: str, torch_prefix: str, out: dict) -> None:
    """Encoder + mid of a U-Net branch (diff_* or controlnet.control_*)."""
    s = f"{flax_scope}/" if flax_scope else ""
    for i in range(1, 5):
        _rtb(p, f"{s}ResidualTemporalBlock_{i - 1}", f"{torch_prefix}enc{i}", out)
        _conv_entry(p, f"{s}Downsample1d_{i - 1}/Conv_0", f"{torch_prefix}downsample{i}.conv", out)
    _rtb(p, f"{s}ResidualTemporalBlock_4", f"{torch_prefix}mid_block1", out)
    _rtb(p, f"{s}ResidualTemporalBlock_5", f"{torch_prefix}mid_block2", out)


def trajnet_state_dict(flax_params, trajcontrol: bool = False) -> dict:
    """Flax TrajNet (+ControlNet) params -> port TrajNet state_dict."""
    p = _params(flax_params)
    out = {
        "time_mlp.1.weight": _dense(p["TimeMlp_0/Dense_0/kernel"]),
        "time_mlp.1.bias": _t(p["TimeMlp_0/Dense_0/bias"]),
        "time_mlp.3.weight": _dense(p["TimeMlp_0/Dense_1/kernel"]),
        "time_mlp.3.bias": _t(p["TimeMlp_0/Dense_1/bias"]),
    }
    for i in range(1, 5):
        _rtb(p, f"CondEncoder_0/ResidualTemporalBlock_{i - 1}", f"cond_enc{i}", out)
        if i < 4:
            _conv_entry(p, f"CondEncoder_0/Downsample1d_{i - 1}/Conv_0", f"cond_downsample{i}.conv", out)
    _unet_branch(p, "", "diff_", out)
    for slot, i in enumerate((4, 3, 2, 1)):
        out[f"diff_upsample{i}.conv.weight"] = _conv_t(p[f"Upsample1d_{slot}/kernel"])
        out[f"diff_upsample{i}.conv.bias"] = _t(p[f"Upsample1d_{slot}/bias"])
        _rtb(p, f"ResidualTemporalBlock_{6 + slot}", f"diff_dec{i}", out)
    _conv_entry(p, "Conv1dBlock_0/Conv_0", "diff_final_conv.0.block.0", out)
    out["diff_final_conv.0.block.2.weight"] = _t(p["Conv1dBlock_0/GroupNorm_0/scale"])
    out["diff_final_conv.0.block.2.bias"] = _t(p["Conv1dBlock_0/GroupNorm_0/bias"])
    _conv_entry(p, "Conv_0", "diff_final_conv.1", out)
    if trajcontrol:
        _unet_branch(p, "ControlNet_0", "controlnet.control_", out)
        names = [f"control_zero_conv_{i}" for i in range(5)] + ["control_zero_conv_mid"]
        for slot, name in enumerate(names):
            _conv_entry(p, f"ControlNet_0/ZeroConv1x1_{slot}/Conv_0", f"controlnet.{name}", out)
    return out


def _trajnet_scopes() -> dict:
    """Module prefix of the port's TrajNet (+ControlNet) -> (flax scope, kind):
    the scopes trajnet_state_dict reads, one per torch module."""
    s = {"time_mlp.1": ("TimeMlp_0/Dense_0", "dense"), "time_mlp.3": ("TimeMlp_0/Dense_1", "dense"),
         "diff_final_conv.0": ("Conv1dBlock_0", "block"), "diff_final_conv.1": ("Conv_0", "conv")}
    for i in range(1, 5):
        s[f"cond_enc{i}"] = (f"CondEncoder_0/ResidualTemporalBlock_{i - 1}", "rtb")
        if i < 4:
            s[f"cond_downsample{i}.conv"] = (f"CondEncoder_0/Downsample1d_{i - 1}/Conv_0", "conv")
    for prefix, scope in (("diff_", ""), ("controlnet.control_", "ControlNet_0/")):
        for i in range(1, 5):
            s[f"{prefix}enc{i}"] = (f"{scope}ResidualTemporalBlock_{i - 1}", "rtb")
            s[f"{prefix}downsample{i}.conv"] = (f"{scope}Downsample1d_{i - 1}/Conv_0", "conv")
        s[f"{prefix}mid_block1"] = (f"{scope}ResidualTemporalBlock_4", "rtb")
        s[f"{prefix}mid_block2"] = (f"{scope}ResidualTemporalBlock_5", "rtb")
    for slot, i in enumerate((4, 3, 2, 1)):
        s[f"diff_upsample{i}.conv"] = (f"Upsample1d_{slot}", "upsample")
        s[f"diff_dec{i}"] = (f"ResidualTemporalBlock_{6 + slot}", "rtb")
    names = [f"control_zero_conv_{i}" for i in range(5)] + ["control_zero_conv_mid"]
    for slot, name in enumerate(names):
        s[f"controlnet.{name}"] = (f"ControlNet_0/ZeroConv1x1_{slot}/Conv_0", "conv")
    return s


_TRAJNET_SCOPES = _trajnet_scopes()
# suffix of a Conv1dBlock entry (Conv1d, GroupNorm) -> (flax leaf, layout)
_BLOCK_LEAVES = {"block.0.weight": ("Conv_0/kernel", "conv"), "block.0.bias": ("Conv_0/bias", "vec"),
                 "block.2.weight": ("GroupNorm_0/scale", "vec"), "block.2.bias": ("GroupNorm_0/bias", "vec")}


def _trajnet_flax_key(name: str) -> tuple[str, str]:
    """A TrajNet state_dict name -> (flat flax key, layout of the torch tensor)."""
    prefix = next(p for p in _TRAJNET_SCOPES if name.startswith(p + "."))
    scope, kind = _TRAJNET_SCOPES[prefix]
    leaf = name[len(prefix) + 1:]
    if kind == "rtb":  # blocks.{0,1}.<Conv1dBlock entry>, time_mlp.1.*, residual_conv.*
        if leaf.startswith("blocks."):
            i, leaf = leaf[len("blocks."):].split(".", 1)
            scope, kind = f"{scope}/Conv1dBlock_{i}", "block"
        else:
            sub, leaf = leaf.rsplit(".", 1)
            scope, kind = {"time_mlp.1": (f"{scope}/Dense_0", "dense"),
                           "residual_conv": (f"{scope}/Conv_0", "conv")}[sub]
    if kind == "block":
        flax_leaf, layout = _BLOCK_LEAVES[leaf]
        return f"{scope}/{flax_leaf}", layout
    if leaf == "weight":
        return f"{scope}/kernel", kind
    return f"{scope}/bias", "vec"


# torch layout -> flax layout (the inverses of _dense, _conv, _conv_t)
_TO_FLAX = {"vec": lambda w: w, "dense": lambda w: w.T, "conv": lambda w: np.transpose(w, (2, 1, 0)),
            "upsample": lambda w: np.transpose(w, (2, 0, 1))}


def trajnet_flax_params(state_dict: dict) -> dict:
    """Port TrajNet (+ControlNet) state_dict (or any dict of tensors under
    its parameter names, e.g. the optimizer moments of some of them) ->
    flat flax params, "/"-separated keys under "params/" (numpy float32):
    the inverse of trajnet_state_dict, entry by entry."""
    out = {}
    for name, v in state_dict.items():
        w = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v, np.float32)
        key, layout = _trajnet_flax_key(name)
        out[f"params/{key}"] = np.ascontiguousarray(_TO_FLAX[layout](w))
    return out


def posenet_state_dict(flax_params, num_layers: int | None = None) -> dict:
    """Flax PoseNet params -> port PoseNet state_dict."""
    p = _params(flax_params)
    if num_layers is None:
        num_layers = len({k.split("/")[0] for k in p if k.startswith("layer_")})
    out = {
        "embed_timestep.time_embed.0.weight": _dense(p["Dense_0/kernel"]),
        "embed_timestep.time_embed.0.bias": _t(p["Dense_0/bias"]),
        "embed_timestep.time_embed.2.weight": _dense(p["Dense_1/kernel"]),
        "embed_timestep.time_embed.2.bias": _t(p["Dense_1/bias"]),
        "input_process.poseEmbedding.weight": _dense(p["input_process/kernel"]),
        "input_process.poseEmbedding.bias": _t(p["input_process/bias"]),
        "input_process_cond.poseEmbedding.weight": _dense(p["input_process_cond/kernel"]),
        "input_process_cond.poseEmbedding.bias": _t(p["input_process_cond/bias"]),
        "output_process.poseFinal.weight": _dense(p["output_process/kernel"]),
        "output_process.poseFinal.bias": _t(p["output_process/bias"]),
    }
    for i in range(num_layers):
        s, t = f"layer_{i}", f"seqTransEncoder.layers.{i}"
        a = f"{s}/MultiHeadDotProductAttention_0"
        d = p[f"{a}/out/bias"].shape[0]
        out[f"{t}.self_attn.in_proj_weight"] = torch.cat(
            [_dense(p[f"{a}/{n}/kernel"].reshape(d, d)) for n in ("query", "key", "value")]
        )
        out[f"{t}.self_attn.in_proj_bias"] = torch.cat(
            [_t(p[f"{a}/{n}/bias"].reshape(d)) for n in ("query", "key", "value")]
        )
        out[f"{t}.self_attn.out_proj.weight"] = _dense(p[f"{a}/out/kernel"].reshape(d, d))
        out[f"{t}.self_attn.out_proj.bias"] = _t(p[f"{a}/out/bias"])
        for flax_name, torch_name in (("LayerNorm_0", "norm1"), ("LayerNorm_1", "norm2")):
            out[f"{t}.{torch_name}.weight"] = _t(p[f"{s}/{flax_name}/scale"])
            out[f"{t}.{torch_name}.bias"] = _t(p[f"{s}/{flax_name}/bias"])
        for flax_name, torch_name in (("Dense_0", "linear1"), ("Dense_1", "linear2")):
            out[f"{t}.{torch_name}.weight"] = _dense(p[f"{s}/{flax_name}/kernel"])
            out[f"{t}.{torch_name}.bias"] = _t(p[f"{s}/{flax_name}/bias"])
    return out


def posenet_flax_params(state_dict: dict, num_heads: int) -> dict:
    """Port PoseNet state_dict (or any dict of tensors under its parameter
    names, e.g. optimizer moments) -> flat flax params, "/"-separated keys
    under "params/" (numpy float32): the inverse of posenet_state_dict."""
    src = {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v, np.float32)
           for k, v in state_dict.items()}

    def dense(w):  # torch Linear [out, in] -> flax [in, out]
        return np.ascontiguousarray(w.T)

    flat = {
        "Dense_0/kernel": dense(src["embed_timestep.time_embed.0.weight"]),
        "Dense_0/bias": src["embed_timestep.time_embed.0.bias"],
        "Dense_1/kernel": dense(src["embed_timestep.time_embed.2.weight"]),
        "Dense_1/bias": src["embed_timestep.time_embed.2.bias"],
        "input_process/kernel": dense(src["input_process.poseEmbedding.weight"]),
        "input_process/bias": src["input_process.poseEmbedding.bias"],
        "input_process_cond/kernel": dense(src["input_process_cond.poseEmbedding.weight"]),
        "input_process_cond/bias": src["input_process_cond.poseEmbedding.bias"],
        "output_process/kernel": dense(src["output_process.poseFinal.weight"]),
        "output_process/bias": src["output_process.poseFinal.bias"],
    }
    layers = sorted({int(k.split(".")[2]) for k in src if k.startswith("seqTransEncoder.layers.")})
    for i in layers:
        t, s = f"seqTransEncoder.layers.{i}", f"layer_{i}"
        a = f"{s}/MultiHeadDotProductAttention_0"
        in_w, in_b = src[f"{t}.self_attn.in_proj_weight"], src[f"{t}.self_attn.in_proj_bias"]
        d = in_w.shape[1]
        h, hd = num_heads, d // num_heads
        for j, name in enumerate(("query", "key", "value")):
            flat[f"{a}/{name}/kernel"] = dense(in_w[j * d : (j + 1) * d]).reshape(d, h, hd)
            flat[f"{a}/{name}/bias"] = in_b[j * d : (j + 1) * d].reshape(h, hd)
        flat[f"{a}/out/kernel"] = dense(src[f"{t}.self_attn.out_proj.weight"]).reshape(h, hd, d)
        flat[f"{a}/out/bias"] = src[f"{t}.self_attn.out_proj.bias"]
        for torch_name, flax_name in (("norm1", "LayerNorm_0"), ("norm2", "LayerNorm_1")):
            flat[f"{s}/{flax_name}/scale"] = src[f"{t}.{torch_name}.weight"]
            flat[f"{s}/{flax_name}/bias"] = src[f"{t}.{torch_name}.bias"]
        for torch_name, flax_name in (("linear1", "Dense_0"), ("linear2", "Dense_1")):
            flat[f"{s}/{flax_name}/kernel"] = dense(src[f"{t}.{torch_name}.weight"])
            flat[f"{s}/{flax_name}/bias"] = src[f"{t}.{torch_name}.bias"]
    return {f"params/{k}": v for k, v in flat.items()}


def body_model_from_jax(jax_model, device, dtype=torch.float32) -> SmplxModel:
    """A JAX `SmplxModel` (its arrays, read through np.asarray) -> the port's
    container, precomputed joints tables included."""
    names = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights",
             "j_template", "j_shapedirs")
    arrays = {n: np.asarray(getattr(jax_model, n)) for n in names}
    return make_model(arrays, jax_model.parents, device, dtype, faces=jax_model.faces)
