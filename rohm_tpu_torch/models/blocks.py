"""Shared NN blocks (reference model/heads.py), PyTorch edition.

The port of rohm_tpu/models/blocks.py. Parameter names follow the reference
state_dict (as mapped in rohm_tpu/utils/convert_torch_ckpt.py), so that a
loader of the released `.pt` checkpoints can take them as they are; the
port's `load_pretrained` reads only `.npz` for now. The convolution blocks compute
in torch's [B, C, T] layout; the models transpose at their public boundary,
which keeps the JAX package's [B, T, C].

Traps carried over from the JAX package:
- Conv1dBlock = Conv(k=5, same padding) -> GroupNorm(8, eps 1e-5) -> Mish
- Downsample1d = Conv1d(k=3, stride 2, pad 1); Upsample1d = ConvTranspose1d(4, 2, 1)
- TransformerEncoderLayer: post-LN (eps 1e-5), exact-erf gelu, written out
  by hand so each weight maps one to one
- the positional table is computed in float32 like the reference

Compute dtype (`dtype`, the JAX package's `--model_dtype`): the parameters
stay float32; a layer that flax builds with `dtype=self.dtype` casts its
input and its weights to that dtype and returns it. GroupNorm takes its
statistics and its affine in float32 and returns the block dtype, the
transformer's LayerNorms stay float32, Upsample1d adds its float32 bias to
the product (so it returns float32) and the zero convs run in float32 on
their input promoted to it, as flax's dtype promotion does. These are
explicit casts, not autocast: where the values are float32 follows flax.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          dtype=torch.float32) -> torch.Tensor:
    """flax Dense(dtype=dtype): input and weight cast to dtype, the product
    rounded to it, then the bias added in dtype (flax's `y = dot(x, w);
    y += b`, two roundings in bfloat16; in float32 one fused call)."""
    if dtype == torch.float32:
        return F.linear(x.float(), weight, bias)
    return F.linear(x.to(dtype), weight.to(dtype)) + bias.to(dtype)


def linear(lin: nn.Linear, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """`dense` on an nn.Linear's weight and bias."""
    return dense(x, lin.weight, lin.bias, dtype)


def conv1d(conv: nn.Conv1d, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """flax Conv(dtype=dtype) on [B, C, T], with the bias added as in `linear`."""
    if dtype == torch.float32:
        return F.conv1d(x.float(), conv.weight, conv.bias, conv.stride, conv.padding)
    y = F.conv1d(x.to(dtype), conv.weight.to(dtype), None, conv.stride, conv.padding)
    return y + conv.bias.to(dtype)[:, None]


def group_norm(norm: nn.GroupNorm, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """flax GroupNorm(dtype=dtype) on [B, C, T]: float32 statistics and
    affine, the result cast to dtype."""
    return F.group_norm(x.float(), norm.num_groups, norm.weight, norm.bias, norm.eps).to(dtype)


# The activations below run in their input's dtype. In bfloat16 each
# elementary step rounds to it, as the JAX package's activations (and
# jax.nn's) do step by step; torch's fused kernel would round once. In
# float32 they are torch's fused kernels.
_SQRT_HALF_BF16 = float(torch.tensor(math.sqrt(0.5)).to(torch.bfloat16))


def mish(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's mish, x * tanh(softplus(x)), with jax.nn.softplus
    = max(x, 0) + log1p(exp(-|x|))."""
    if x.dtype == torch.float32:
        return F.mish(x)
    return x * torch.tanh(torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs())))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=False): 0.5 * x * erfc(-x * sqrt(1/2)), the
    constant in x's dtype."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="none")
    return 0.5 * x * torch.erfc(-x * _SQRT_HALF_BF16)


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu, x * sigmoid(x), with the sigmoid as XLA expands it:
    1 / (1 + exp(-x))."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


def softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax over the last axis, as flax's attention runs it: the
    exponentials, their sum and the quotient. The max is a constant shift,
    so it takes no gradient."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=-1)
    e = torch.exp(x - x.amax(-1, keepdim=True).detach())
    return e / e.sum(-1, keepdim=True)


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Diffuser-style timestep embedding: t [B] -> [B, dim]."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(10000.0) / (half - 1) * torch.arange(half, device=t.device, dtype=torch.float32)
    )
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def transformer_pe_table(max_len: int, d_model: int) -> np.ndarray:
    """Classic sin/cos interleaved positional table [max_len, d_model] (a copy
    of rohm_tpu/models/blocks.py's: float32 like the reference; the f64 table
    differs by ~1e-4 in fast-frequency dims at large positions)."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * np.float32(-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe.astype(np.float32)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return sinusoidal_pos_emb(t, self.dim)


class Conv1dBlock(nn.Module):
    """Conv1d(k, same) -> GroupNorm(8, eps 1e-5) -> Mish on [B, C, T].

    The two Identity slots stand where the reference's Rearranges sit, so the
    state_dict keys are block.0 (conv) and block.2 (norm)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5, n_groups: int = 8,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.block = nn.Sequential(
            nn.Conv1d(in_ch, out_ch, kernel_size, padding=kernel_size // 2),
            nn.Identity(),
            nn.GroupNorm(n_groups, out_ch, eps=1e-5),
            nn.Identity(),
            nn.Mish(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv1d(self.block[0], x, self.dtype)
        return mish(group_norm(self.block[2], x, self.dtype))


class ResidualTemporalBlock(nn.Module):
    """Two Conv1dBlocks with a timestep embedding injected between them."""

    def __init__(self, in_ch: int, out_ch: int, time_dim: int | None = 32,
                 kernel_size: int = 5, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.blocks = nn.ModuleList([
            Conv1dBlock(in_ch, out_ch, kernel_size, dtype=dtype),
            Conv1dBlock(out_ch, out_ch, kernel_size, dtype=dtype),
        ])
        self.time_mlp = (
            nn.Sequential(nn.Mish(), nn.Linear(time_dim, out_ch)) if time_dim else None
        )
        self.residual_conv = nn.Conv1d(in_ch, out_ch, 1) if in_ch != out_ch else nn.Identity()

    def forward(self, x: torch.Tensor, t_embed: torch.Tensor | None) -> torch.Tensor:
        out = self.blocks[0](x)
        if self.time_mlp is not None:
            out = out + linear(self.time_mlp[1], mish(t_embed), self.dtype)[:, :, None]
        out = self.blocks[1](out)
        # an identity residual keeps x's own dtype, as in flax
        res = x if isinstance(self.residual_conv, nn.Identity) else conv1d(self.residual_conv, x, self.dtype)
        return out + res


class Downsample1d(nn.Module):
    """Stride-2 conv k=3, pad 1: T even -> T/2."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv1d(dim, dim, 3, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d(self.conv, x, self.dtype)


class Upsample1d(nn.Module):
    """Transposed conv k=4, stride 2, pad 1: T -> 2T. The product runs in
    the block dtype and the float32 bias is added after it, so the output
    is float32 whatever the dtype (flax's `y + bias`)."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.ConvTranspose1d(dim, dim, 4, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv_transpose1d(x.to(dt), self.conv.weight.to(dt), None, 2, 1)
        return y + self.conv.bias[:, None]


def zero_conv1x1(in_ch: int, out_ch: int) -> nn.Conv1d:
    """1x1 conv with zero-initialized weights (ControlNet residual taps).
    It has no compute dtype: callers run it with `conv1d` in float32."""
    conv = nn.Conv1d(in_ch, out_ch, 1)
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


class SelfAttention(nn.Module):
    """Multi-head self-attention with torch MultiheadAttention's parameter
    names (in_proj_weight [3D, D], in_proj_bias [3D], out_proj)."""

    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        # flax divides q by sqrt(dh) rounded to the compute dtype
        self.scale = float(torch.tensor(math.sqrt(d_model // num_heads)).to(dtype))
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor, probs_keep: torch.Tensor | None = None,
                inv_keep: float = 1.0) -> torch.Tensor:
        """probs_keep: an optional [B, H, S, S] keep-mask, dropout on the
        attention probabilities (flax's `dropout_rate`) scaled by inv_keep.
        Everything runs in the compute dtype, the softmax too (flax's
        default, rounded as jax.nn.softmax rounds: `softmax`)."""
        b, s, d = x.shape
        h = self.num_heads
        dh = d // h
        dt = self.dtype
        qkv = dense(x, self.in_proj_weight, self.in_proj_bias, dt)
        q, k, v = (t.reshape(b, s, h, dh).transpose(1, 2) for t in qkv.split(d, dim=-1))
        scores = (q / self.scale) @ k.transpose(-1, -2)
        probs = softmax(scores)
        if probs_keep is not None:
            probs = probs * (probs_keep.to(probs.dtype) * inv_keep)
        attn = probs @ v  # [b, h, s, dh]
        return linear(self.out_proj, attn.transpose(1, 2).reshape(b, s, d), dt)


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer (eps 1e-5, exact-erf gelu). `forward` is the
    eval mode; `forward_train` applies dropout from given keep-masks."""

    def __init__(self, d_model: int, num_heads: int, ff_size: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.self_attn = SelfAttention(d_model, num_heads, dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, ff_size)
        self.linear2 = nn.Linear(ff_size, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x float32 [B, S, D]: the attention and both products run in the
        compute dtype, the residual sums and LayerNorms in float32."""
        dt = self.dtype
        x = self.norm1(x + self.self_attn(x))
        h = linear(self.linear2, gelu(linear(self.linear1, x, dt)), dt)
        return self.norm2(x + h)

    def forward_train(self, x: torch.Tensor, masks: tuple, dropout_p: float) -> torch.Tensor:
        """Train mode with dropout where flax puts it (the attention
        probabilities, after the out-projection, after the gelu, after the
        second dense), from int8 keep-masks (probs [B,H,S,S], out [B,S,D],
        gelu [B,S,F], FF2 [B,S,D]) scaled by 1/(1 - dropout_p)."""
        mp, mo, mh, mf = masks
        inv_keep = 1.0 / (1.0 - dropout_p) if dropout_p > 0 else 1.0

        def drop(t, m):
            return t * (m.to(t.dtype) * inv_keep)

        dt = self.dtype
        x = self.norm1(x + drop(self.self_attn(x, mp, inv_keep), mo))
        h = drop(gelu(linear(self.linear1, x, dt)), mh)
        return self.norm2(x + drop(linear(self.linear2, h, dt), mf))
