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
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


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

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5, n_groups: int = 8):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv1d(in_ch, out_ch, kernel_size, padding=kernel_size // 2),
            nn.Identity(),
            nn.GroupNorm(n_groups, out_ch, eps=1e-5),
            nn.Identity(),
            nn.Mish(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class ResidualTemporalBlock(nn.Module):
    """Two Conv1dBlocks with a timestep embedding injected between them."""

    def __init__(self, in_ch: int, out_ch: int, time_dim: int | None = 32,
                 kernel_size: int = 5):
        super().__init__()
        self.blocks = nn.ModuleList([
            Conv1dBlock(in_ch, out_ch, kernel_size),
            Conv1dBlock(out_ch, out_ch, kernel_size),
        ])
        self.time_mlp = (
            nn.Sequential(nn.Mish(), nn.Linear(time_dim, out_ch)) if time_dim else None
        )
        self.residual_conv = nn.Conv1d(in_ch, out_ch, 1) if in_ch != out_ch else nn.Identity()

    def forward(self, x: torch.Tensor, t_embed: torch.Tensor | None) -> torch.Tensor:
        out = self.blocks[0](x)
        if self.time_mlp is not None:
            out = out + self.time_mlp(t_embed)[:, :, None]
        out = self.blocks[1](out)
        return out + self.residual_conv(x)


class Downsample1d(nn.Module):
    """Stride-2 conv k=3, pad 1: T even -> T/2."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv1d(dim, dim, 3, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample1d(nn.Module):
    """Transposed conv k=4, stride 2, pad 1: T -> 2T."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.ConvTranspose1d(dim, dim, 4, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def zero_conv1x1(in_ch: int, out_ch: int) -> nn.Conv1d:
    """1x1 conv with zero-initialized weights (ControlNet residual taps)."""
    conv = nn.Conv1d(in_ch, out_ch, 1)
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


class SelfAttention(nn.Module):
    """Multi-head self-attention with torch MultiheadAttention's parameter
    names (in_proj_weight [3D, D], in_proj_bias [3D], out_proj)."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor, probs_keep: torch.Tensor | None = None,
                inv_keep: float = 1.0) -> torch.Tensor:
        """probs_keep: an optional [B, H, S, S] keep-mask, dropout on the
        attention probabilities (flax's `dropout_rate`) scaled by inv_keep."""
        b, s, d = x.shape
        h = self.num_heads
        dh = d // h
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(b, s, h, dh).transpose(1, 2) for t in qkv.split(d, dim=-1))
        scores = (q / math.sqrt(dh)) @ k.transpose(-1, -2)
        probs = torch.softmax(scores, dim=-1)
        if probs_keep is not None:
            probs = probs * (probs_keep.to(probs.dtype) * inv_keep)
        attn = probs @ v  # [b, h, s, dh]
        return self.out_proj(attn.transpose(1, 2).reshape(b, s, d))


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer (eps 1e-5, exact-erf gelu). `forward` is the
    eval mode; `forward_train` applies dropout from given keep-masks."""

    def __init__(self, d_model: int, num_heads: int, ff_size: int):
        super().__init__()
        self.self_attn = SelfAttention(d_model, num_heads)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, ff_size)
        self.linear2 = nn.Linear(ff_size, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x))
        h = self.linear2(F.gelu(self.linear1(x), approximate="none"))
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

        x = self.norm1(x + drop(self.self_attn(x, mp, inv_keep), mo))
        h = drop(F.gelu(self.linear1(x), approximate="none"), mh)
        return self.norm2(x + drop(self.linear2(h), mf))
