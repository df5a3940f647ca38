"""PoseNet: transformer-encoder denoiser for the full 294-d body repr.

The port of rohm_tpu/models/posenet.py (reference model/posenet.py:11-96):
- x_t and condition each pass their own linear embedding, then are SUMMED
- a timestep token (PE-table lookup -> SiLU MLP) is prepended to the sequence
- sinusoidal positional encoding over the T+1 tokens
- post-LN transformer encoder (d=512, 4 heads, ff=1024, exact gelu)
- a linear head emits the 272-d pose part; the given trajectory (first 22
  dims of the condition) is concatenated back, so the output has 294 dims.

Module names follow the reference state_dict. The PE table is a
non-persistent buffer, so it is not part of the state_dict.
Layout: [B, T, 294]; any T. Eval mode only (no dropout).
"""

from __future__ import annotations

import torch
from torch import nn

from rohm_tpu_torch.models.blocks import TransformerEncoderLayer, transformer_pe_table
from rohm_tpu_torch.reprs.schema import TRAJ_FEAT_DIM_FULL


class _Linear(nn.Module):
    """A named single Linear (reference InputProcess / OutputProcess)."""

    def __init__(self, name: str, in_dim: int, out_dim: int):
        super().__init__()
        self.add_module(name, nn.Linear(in_dim, out_dim))
        self._name = name

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, self._name)(x)


class _TimestepEmbedder(nn.Module):
    def __init__(self, latent_dim: int):
        super().__init__()
        self.time_embed = nn.Sequential(
            nn.Linear(latent_dim, latent_dim), nn.SiLU(), nn.Linear(latent_dim, latent_dim)
        )


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class PoseNet(nn.Module):
    def __init__(
        self,
        body_feat_dim: int = 294,
        pose_feat_dim: int = 272,
        traj_feat_dim: int = TRAJ_FEAT_DIM_FULL,
        latent_dim: int = 512,
        ff_size: int = 1024,
        num_layers: int = 8,
        num_heads: int = 4,
        max_len: int = 5000,
    ):
        super().__init__()
        self.traj_feat_dim = traj_feat_dim
        self.latent_dim = latent_dim
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.register_buffer(
            "pe", torch.from_numpy(transformer_pe_table(max_len, latent_dim)), persistent=False
        )
        self.embed_timestep = _TimestepEmbedder(latent_dim)
        self.input_process = _Linear("poseEmbedding", body_feat_dim, latent_dim)
        self.input_process_cond = _Linear("poseEmbedding", body_feat_dim, latent_dim)
        self.seqTransEncoder = _Encoder(
            TransformerEncoderLayer(latent_dim, num_heads, ff_size) for _ in range(num_layers)
        )
        self.output_process = _Linear("poseFinal", latent_dim, pose_feat_dim)

    def timestep_token(self, t: torch.Tensor) -> torch.Tensor:
        """t [B] int -> [B, latent] (PE lookup -> SiLU MLP)."""
        return self.embed_timestep.time_embed(self.pe[t])

    @torch.no_grad()
    def forward(self, x_t: torch.Tensor, cond: torch.Tensor, t) -> torch.Tensor:
        """x_t, cond [B, T, 294]; t [B] or an int timestep -> [B, T, 294]."""
        bsz, seq_len, _ = x_t.shape
        t = torch.as_tensor(t, device=x_t.device).expand(bsz)
        emb = self.timestep_token(t)
        h = self.input_process(x_t) + self.input_process_cond(cond)
        seq = torch.cat([emb[:, None, :], h], dim=1) + self.pe[None, : seq_len + 1, :]
        for layer in self.seqTransEncoder.layers:
            seq = layer(seq)
        out = self.output_process(seq[:, 1:])
        return torch.cat([cond[..., : self.traj_feat_dim], out], dim=-1)
