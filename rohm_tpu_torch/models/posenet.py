"""PoseNet: transformer-encoder denoiser for the full 294-d body repr.

The port of rohm_tpu/models/posenet.py (reference model/posenet.py:11-96):
- x_t and condition each pass their own linear embedding, then are SUMMED
- a timestep token (PE-table lookup -> SiLU MLP) is prepended to the sequence
- sinusoidal positional encoding over the T+1 tokens
- post-LN transformer encoder (d=512, 4 heads, ff=1024, exact gelu)
- a linear head emits the 272-d pose part; the given trajectory (first 22
  dims of the condition) is concatenated back, so the output has 294 dims.

dtype (`--model_dtype`): the compute dtype of the timestep MLP, the two
input projections and the encoder layers' products and attention; the
positional table, the LayerNorms and the output head stay float32 (flax's
`seq + pe` promotes the stack's input to float32, and its head runs on
`seq[:, 1:].astype(float32)`). Parameters are float32 in every dtype.

Module names follow the reference state_dict. The PE table is a
non-persistent buffer, so it is not part of the state_dict.
Layout: [B, T, 294]; any T. `forward` is the eval mode (no dropout, no
autograd); `forward_train` is the differentiable train mode, with dropout
(rate `dropout`) from keep-masks the caller draws
(ops/transformer_layer_train.py::posenet_dropout_masks).
"""

from __future__ import annotations

import torch
from torch import nn

from rohm_tpu_torch.models.blocks import TransformerEncoderLayer, linear, silu, transformer_pe_table
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
        dropout: float = 0.1,
        dtype=torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.traj_feat_dim = traj_feat_dim
        self.dropout = dropout
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
            TransformerEncoderLayer(latent_dim, num_heads, ff_size, dtype) for _ in range(num_layers)
        )
        self.output_process = _Linear("poseFinal", latent_dim, pose_feat_dim)

    def timestep_token(self, t: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """t [B] int -> [B, latent] (PE lookup -> SiLU MLP) in `dtype`."""
        te = self.embed_timestep.time_embed
        return linear(te[2], silu(linear(te[0], self.pe[t], dtype)), dtype)

    def embed_tokens(self, x_t: torch.Tensor, cond: torch.Tensor, t, dtype=None) -> torch.Tensor:
        """The encoder's float32 input [B, T+1, latent]: the timestep token,
        then the summed x_t and cond embeddings (computed in `dtype`, the
        module's by default), plus the positional table."""
        dtype = dtype or self.dtype
        bsz, seq_len, _ = x_t.shape
        t = torch.as_tensor(t, device=x_t.device).expand(bsz)
        emb = self.timestep_token(t, dtype)
        h = (linear(self.input_process.poseEmbedding, x_t, dtype)
             + linear(self.input_process_cond.poseEmbedding, cond, dtype))
        return torch.cat([emb[:, None, :], h], dim=1) + self.pe[None, : seq_len + 1, :]

    def output_head(self, seq: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """Drop the timestep token, project to the pose dims and put the
        condition's trajectory dims in front -> [B, T, 294]."""
        out = self.output_process(seq[:, 1:].float())
        return torch.cat([cond[..., : self.traj_feat_dim], out], dim=-1)

    @torch.no_grad()
    def forward(self, x_t: torch.Tensor, cond: torch.Tensor, t) -> torch.Tensor:
        """x_t, cond [B, T, 294]; t [B] or an int timestep -> [B, T, 294]."""
        seq = self.embed_tokens(x_t, cond, t)
        for layer in self.seqTransEncoder.layers:
            seq = layer(seq)
        return self.output_head(seq, cond)

    def forward_train(self, x_t: torch.Tensor, cond: torch.Tensor, t: torch.Tensor,
                      masks: tuple, layer_fn=None) -> torch.Tensor:
        """Train mode (flax PoseNet.apply(..., train=True)): dropout after
        the positional encoding and inside every layer. masks: (input
        keep-mask [B, T+1, latent] bool, or None at dropout 0; one
        4-tuple of int8 keep-masks per layer). layer_fn(layer, seq,
        layer_masks, dropout) runs one encoder layer; the default is the
        layer's own forward_train (ops.posenet_apply_train passes the
        fused training layer). With a layer_fn the embeddings run in
        float32 whatever the module's dtype: the JAX package's fused
        training forward takes the raw params and ignores model.dtype."""
        seq = self.embed_tokens(x_t, cond, t, torch.float32 if layer_fn is not None else None)
        keep, layer_masks = masks
        if self.dropout > 0:
            seq = torch.where(keep, seq / (1.0 - self.dropout), 0.0)
        for layer, m in zip(self.seqTransEncoder.layers, layer_masks):
            seq = (layer_fn(layer, seq, m, self.dropout) if layer_fn is not None
                   else layer.forward_train(seq, m, self.dropout))
        return self.output_head(seq, cond)
