"""TrajNet: conditional 1-D temporal U-Net predicting the clean traj repr x0.

A frozen copy of rohm_tpu_torch/models/trajnet.py (reference model/trajnet.py:10-275):
- a condition encoder ingests the noisy/masked input trajectory; its four
  per-scale feature maps are concatenated into every U-Net encoder downsample
- the diffusion U-Net denoises x_t given the timestep embedding
- optional ControlNet branch (TrajControl): a copy of the U-Net encoder fed
  with local-pose features through a zero conv, producing five zero-conv
  residuals added at the mid block and each decoder stage.

Public layout: [B, T, traj_feat_dim]; T must be divisible by 16 (4
downsamples). Inside, the convolutions run on [B, C, T].

dtype (`--model_dtype`) goes to every block and the time MLP; the zero
convs and the final 1x1 conv run in float32 (the final one on
`x.astype(float32)`, as in flax), so the output is float32 in every dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from .blocks import (
    Conv1dBlock,
    Downsample1d,
    ResidualTemporalBlock,
    SinusoidalPosEmb,
    Upsample1d,
    conv1d,
    linear,
    mish,
    zero_conv1x1,
)


class ControlNet(nn.Module):
    """TrajControl branch: zero-conv'd copy of the U-Net encoder."""

    def __init__(self, traj_feat_dim: int, mid_dim: int, time_dim: int, control_cond_dim: int,
                 dtype=torch.float32):
        super().__init__()
        m, dt = mid_dim, dtype
        self.control_zero_conv_0 = zero_conv1x1(control_cond_dim, traj_feat_dim)
        self.control_enc1 = ResidualTemporalBlock(traj_feat_dim, m // 8, time_dim, dtype=dt)
        self.control_zero_conv_1 = zero_conv1x1(m // 8, 32)
        self.control_downsample1 = Downsample1d(m // 4, dt)
        self.control_enc2 = ResidualTemporalBlock(m // 4, m // 4, time_dim, dtype=dt)
        self.control_zero_conv_2 = zero_conv1x1(m // 4, m // 8)
        self.control_downsample2 = Downsample1d(m // 2, dt)
        self.control_enc3 = ResidualTemporalBlock(m // 2, m // 2, time_dim, dtype=dt)
        self.control_zero_conv_3 = zero_conv1x1(m // 2, m // 4)
        self.control_downsample3 = Downsample1d(m, dt)
        self.control_enc4 = ResidualTemporalBlock(m, m, time_dim, dtype=dt)
        self.control_zero_conv_4 = zero_conv1x1(m, m // 2)
        self.control_downsample4 = Downsample1d(2 * m, dt)
        self.control_mid_block1 = ResidualTemporalBlock(2 * m, m, time_dim, dtype=dt)
        self.control_mid_block2 = ResidualTemporalBlock(m, m, time_dim, dtype=dt)
        self.control_zero_conv_mid = zero_conv1x1(m, m)

    def forward(self, control_cond, h_cond, t_embed):
        def zero(conv, x):  # the zero convs have no dtype: float32, as in flax
            return conv1d(conv, x, torch.float32)

        x = zero(self.control_zero_conv_0, control_cond)
        x = self.control_enc1(x, t_embed)
        zc1 = zero(self.control_zero_conv_1, x)
        x = self.control_downsample1(torch.cat([x, h_cond[0]], dim=1))
        x = self.control_enc2(x, t_embed)
        zc2 = zero(self.control_zero_conv_2, x)
        x = self.control_downsample2(torch.cat([x, h_cond[1]], dim=1))
        x = self.control_enc3(x, t_embed)
        zc3 = zero(self.control_zero_conv_3, x)
        x = self.control_downsample3(torch.cat([x, h_cond[2]], dim=1))
        x = self.control_enc4(x, t_embed)
        zc4 = zero(self.control_zero_conv_4, x)
        x = self.control_downsample4(torch.cat([x, h_cond[3]], dim=1))
        x = self.control_mid_block1(x, t_embed)
        x = self.control_mid_block2(x, t_embed)
        return zc1, zc2, zc3, zc4, zero(self.control_zero_conv_mid, x)


class TrajNet(nn.Module):
    """U-Net denoiser for the trajectory repr (13-d abs-only or 22-d full)."""

    def __init__(
        self,
        traj_feat_dim: int = 13,
        cond_dim: int = 13,
        mid_dim: int = 512,
        time_dim: int = 32,
        trajcontrol: bool = False,
        control_cond_dim: int = 272,
        dtype=torch.float32,
    ):
        super().__init__()
        m, dt = mid_dim, dtype
        self.dtype = dtype
        self.trajcontrol = trajcontrol
        self.time_mlp = nn.Sequential(
            SinusoidalPosEmb(time_dim),
            nn.Linear(time_dim, time_dim * 4),
            nn.Mish(),
            nn.Linear(time_dim * 4, time_dim),
        )
        # condition encoder: 4 blocks, 3 downsamples
        self.cond_enc1 = ResidualTemporalBlock(cond_dim, m // 8, None, dtype=dt)
        self.cond_downsample1 = Downsample1d(m // 8, dt)
        self.cond_enc2 = ResidualTemporalBlock(m // 8, m // 4, None, dtype=dt)
        self.cond_downsample2 = Downsample1d(m // 4, dt)
        self.cond_enc3 = ResidualTemporalBlock(m // 4, m // 2, None, dtype=dt)
        self.cond_downsample3 = Downsample1d(m // 2, dt)
        self.cond_enc4 = ResidualTemporalBlock(m // 2, m, None, dtype=dt)
        # U-Net encoder + mid
        self.diff_enc1 = ResidualTemporalBlock(traj_feat_dim, m // 8, time_dim, dtype=dt)
        self.diff_downsample1 = Downsample1d(m // 4, dt)
        self.diff_enc2 = ResidualTemporalBlock(m // 4, m // 4, time_dim, dtype=dt)
        self.diff_downsample2 = Downsample1d(m // 2, dt)
        self.diff_enc3 = ResidualTemporalBlock(m // 2, m // 2, time_dim, dtype=dt)
        self.diff_downsample3 = Downsample1d(m, dt)
        self.diff_enc4 = ResidualTemporalBlock(m, m, time_dim, dtype=dt)
        self.diff_downsample4 = Downsample1d(2 * m, dt)
        self.diff_mid_block1 = ResidualTemporalBlock(2 * m, m, time_dim, dtype=dt)
        self.diff_mid_block2 = ResidualTemporalBlock(m, m, time_dim, dtype=dt)
        # decoder
        self.diff_upsample4 = Upsample1d(m, dt)
        self.diff_dec4 = ResidualTemporalBlock(2 * m, m // 2, time_dim, dtype=dt)
        self.diff_upsample3 = Upsample1d(m // 2, dt)
        self.diff_dec3 = ResidualTemporalBlock(m, m // 4, time_dim, dtype=dt)
        self.diff_upsample2 = Upsample1d(m // 4, dt)
        self.diff_dec2 = ResidualTemporalBlock(m // 2, m // 8, time_dim, dtype=dt)
        self.diff_upsample1 = Upsample1d(m // 8, dt)
        self.diff_dec1 = ResidualTemporalBlock(m // 4, 32, time_dim, dtype=dt)
        self.diff_final_conv = nn.Sequential(Conv1dBlock(32, 32, 5, dtype=dt), nn.Conv1d(32, traj_feat_dim, 1))
        if trajcontrol:
            self.controlnet = ControlNet(traj_feat_dim, m, time_dim, control_cond_dim, dt)

    def encode_cond(self, cond: torch.Tensor) -> list[torch.Tensor]:
        """Noisy-trajectory encoder on [B, C, T]: maps at T, T/2, T/4, T/8."""
        h = [self.cond_enc1(cond, None)]
        h.append(self.cond_enc2(self.cond_downsample1(h[-1]), None))
        h.append(self.cond_enc3(self.cond_downsample2(h[-1]), None))
        h.append(self.cond_enc4(self.cond_downsample3(h[-1]), None))
        return h

    @torch.no_grad()
    def forward(self, x_t, cond, t, control_cond=None) -> torch.Tensor:
        """x_t [B, T, traj_feat_dim], cond [B, T, cond_dim], t [B] or int,
        control_cond [B, T, 272] (TrajControl only) -> [B, T, traj_feat_dim]."""
        return self.forward_train(x_t, cond, t, control_cond)

    def forward_train(self, x_t, cond, t, control_cond=None) -> torch.Tensor:
        """The same forward under autograd, for training (TrajNet has no
        dropout, so train and eval mode compute the same function)."""
        bsz, seq_len, _ = x_t.shape
        if seq_len % 16:
            raise ValueError(f"TrajNet needs T divisible by 16, got {seq_len}")
        t = torch.as_tensor(t, device=x_t.device).expand(bsz)
        mlp, dt = self.time_mlp, self.dtype
        t_embed = linear(mlp[3], mish(linear(mlp[1], mlp[0](t), dt)), dt)
        h_cond = self.encode_cond(cond.transpose(1, 2))
        if self.trajcontrol:
            if control_cond is None:
                raise ValueError("a TrajControl model needs control_cond")
            zc1, zc2, zc3, zc4, zc_mid = self.controlnet(
                control_cond.transpose(1, 2), h_cond, t_embed
            )

        x = self.diff_enc1(x_t.transpose(1, 2), t_embed)
        h1 = x
        x = self.diff_enc2(self.diff_downsample1(torch.cat([x, h_cond[0]], dim=1)), t_embed)
        h2 = x
        x = self.diff_enc3(self.diff_downsample2(torch.cat([x, h_cond[1]], dim=1)), t_embed)
        h3 = x
        x = self.diff_enc4(self.diff_downsample3(torch.cat([x, h_cond[2]], dim=1)), t_embed)
        h4 = x
        x = self.diff_downsample4(torch.cat([x, h_cond[3]], dim=1))

        x = self.diff_mid_block2(self.diff_mid_block1(x, t_embed), t_embed)
        if self.trajcontrol:
            x = x + zc_mid

        x = self.diff_dec4(torch.cat([self.diff_upsample4(x), h4], dim=1), t_embed)
        if self.trajcontrol:
            x = x + zc4
        x = self.diff_dec3(torch.cat([self.diff_upsample3(x), h3], dim=1), t_embed)
        if self.trajcontrol:
            x = x + zc3
        x = self.diff_dec2(torch.cat([self.diff_upsample2(x), h2], dim=1), t_embed)
        if self.trajcontrol:
            x = x + zc2
        x = self.diff_dec1(torch.cat([self.diff_upsample1(x), h1], dim=1), t_embed)
        if self.trajcontrol:
            x = x + zc1
        x = self.diff_final_conv[0](x)
        return conv1d(self.diff_final_conv[1], x.float()).transpose(1, 2)
