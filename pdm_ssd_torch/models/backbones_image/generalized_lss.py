"""GeneralizedLSSFPN image neck (counterpart of
`pdm_ssd_tpu/models/backbones_image/generalized_lss.py`).

A top-down pyramid: from the coarsest used level down, each level
concatenates its lateral input with the next coarser level upsampled
bilinearly to its size (the coarsest with the backbone's next stage as it
comes), then a 1x1 `lateral_<i>` and a 3x3 `fpn_<i>` `BasicBlock2D` (conv
without bias, BatchNorm at epsilon 1e-5, ReLU). The JAX package's bilinear
`jax.image.resize` of an upsampling is `F.interpolate(..., mode='bilinear',
align_corners=False)`: half-pixel centres, the edge pixels' weights
renormalised where the JAX package drops the samples off the map and torch
clamps them to the edge, which weighs the same pixel.

Maps are (B, N, h, w, C) at the boundaries, NCHW inside.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ...utils.config import as_cfg
from ..layers import BatchNorm2d


class BasicBlock2D(nn.Module):
    """k x k conv (padding k // 2, no bias) `conv`, BatchNorm `bn`, ReLU; NCHW."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1, device=None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, padding=kernel_size // 2,
                              bias=False, device=device)
        self.bn = BatchNorm2d(out_channels, eps=1e-5, momentum=0.1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class GeneralizedLSSFPN(nn.Module):
    """Config: IN_CHANNELS (per input level, finest first), OUT_CHANNELS,
    START_LEVEL, END_LEVEL (-1: all but the last level are outputs)."""

    def __init__(self, model_cfg, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        self.in_channels = [int(c) for c in cfg.IN_CHANNELS]
        out = int(cfg.OUT_CHANNELS)
        self.start = int(cfg.get('START_LEVEL', 0))
        end = int(cfg.get('END_LEVEL', -1))
        self.n_used = (len(self.in_channels) - 1) if end == -1 else end
        self.order = list(range(self.n_used - 1 - self.start, self.start - 1, -1))
        for j, i in enumerate(self.order):
            coarser = self.in_channels[i + 1] if j == 0 else out
            self.add_module(f'lateral_{i}', BasicBlock2D(self.in_channels[i] + coarser, out, 1,
                                                         device=device))
            self.add_module(f'fpn_{i}', BasicBlock2D(out, out, 3, device=device))
        self.out_channels = out

    def forward(self, feats: list) -> list:
        """feats: (B, N, h_i, w_i, C_i), finest first. Returns (B, N, h_i, w_i,
        OUT_CHANNELS) for levels START_LEVEL .. the last used one."""
        if len(feats) != len(self.in_channels):
            raise ValueError(f'{len(feats)} levels for IN_CHANNELS {self.in_channels}')
        B, N = feats[0].shape[:2]
        lat = [f.reshape(B * N, *f.shape[2:]).permute(0, 3, 1, 2) for f in feats]
        for i in self.order:
            up = F.interpolate(lat[i + 1], size=lat[i].shape[2:], mode='bilinear',
                               align_corners=False)
            x = getattr(self, f'lateral_{i}')(torch.cat([lat[i], up], dim=1))
            lat[i] = getattr(self, f'fpn_{i}')(x)
        return [lat[i].permute(0, 2, 3, 1).reshape(B, N, *lat[i].shape[2:], lat[i].shape[1])
                for i in range(self.start, self.n_used)]
