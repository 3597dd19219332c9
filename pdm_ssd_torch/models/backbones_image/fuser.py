"""Camera-LiDAR BEV fuser (counterpart of
`pdm_ssd_tpu/models/backbones_image/fuser.py`): both NHWC maps
concatenated (LiDAR first), a 3x3 conv without bias `fuse_conv`, BatchNorm
`fuse_bn` (epsilon 1e-5), ReLU."""
from __future__ import annotations

import torch
from torch import nn

from ...utils.config import as_cfg
from ..layers import BatchNorm2d


class ConvFuser(nn.Module):
    def __init__(self, model_cfg, in_channels: int, device=None):
        super().__init__()
        self.num_bev_features = int(as_cfg(model_cfg).OUT_CHANNEL)
        self.fuse_conv = nn.Conv2d(in_channels, self.num_bev_features, 3, padding=1, bias=False,
                                   device=device)
        self.fuse_bn = BatchNorm2d(self.num_bev_features, eps=1e-5, momentum=0.1, device=device)

    def forward(self, lidar_bev: torch.Tensor, camera_bev: torch.Tensor) -> torch.Tensor:
        x = torch.cat([lidar_bev, camera_bev], dim=-1).permute(0, 3, 1, 2)
        return torch.relu(self.fuse_bn(self.fuse_conv(x))).permute(0, 2, 3, 1)
