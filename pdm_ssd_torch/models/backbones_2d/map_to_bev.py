"""Map-to-BEV modules (counterpart of
`pdm_ssd_tpu/models/backbones_2d/map_to_bev.py`). Maps are NHWC at the
boundaries, as in the JAX package.

- `PointPillarScatter`: pillar features -> the dense BEV canvas in one
  `index_add_` into an (H * W + 1)-row canvas whose last row takes the
  invalid pillars; valid pillars hold disjoint cells, so add equals set and
  the atomics of CUDA's `index_add_` add to zeros only.
- `HeightCompression`: fold the depth of a dense (B, D, H, W, C) volume into
  channels.
- `Conv2DCollapse`: the same fold, then 1x1 Conv + BatchNorm + ReLU.
"""
from __future__ import annotations

import torch
from torch import nn

from ...utils.config import as_cfg
from ..layers import BatchNorm2d


class PointPillarScatter(nn.Module):
    """'pillar_features' (B, V, C) at 'voxel_coords' (B, V, 3) zyx, valid
    where 'voxel_mask' is and the cell lies in the grid -> 'spatial_features'
    (B, H, W, C), stride 1."""

    def __init__(self, model_cfg, grid_size):
        super().__init__()
        self.num_bev_features = as_cfg(model_cfg).NUM_BEV_FEATURES
        self.grid_size = (int(grid_size[0]), int(grid_size[1]))

    def forward(self, batch: dict) -> dict:
        feats, coords = batch['pillar_features'], batch['voxel_coords']
        B, V, C = feats.shape
        W, H = self.grid_size
        ncells = H * W
        iy, ix = coords[..., 1].long(), coords[..., 2].long()
        ok = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        if batch.get('voxel_mask') is not None:
            ok = ok & batch['voxel_mask']
        b = torch.arange(B, device=feats.device)[:, None] * (ncells + 1)
        rows = b + torch.where(ok, iy * W + ix, ncells)
        canvas = torch.zeros((B * (ncells + 1), C), dtype=feats.dtype, device=feats.device)
        canvas.index_add_(0, rows.reshape(-1), torch.where(ok[..., None], feats, 0.0)
                          .reshape(-1, C))
        batch['spatial_features'] = canvas.view(B, ncells + 1, C)[:, :ncells].reshape(B, H, W, C)
        batch['spatial_features_stride'] = 1
        return batch


class HeightCompression(nn.Module):
    """'dense_voxel_features', 5-D, folded as the JAX package folds it: read
    as (B, H, W, D, C), or moved there first when 'voxel_layout' is 'DHWC',
    -> 'spatial_features' (B, H, W, D * C)."""

    def __init__(self, model_cfg):
        super().__init__()
        self.num_bev_features = as_cfg(model_cfg).NUM_BEV_FEATURES

    def forward(self, batch: dict) -> dict:
        x = batch['dense_voxel_features']
        if x.dim() == 5:
            if batch.get('voxel_layout') == 'DHWC':
                x = x.permute(0, 2, 3, 1, 4)
            B, H, W, D, C = x.shape
            x = x.reshape(B, H, W, D * C)
        batch['spatial_features'] = x
        return batch


class Conv2DCollapse(nn.Module):
    """The fold of the JAX module (which moves no axis), then `collapse`
    (1x1 Conv, no bias) + `bn` + ReLU to NUM_BEV_FEATURES channels."""

    def __init__(self, model_cfg, input_channels: int, device=None):
        super().__init__()
        self.num_bev_features = as_cfg(model_cfg).NUM_BEV_FEATURES
        self.collapse = nn.Conv2d(input_channels, self.num_bev_features, 1, bias=False,
                                  device=device)
        self.bn = BatchNorm2d(self.num_bev_features, eps=1e-3, momentum=0.01, device=device)

    def forward(self, batch: dict) -> dict:
        x = batch['dense_voxel_features']
        if x.dim() == 5:
            B, H, W, D, C = x.shape
            x = x.reshape(B, H, W, D * C)
        x = torch.relu(self.bn(self.collapse(x.permute(0, 3, 1, 2))))
        batch['spatial_features'] = x.permute(0, 2, 3, 1)
        return batch


def build_map_to_bev(cfg, grid_size, input_channels: int, device=None) -> nn.Module:
    name = cfg.NAME
    if name == 'PointPillarScatter':
        return PointPillarScatter(cfg, grid_size)
    if name == 'HeightCompression':
        return HeightCompression(cfg)
    if name == 'Conv2DCollapse':
        return Conv2DCollapse(cfg, input_channels, device=device)
    raise KeyError(f'unknown MAP_TO_BEV {name}')
