"""Grid point backbone (counterpart of
`pdm_ssd_tpu/models/backbones_3d/grid_point_backbone.py`): pillarize the
cloud onto a BEV grid in one scatter-add, then a stack of 3x3 Conv + BN +
ReLU levels, stride 2 between levels.

Takes 'points' (B, N, C) (and 'points_mask' where present) and sets
'multi_scale_bev' (one NHWC map per level), 'spatial_features' (the last
level, NHWC) and 'spatial_features_stride'; like the JAX module it sets no
point keys. The convolutions run in NCHW.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.pillarize import pillarize
from ...utils.config import as_cfg
from ..layers import ConvBNReLU


class GridPointBackbone(nn.Module):
    """Config: CELL_SIZE (m), GRID_SIZE [W, H] at that cell, NUM_FILTERS and
    LAYER_NUMS per level; level k runs at 2^k * CELL_SIZE."""

    def __init__(self, model_cfg, input_channels: int, pc_range, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        self.cfg = cfg
        self.pc_range = tuple(float(v) for v in pc_range)
        self.layer_nums = list(cfg.LAYER_NUMS)
        c_in = input_channels + 3               # pillar means (C + 2) and log1p(count)
        for lvl, (c, n) in enumerate(zip(cfg.NUM_FILTERS, cfg.LAYER_NUMS)):
            self.add_module(f'lvl{lvl}_down', ConvBNReLU(c_in, c, 3, stride=1 if lvl == 0 else 2,
                                                         device=device))
            for k in range(n):
                self.add_module(f'lvl{lvl}_conv{k}', ConvBNReLU(c, c, 3, device=device))
            c_in = c
        self.num_point_features = cfg.NUM_FILTERS[-1]

    def pillarize(self, batch: dict) -> torch.Tensor:
        """The level-0 input, (B, C+3, H, W)."""
        cell = self.cfg.CELL_SIZE
        x = pillarize(batch['points'], tuple(self.cfg.GRID_SIZE), (cell, cell), self.pc_range,
                      mask=batch.get('points_mask'))
        return x.permute(0, 3, 1, 2)

    def level(self, lvl: int, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, f'lvl{lvl}_down')(x)
        for k in range(self.layer_nums[lvl]):
            x = getattr(self, f'lvl{lvl}_conv{k}')(x)
        return x

    def forward(self, batch: dict) -> dict:
        x = self.pillarize(batch)
        maps = []
        for lvl in range(len(self.layer_nums)):
            x = self.level(lvl, x)
            maps.append(x.permute(0, 2, 3, 1))          # NCHW -> NHWC
        batch['multi_scale_bev'] = maps
        batch['spatial_features'] = maps[-1]
        batch['spatial_features_stride'] = 2 ** (len(self.layer_nums) - 1)
        return batch
