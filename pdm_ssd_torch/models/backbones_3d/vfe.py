"""Voxel feature encoders (counterpart of
`pdm_ssd_tpu/models/backbones_3d/vfe.py`). Only `MeanVFE` is ported."""
from __future__ import annotations

import torch
from torch import nn


class MeanVFE(nn.Module):
    """Mean of each voxel's valid points: 'voxels' (B, V, P, C) and
    'voxel_num_points' (B, V) -> 'voxel_features' (B, V, C)."""

    def __init__(self, model_cfg, num_point_features: int):
        super().__init__()
        self.num_point_features = num_point_features

    def get_output_feature_dim(self) -> int:
        return self.num_point_features

    def forward(self, batch: dict) -> dict:
        voxels, num_points = batch['voxels'], batch['voxel_num_points']
        P = voxels.shape[2]
        mask = torch.arange(P, device=voxels.device)[None, None, :] < num_points[..., None]
        summed = torch.where(mask[..., None], voxels, 0.0).sum(dim=2)
        batch['voxel_features'] = summed / num_points[..., None].to(voxels.dtype).clamp(min=1.0)
        return batch


def build_vfe(vfe_cfg, num_point_features: int) -> nn.Module:
    name = vfe_cfg.NAME
    if name != 'MeanVFE':
        raise NotImplementedError(f'VFE {name} is not ported yet '
                                  '(ROADMAP Queue 1 item 9, the pillar family)')
    return MeanVFE(vfe_cfg, num_point_features)
