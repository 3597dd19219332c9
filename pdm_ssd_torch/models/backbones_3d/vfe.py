"""Voxel feature encoders (counterpart of
`pdm_ssd_tpu/models/backbones_3d/vfe.py`): `MeanVFE`, `PillarVFE` (the
decorated points of each pillar through Linear + BatchNorm + ReLU layers and
a masked max) and `DynamicPillarVFE` (pillarize the raw points on the device,
`ops/pillarize.py`)."""
from __future__ import annotations

import torch
from torch import nn

from ...ops.pillarize import pillarize
from ...utils.config import as_cfg
from ..layers import BatchNormLast, masked_max


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


class PillarVFE(nn.Module):
    """Config: NUM_FILTERS, USE_NORM, WITH_DISTANCE, USE_ABSLOTE_XYZ. Each
    valid point of a pillar is decorated with its offsets from the pillar's
    mean and from the pillar's center; layer i is `pfn_<i>` (Linear, biased
    without norm) + `pfn_bn_<i>` + ReLU, then a max over the pillar's valid
    points, concatenated to every point before the next layer. Sets
    'pillar_features' (B, V, NUM_FILTERS[-1]); a pillar with no valid point
    pools to 0.

    BatchNorm takes its training statistics over all B * V * P rows, the
    padded points included (zeroed before the first layer), as flax's does."""

    def __init__(self, model_cfg, num_point_features: int, voxel_size, point_cloud_range,
                 device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        self.use_norm = cfg.get('USE_NORM', True)
        self.with_distance = cfg.get('WITH_DISTANCE', False)
        self.use_abs_xyz = cfg.get('USE_ABSLOTE_XYZ', True)
        self.filters = list(cfg.NUM_FILTERS)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.pc_origin = tuple(float(v) for v in point_cloud_range[:3])
        c_in = (num_point_features if self.use_abs_xyz else num_point_features - 3) + 6 \
            + int(self.with_distance)
        for i, ch in enumerate(self.filters):
            self.add_module(f'pfn_{i}', nn.Linear(c_in, ch, bias=not self.use_norm,
                                                  device=device))
            if self.use_norm:
                self.add_module(f'pfn_bn_{i}', BatchNormLast(ch, eps=1e-3, momentum=0.01,
                                                             device=device))
            c_in = 2 * ch

    def get_output_feature_dim(self) -> int:
        return self.filters[-1]

    def forward(self, batch: dict) -> dict:
        voxels, num_points = batch['voxels'], batch['voxel_num_points']
        coords = batch['voxel_coords']                               # (B, V, 3) zyx
        P = voxels.shape[2]
        dev, dt = voxels.device, voxels.dtype
        mask = torch.arange(P, device=dev)[None, None, :] < num_points[..., None]   # (B, V, P)
        xyz = voxels[..., :3]
        pts_mean = torch.where(mask[..., None], xyz, 0.0).sum(dim=2, keepdim=True) \
            / num_points[..., None, None].to(dt).clamp(min=1.0)
        f_cluster = xyz - pts_mean
        # float32 constants, as the JAX package's weakly typed Python floats
        size = torch.tensor(self.voxel_size, dtype=dt, device=dev)
        origin = torch.tensor(self.pc_origin, dtype=dt, device=dev)
        centers = (coords.flip(-1).to(dt) + 0.5) * size + origin       # xyz
        f_center = xyz - centers[:, :, None, :]
        feats = [voxels if self.use_abs_xyz else voxels[..., 3:], f_cluster, f_center]
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(xyz, dim=-1, keepdim=True))
        x = torch.where(mask[..., None], torch.cat(feats, dim=-1), 0.0)
        for i, ch in enumerate(self.filters):
            x = getattr(self, f'pfn_{i}')(x)
            if self.use_norm:
                x = getattr(self, f'pfn_bn_{i}')(x)
            x = torch.relu(x)
            pooled = masked_max(x, mask, dim=2)                        # (B, V, ch)
            if i < len(self.filters) - 1:
                x = torch.cat([x, pooled[:, :, None, :].expand_as(x)], dim=-1)
        batch['pillar_features'] = pooled
        return batch


class DynamicPillarVFE(nn.Module):
    """Pillarize the raw points on the device (`ops/pillarize.py`, one
    scatter-add) straight into the BEV canvas 'spatial_features' (B, H, W,
    C + 3) at stride 1; no parameters."""

    def __init__(self, model_cfg, num_point_features: int, voxel_size, point_cloud_range,
                 grid_size):
        super().__init__()
        self.num_point_features = num_point_features
        self.voxel_size = tuple(float(v) for v in voxel_size[:2])
        self.pc_range = tuple(float(v) for v in point_cloud_range)
        self.grid_size = (int(grid_size[0]), int(grid_size[1]))

    def get_output_feature_dim(self) -> int:
        return self.num_point_features + 3

    def forward(self, batch: dict) -> dict:
        batch['spatial_features'] = pillarize(batch['points'], self.grid_size, self.voxel_size,
                                              self.pc_range, mask=batch.get('points_mask'))
        batch['spatial_features_stride'] = 1
        return batch


def build_vfe(vfe_cfg, num_point_features: int, voxel_size, point_cloud_range, grid_size,
              device=None) -> nn.Module:
    """The VFE a config names: `PillarVFE`, `DynamicPillarVFE`, or (any other
    name, as the JAX `Detector3D` reads it) `MeanVFE`."""
    name = vfe_cfg.NAME
    if name == 'PillarVFE':
        return PillarVFE(vfe_cfg, num_point_features, voxel_size, point_cloud_range,
                         device=device)
    if name == 'DynamicPillarVFE':
        return DynamicPillarVFE(vfe_cfg, num_point_features, voxel_size, point_cloud_range,
                                grid_size)
    return MeanVFE(vfe_cfg, num_point_features)
