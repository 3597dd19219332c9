"""PointNet++ MSG backbone, fused path (counterpart of
`pdm_ssd_tpu/models/backbones_3d/pointnet2_backbone.py`).

Only the fused set abstraction (`SA_CONFIG.FUSED`) is ported: `SAGroupMLP`
groups with `ops/sa_fused.fused_query_group` and splits the first shared-MLP
layer by linearity into `pre_feat` (features) and `pre_xyz` (relative xyz).
Levels whose input is the previous level's FPS output take the exact FPS
prefix instead of running FPS again.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...ops import dispatch, sa_fused
from ...ops.pointnet2 import gather_operation
from ...utils.config import as_cfg
from ..layers import BatchNormLast, SharedMLP


class SAGroupMLP(nn.Module):
    """Grouping + shared MLP + max-pool around given centers."""

    def __init__(self, in_channels: int, radii: Sequence[float], nsamples: Sequence[int],
                 mlps: Sequence[Sequence[int]], use_xyz: bool = True, pc_range=None,
                 bucket_cap: int = 32, device=None):
        super().__init__()
        if pc_range is None:
            raise ValueError('fused SA needs the BEV pc_range')
        if not use_xyz and in_channels == 0:
            raise ValueError('SA level with neither features nor xyz')
        self.radii = list(radii)
        self.nsamples = list(nsamples)
        self.use_xyz = use_xyz
        self.pc_range = tuple(pc_range)
        self.bucket_cap = bucket_cap
        self.in_channels = in_channels
        # wide inputs are projected by `pre_feat` before grouping (fewer
        # gathered channels); narrow ones are grouped as they are
        self.pre_transform = in_channels > 8
        self.h1 = [int(m[0]) for m in mlps]
        self.rest = [list(m[1:]) for m in mlps]
        for i, h in enumerate(self.h1):
            if in_channels > 0:
                self.add_module(f'pre_feat_{i}', nn.Linear(in_channels, h, bias=False,
                                                           device=device))
            if use_xyz:
                self.add_module(f'pre_xyz_{i}', nn.Linear(3, h, bias=False, device=device))
            self.add_module(f'bn0_{i}', BatchNormLast(h, eps=1e-5, momentum=0.1, device=device))
            if self.rest[i]:
                self.add_module(f'mlp_rest_{i}', SharedMLP(h, self.rest[i], device=device))

    def forward(self, xyz: torch.Tensor, features: torch.Tensor | None,
                new_xyz: torch.Tensor) -> torch.Tensor:
        payload, feat_slices = features, None
        if features is not None and self.pre_transform:
            payload = torch.cat([getattr(self, f'pre_feat_{i}')(features)
                                 for i in range(len(self.h1))], dim=-1)
            offs = [0]
            for h in self.h1:
                offs.append(offs[-1] + h)
            feat_slices = [(offs[i], offs[i + 1]) for i in range(len(self.h1))]
        outs = sa_fused.fused_query_group(self.radii, self.nsamples, xyz, payload, new_xyz,
                                          self.pc_range, cap=self.bucket_cap,
                                          feat_slices=feat_slices)
        branch = []
        for i, (rel, gfeat, _idx, _hit) in enumerate(outs):
            h = 0.0
            if features is not None:
                h = gfeat if self.pre_transform else getattr(self, f'pre_feat_{i}')(gfeat)
            if self.use_xyz:
                h = h + getattr(self, f'pre_xyz_{i}')(rel)
            h = torch.relu(getattr(self, f'bn0_{i}')(h))
            if self.rest[i]:
                h = getattr(self, f'mlp_rest_{i}')(h)
            branch.append(h.amax(dim=2))
        return torch.cat(branch, dim=-1)


class SAModuleMSGFused(nn.Module):
    """Sampling + `SAGroupMLP`. `sample_method` 'fps' runs FPS; 'prefix'
    takes the first `npoint` points."""

    def __init__(self, in_channels: int, npoint: int, radii, nsamples, mlps,
                 use_xyz: bool = True, pc_range=None, bucket_cap: int = 32, device=None):
        super().__init__()
        self.npoint = npoint
        self.agg = SAGroupMLP(in_channels, radii, nsamples, mlps, use_xyz=use_xyz,
                              pc_range=pc_range, bucket_cap=bucket_cap, device=device)

    def forward(self, xyz, features, sample_method: str = 'fps'):
        if sample_method == 'prefix':
            new_xyz = xyz[:, :self.npoint]
        else:
            fps_idx = dispatch.farthest_point_sample(xyz, self.npoint)
            new_xyz = gather_operation(xyz, fps_idx)
        return new_xyz, self.agg(xyz, features, new_xyz)


class PointNet2MSG(nn.Module):
    """Config-driven SA ladder (fused path). Input 'points' (B, N, 3 + C);
    adds 'point_features', 'point_coords', 'sa_xyz', 'sa_features'."""

    def __init__(self, model_cfg, input_channels: int, pc_range, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        sa = cfg.SA_CONFIG
        if not (sa.get('FUSED', False) and pc_range is not None):
            raise NotImplementedError('only the fused SA path is ported '
                                      '(ROADMAP Queue 1 item 2: ball query + grouping)')
        if len(cfg.get('FP_MLPS', [])) > 0:
            raise NotImplementedError('FP modules are not ported yet (ROADMAP Queue 1 item 2)')
        r = list(pc_range)
        self.bev_range = (r[0], r[1], r[3], r[4])
        self.npoints = list(sa.NPOINTS)
        methods = set(sa.get('SAMPLE_METHOD', ['fps']))
        if methods != {'fps'}:
            raise NotImplementedError(f'SAMPLE_METHOD {sorted(methods)}: only FPS sampling is '
                                      "ported ('random' is ROADMAP Queue 1 item 3)")
        self.prefix_ok = bool(sa.get('FPS_PREFIX', True))
        c_in = input_channels - 3
        for k in range(len(self.npoints)):
            mlps = [list(m) for m in sa.MLPS[k]]
            self.add_module(f'sa_{k}', SAModuleMSGFused(
                c_in, self.npoints[k], sa.RADIUS[k], sa.NSAMPLE[k], mlps,
                use_xyz=sa.get('USE_XYZ', True), pc_range=self.bev_range,
                bucket_cap=int(sa.get('BUCKET_CAP', 32)), device=device))
            c_in = sum(m[-1] for m in mlps)
        self.num_point_features = c_in

    def forward(self, batch: dict) -> dict:
        points = batch['points']
        xyz = points[..., 0:3]
        features = points[..., 3:] if points.shape[-1] > 3 else None
        l_xyz, l_features = [xyz], [features]
        for k in range(len(self.npoints)):
            # every level after the first reads the previous FPS output, so
            # its FPS is the prefix of that output
            prefix = k > 0 and self.prefix_ok and self.npoints[k] <= l_xyz[k].shape[1]
            li_xyz, li_feat = getattr(self, f'sa_{k}')(l_xyz[k], l_features[k],
                                                       'prefix' if prefix else 'fps')
            l_xyz.append(li_xyz)
            l_features.append(li_feat)
        batch['point_features'] = l_features[-1]
        batch['point_coords'] = l_xyz[-1]
        batch['sa_xyz'] = l_xyz
        batch['sa_features'] = l_features
        return batch
