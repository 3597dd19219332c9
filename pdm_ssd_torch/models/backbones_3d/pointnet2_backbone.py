"""PointNet++ MSG backbone (counterpart of
`pdm_ssd_tpu/models/backbones_3d/pointnet2_backbone.py`).

Two set-abstraction paths, chosen by `SA_CONFIG.FUSED` as in the JAX package:

- `SAModuleMSG`: the exact first-K ball query over the whole cloud
  (`dispatch.ball_query_level`), grouping by row gather
  (`dispatch.grouping_operation`), shared MLP, max over the ball;
- `SAModuleMSGFused`: `SAGroupMLP` groups with `ops/sa_fused.fused_query_group`
  over a 3x3 cell window and splits the first shared-MLP layer by linearity
  into `pre_feat` (features) and `pre_xyz` (relative xyz).

`FPModule` propagates features back to a denser level by three-nearest-
neighbor interpolation. Levels whose input is the previous level's FPS
output take the exact FPS prefix instead of running FPS again.
"""
from __future__ import annotations

import warnings
from typing import Sequence

import torch
from torch import nn

from ...ops import dispatch, sa_fused
from ...ops import pointnet2 as p2
from ...utils.config import as_cfg
from ..layers import BatchNormLast, SharedMLP


def sample_centers(xyz: torch.Tensor, npoint: int, method: str,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """The centers of one SA level, (B, npoint, 3). 'fps' runs FPS; 'prefix'
    takes the first `npoint` points (exact FPS on an input in FPS pick
    order); 'random' takes one permutation's prefix for every cloud of the
    batch when a generator is given, and the plain prefix otherwise (uniform
    where the caller has shuffled the points)."""
    if method == 'random' and generator is not None:
        perm = torch.randperm(xyz.shape[1], generator=generator)[:npoint]
        return xyz[:, perm.to(xyz.device)]
    if method in ('random', 'prefix'):
        return xyz[:, :npoint]
    if method != 'fps':
        raise ValueError(f'unknown SAMPLE_METHOD {method!r}')
    return p2.gather_operation(xyz, dispatch.farthest_point_sample(xyz, npoint))


class SAModuleMSG(nn.Module):
    """Set abstraction with multi-scale grouping: sampling, then for each
    radius ball query, grouping, shared MLP and the max over the ball."""

    def __init__(self, in_channels: int, npoint: int, radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]], use_xyz: bool = True,
                 device=None):
        super().__init__()
        self.npoint = npoint
        self.radii = list(radii)
        self.nsamples = list(nsamples)
        self.use_xyz = use_xyz
        # without features the relative xyz is grouped whatever `use_xyz` says
        c_in = in_channels + 3 if (use_xyz or in_channels == 0) else in_channels
        for i, mlp in enumerate(mlps):
            self.add_module(f'mlp_{i}', SharedMLP(c_in, list(mlp), device=device))

    def forward(self, xyz: torch.Tensor, features: torch.Tensor | None,
                sample_method: str = 'fps', generator: torch.Generator | None = None):
        """xyz (B, N, 3), features (B, N, C) or None -> new_xyz (B, npoint, 3),
        new features (B, npoint, sum of the branches' last widths)."""
        new_xyz = sample_centers(xyz, self.npoint, sample_method, generator)
        outs = []
        idxs = dispatch.ball_query_level(self.radii, self.nsamples, xyz, new_xyz)
        for i, idx in enumerate(idxs):
            grouped = dispatch.grouping_operation(xyz, idx) - new_xyz[:, :, None, :]
            if features is not None:
                grouped_feats = dispatch.grouping_operation(features, idx)
                grouped = (torch.cat([grouped, grouped_feats], dim=-1) if self.use_xyz
                           else grouped_feats)
            outs.append(getattr(self, f'mlp_{i}')(grouped).amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


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
    """Sampling + `SAGroupMLP`: the fused counterpart of `SAModuleMSG`."""

    def __init__(self, in_channels: int, npoint: int, radii, nsamples, mlps,
                 use_xyz: bool = True, pc_range=None, bucket_cap: int = 32, device=None):
        super().__init__()
        self.npoint = npoint
        self.agg = SAGroupMLP(in_channels, radii, nsamples, mlps, use_xyz=use_xyz,
                              pc_range=pc_range, bucket_cap=bucket_cap, device=device)

    def forward(self, xyz, features, sample_method: str = 'fps',
                generator: torch.Generator | None = None):
        new_xyz = sample_centers(xyz, self.npoint, sample_method, generator)
        return new_xyz, self.agg(xyz, features, new_xyz)


class FPModule(nn.Module):
    """Feature propagation: three-nearest-neighbor inverse-distance
    interpolation of the known level's features, the unknown level's own
    features behind them, then a shared MLP."""

    def __init__(self, in_channels: int, mlp: Sequence[int], device=None):
        super().__init__()
        self.mlp = SharedMLP(in_channels, list(mlp), device=device)

    def forward(self, unknown, known, unknown_feats, known_feats):
        dist2, idx = p2.three_nn(unknown, known)
        interp = p2.three_interpolate(known_feats, idx, p2.three_interpolate_weights(dist2))
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return self.mlp(interp)


class PointNet2MSG(nn.Module):
    """Config-driven SA + FP ladder. Input 'points' (B, N, 3 + C); adds
    'point_features', 'point_coords', 'sa_xyz', 'sa_features'.

    `num_point_features` is the width of the level `forward` really returns.
    With as many `FP_MLPS` entries as SA levels that is `FP_MLPS[0][-1]`; with
    fewer, the densest level is never propagated to and the module returns
    the raw input features, as the JAX package does."""

    def __init__(self, model_cfg, input_channels: int, pc_range=None, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        sa = cfg.SA_CONFIG
        bev_range = None
        if pc_range is not None:
            r = list(pc_range)
            bev_range = (r[0], r[1], r[3], r[4])
        self.fused = bool(sa.get('FUSED', False)) and bev_range is not None
        self.npoints = list(sa.NPOINTS)
        self.methods = list(sa.get('SAMPLE_METHOD', ['fps'] * len(self.npoints)))
        self.prefix_ok = bool(sa.get('FPS_PREFIX', True))
        channels = [input_channels - 3]              # width of each level's features
        for k in range(len(self.npoints)):
            mlps = [list(m) for m in sa.MLPS[k]]
            common = dict(use_xyz=sa.get('USE_XYZ', True), device=device)
            if self.fused:
                level = SAModuleMSGFused(channels[k], self.npoints[k], sa.RADIUS[k],
                                         sa.NSAMPLE[k], mlps, pc_range=bev_range,
                                         bucket_cap=int(sa.get('BUCKET_CAP', 32)), **common)
            else:
                level = SAModuleMSG(channels[k], self.npoints[k], sa.RADIUS[k], sa.NSAMPLE[k],
                                    mlps, **common)
            self.add_module(f'sa_{k}', level)
            channels.append(sum(m[-1] for m in mlps))
        fp_mlps = [list(m) for m in cfg.get('FP_MLPS', [])]
        self.n_fp = len(fp_mlps)
        if self.n_fp > len(self.npoints):
            raise ValueError(f'{self.n_fp} FP_MLPS for {len(self.npoints)} SA levels')
        # walk the levels as `forward` does: fp_j writes level j - n_fp from the end
        for i in range(-1, -(self.n_fp + 1), -1):
            self.add_module(f'fp_{self.n_fp + i}',
                            FPModule(channels[i] + channels[i - 1], fp_mlps[i], device=device))
            channels[i - 1] = fp_mlps[i][-1]
        self.num_point_features = channels[0] if self.n_fp > 0 else channels[-1]
        if self.num_point_features < 1:
            raise ValueError('the backbone returns a level without features '
                             '(FP_MLPS shorter than the SA ladder on input without features)')

    def forward(self, batch: dict, generator: torch.Generator | None = None) -> dict:
        """`generator` draws the permutation of the 'random' levels; without
        it 'random' is the plain prefix."""
        points = batch['points']
        xyz = points[..., 0:3]
        features = points[..., 3:] if points.shape[-1] > 3 else None
        fps_ordered = False
        l_xyz, l_features = [xyz], [features]
        for k in range(len(self.npoints)):
            method = self.methods[k]
            # a prefix is a valid subsample only when npoint fits the level's
            # input; real FPS beyond it would repeat picks
            npoint_fits = self.npoints[k] <= l_xyz[k].shape[1]
            if method == 'fps' and fps_ordered and self.prefix_ok and npoint_fits:
                method = 'prefix'
            if method == 'random' and fps_ordered and generator is None:
                warnings.warn(
                    f"SA level {k}: SAMPLE_METHOD 'random' on an FPS-ordered input "
                    "degenerates to a deterministic FPS prefix; pass a generator to forward "
                    "for true uniform sampling (using 'prefix' semantics).", stacklevel=2)
                method = 'prefix'
            if method == 'random' and not npoint_fits:
                raise ValueError(
                    f"SA level {k}: SAMPLE_METHOD 'random' with NPOINTS={self.npoints[k]} > "
                    f"input size {l_xyz[k].shape[1]}; use 'fps' (duplicating picks) or shrink "
                    'NPOINTS.')
            li_xyz, li_feat = getattr(self, f'sa_{k}')(l_xyz[k], l_features[k], method, generator)
            # 'fps' outputs pick order; a prefix of a farthest-first order is one
            fps_ordered = method == 'fps' or (fps_ordered and method in ('prefix', 'random'))
            l_xyz.append(li_xyz)
            l_features.append(li_feat)
        for i in range(-1, -(self.n_fp + 1), -1):
            l_features[i - 1] = getattr(self, f'fp_{self.n_fp + i}')(
                l_xyz[i - 1], l_xyz[i], l_features[i - 1], l_features[i])
        level = 0 if self.n_fp > 0 else -1
        batch['point_features'] = l_features[level]
        batch['point_coords'] = l_xyz[level]
        batch['sa_xyz'] = l_xyz
        batch['sa_features'] = l_features
        return batch
