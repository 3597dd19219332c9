"""Depth-aware Lift-Splat view transform, camera -> BEV (counterpart of
`pdm_ssd_tpu/models/view_transforms/depth_lss.py`).

`dtransform` (three conv + BatchNorm + ReLU layers, `dt0` to `dt2`, down 8
in all) encodes the sparse LiDAR depth map of each camera; `depthnet` (`dn0`,
`dn1`, then the 1x1 `dn_out` with bias) reads it beside the image features
and gives D depth logits and C context channels a feature cell. Each cell
lifts its context into D depth hypotheses weighted by the softmax of its
logits. A fixed image-plane frustum (u, v at the feature cells' pixel
positions, the DBOUND depths) goes through the inverse of the image
augmentation ('img_aug_matrix'), is scaled by depth, and goes through
`camera2lidar @ inv(intrinsics)` into the LiDAR frame; `floor` gives each
point's BEV cell, and `ops.bev_pool` sums the lifted features there. With
DOWNSAMPLE above 1 three convs (`ds0`, `ds1` at that stride, `ds2`) follow.
Every conv pads k // 2 on each side, as the JAX package's explicit padding
does; BatchNorm at epsilon 1e-5.

Batch inputs: 'camera_feats' (B, N, fH, fW, C_in), 'camera_depth' (B, N,
iH, iW, 1), 'camera2lidar' (B, N, 4, 4), 'camera_intrinsics' (B, N, 3 or
4, 3 or 4), optional 'img_aug_matrix' (B, N, 4, 4). Output:
'spatial_features' (B, Y, X, Z * OUT_CHANNEL), NHWC.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops.bev_pool import bev_pool
from ...utils.config import as_cfg
from ..layers import BatchNorm2d, DeviceCache


def grid_of(cfg) -> tuple:
    """(dx, bx, nx) of the BEV grid: cell sizes, first cell centres (float64)
    and cell counts (X, Y, Z)."""
    dx = np.array([cfg.XBOUND[2], cfg.YBOUND[2], cfg.ZBOUND[2]])
    bx = np.array([cfg.XBOUND[0], cfg.YBOUND[0], cfg.ZBOUND[0]]) + dx / 2
    nx = np.round(np.array([(cfg.XBOUND[1] - cfg.XBOUND[0]) / dx[0],
                            (cfg.YBOUND[1] - cfg.YBOUND[0]) / dx[1],
                            (cfg.ZBOUND[1] - cfg.ZBOUND[0]) / dx[2]])).astype(int)
    return dx, bx, nx


def frustum(cfg) -> np.ndarray:
    """(D, fH, fW, 3) float32 image-plane points (u, v, depth)."""
    iH, iW = cfg.IMAGE_SIZE
    fH, fW = cfg.FEATURE_SIZE
    ds = np.arange(*cfg.DBOUND, dtype=np.float32)
    f = np.zeros((len(ds), fH, fW, 3), np.float32)
    f[..., 0] = np.linspace(0, iW - 1, fW, dtype=np.float32)[None, None, :]
    f[..., 1] = np.linspace(0, iH - 1, fH, dtype=np.float32)[None, :, None]
    f[..., 2] = ds[:, None, None]
    return f


class DepthLSSTransform(nn.Module):
    """Config: IN_CHANNEL, OUT_CHANNEL, IMAGE_SIZE [H, W], FEATURE_SIZE [fH,
    fW], XBOUND / YBOUND / ZBOUND / DBOUND [min, max, step], DOWNSAMPLE."""

    def __init__(self, model_cfg, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        self.cfg = cfg
        self.dx, self.bx, self.nx = grid_of(cfg)
        self._frustum = frustum(cfg)
        D = self._frustum.shape[0]
        c_in, C = int(cfg.IN_CHANNEL), int(cfg.OUT_CHANNEL)
        self.depth_bins, self.context = D, C
        layers = [('dt0', 1, 8, 1, 1), ('dt1', 8, 32, 5, 4), ('dt2', 32, 64, 5, 2),
                  ('dn0', 64 + c_in, c_in, 3, 1), ('dn1', c_in, c_in, 3, 1)]
        self.downsample = int(cfg.get('DOWNSAMPLE', 1))
        wide = self.num_bev_features
        if self.downsample > 1:
            layers += [('ds0', wide, wide, 3, 1), ('ds1', wide, wide, 3, self.downsample),
                       ('ds2', wide, wide, 3, 1)]
        for prefix, ci, co, k, s in layers:
            # `<prefix>_conv` (k x k, padding k // 2, no bias) and `<prefix>_bn`
            self.add_module(f'{prefix}_conv', nn.Conv2d(ci, co, k, stride=s, padding=k // 2,
                                                        bias=False, device=device))
            self.add_module(f'{prefix}_bn', BatchNorm2d(co, eps=1e-5, momentum=0.1,
                                                        device=device))
        self.dn_out = nn.Conv2d(c_in, D + C, 1, device=device)
        self._cache = DeviceCache()

    @property
    def num_bev_features(self) -> int:
        nz = int(round((self.cfg.ZBOUND[1] - self.cfg.ZBOUND[0]) / self.cfg.ZBOUND[2]))
        return int(self.cfg.OUT_CHANNEL) * max(nz, 1)

    def _block(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(getattr(self, f'{prefix}_bn')(getattr(self, f'{prefix}_conv')(x)))

    def _constants(self, device) -> tuple:
        """The frustum and the grid's lower edge and cell size, float32 on
        `device` (made once a device)."""
        return (self._cache.get('frustum', device, lambda: self._frustum),
                self._cache.get('lo', device, lambda: (self.bx - self.dx / 2.0).astype(np.float32)),
                self._cache.get('dx', device, lambda: self.dx.astype(np.float32)))

    def lift(self, feats: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """(B, N, D, fH, fW, C): each feature cell's context weighted by its
        depth distribution."""
        B, N, fH, fW, c_in = feats.shape
        d = depth.reshape(B * N, *depth.shape[2:]).permute(0, 3, 1, 2)
        for prefix in ('dt0', 'dt1', 'dt2'):
            d = self._block(prefix, d)
        x = torch.cat([d, feats.reshape(B * N, fH, fW, c_in).permute(0, 3, 1, 2)], dim=1)
        x = self.dn_out(self._block('dn1', self._block('dn0', x)))
        D, C = self.depth_bins, self.context
        dist = torch.softmax(x[:, :D], dim=1)                     # (BN, D, fH, fW)
        ctx = x[:, D:D + C]                                       # (BN, C, fH, fW)
        lifted = dist[:, :, None] * ctx[:, None]                  # (BN, D, C, fH, fW)
        return lifted.reshape(B, N, D, C, fH, fW).permute(0, 1, 2, 4, 5, 3)

    def geometry(self, batch: dict, B: int, N: int) -> torch.Tensor:
        """(B, N, D, fH, fW, 3) integer BEV cells (ix, iy, iz) of the frustum's
        points."""
        c2l = batch['camera2lidar']
        intr = batch['camera_intrinsics'][..., :3, :3]
        pts, lo, dx = self._constants(c2l.device)
        pts = pts.expand(B, N, *pts.shape)
        if 'img_aug_matrix' in batch:
            aug = batch['img_aug_matrix']
            inv = torch.linalg.inv(aug[..., :3, :3])
            pts = pts - aug[..., None, None, None, :3, 3]
            pts = torch.einsum('bnij,bndhwj->bndhwi', inv, pts)
        pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], dim=-1)
        combine = torch.einsum('bnij,bnjk->bnik', c2l[..., :3, :3], torch.linalg.inv(intr))
        pts = (torch.einsum('bnij,bndhwj->bndhwi', combine, pts)
               + c2l[..., None, None, None, :3, 3])
        return torch.floor((pts - lo) / dx).to(torch.int32)

    def forward(self, batch: dict) -> dict:
        feats = batch['camera_feats']
        B, N = feats.shape[:2]
        lifted = self.lift(feats, batch['camera_depth'])
        coords = self.geometry(batch, B, N)
        out = bev_pool(lifted.reshape(B, -1, self.context), coords.reshape(B, -1, 3), None,
                       tuple(int(v) for v in self.nx))
        if self.downsample > 1:
            x = out.permute(0, 3, 1, 2)
            for prefix in ('ds0', 'ds1', 'ds2'):
                x = self._block(prefix, x)
            out = x.permute(0, 2, 3, 1)
        batch['spatial_features'] = out
        batch['spatial_features_stride'] = self.downsample
        return batch
