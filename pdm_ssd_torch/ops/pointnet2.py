"""Plain PyTorch point-set ops (counterpart of `pdm_ssd_tpu/ops/pointnet2.py`).

`farthest_point_sample` is the plain version of the FPS kernel
(`ops/fps.py`): seed index 0, running minimum of the squared distance from
BIG, first index of the maximum. The distance is written as separate
elementwise ops, (dx*dx + dy*dy) + dz*dz, so that it rounds exactly like the
kernel.
"""
from __future__ import annotations

import torch

BIG = 1e10


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz: (B, N, 3) -> (B, npoint) int32 indices; the first is always 0."""
    B, N, _ = xyz.shape
    x = xyz.float()
    xs, ys, zs = x[..., 0], x[..., 1], x[..., 2]
    dists = torch.full((B, N), BIG, dtype=torch.float32, device=xyz.device)
    out = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    for i in range(1, npoint):
        lx = xs[rows, last][:, None]
        ly = ys[rows, last][:, None]
        lz = zs[rows, last][:, None]
        dx = xs - lx
        dy = ys - ly
        dz = zs - lz
        d = dx * dx + dy * dy + dz * dz
        dists = torch.minimum(dists, d)
        last = torch.argmax(dists, dim=1)   # first index of the maximum
        out[:, i] = last.to(torch.int32)
    return out


def gather_operation(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, M) -> (B, M, C)."""
    C = features.shape[-1]
    return torch.gather(features, 1, idx.long()[..., None].expand(-1, -1, C))
