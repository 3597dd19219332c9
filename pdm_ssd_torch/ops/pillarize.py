"""Dynamic pillarization: points -> dense BEV grid (counterpart of
`pdm_ssd_tpu/ops/pillarize.py`).

One scatter-add pass: each point's payload [point features, offset from its
cell's center (2), 1] is summed with `index_add_` into a (B * H * W + 1, C+3)
grid whose last row takes the points out of range or masked out; the sums
become means and the count `log1p(count)`.

On CUDA `index_add_` adds with atomics, so the order of the sums, and with it
the last bits of the means, changes from run to run; the counts are integers
below 2^24 and exact.
"""
from __future__ import annotations

import numpy as np
import torch


def pillarize(points: torch.Tensor, grid_wh, voxel_size, pc_range,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """points (B, N, C) -> (B, H, W, C+3): per cell the mean of the point
    features (C) and of the offsets from the cell's center (2), then
    log1p(count). `mask` (B, N) bool drops the points where it is false."""
    B, N, C = points.shape
    W, H = (int(v) for v in grid_wh)
    dev = points.device
    # the JAX package's jitted `(x - x0) / vx` runs as a product with the
    # float32 reciprocal of vx (XLA's simplifier rewrites a division by a
    # constant so), and the cell of a point on an edge depends on that
    # rounding: multiply by the same reciprocal here
    dt = points.dtype
    x0, y0, vx, vy = (torch.tensor(float(v), dtype=dt, device=dev)
                      for v in (*pc_range[:2], *voxel_size[:2]))
    inv_x, inv_y = (torch.tensor(np.float32(1) / np.float32(v), dtype=dt, device=dev)
                    for v in voxel_size[:2])
    ix = torch.floor((points[..., 0] - x0) * inv_x).to(torch.int32)
    iy = torch.floor((points[..., 1] - y0) * inv_y).to(torch.int32)
    ok = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    if mask is not None:
        ok = ok & mask
    ncells = H * W
    b = torch.arange(B, device=dev, dtype=torch.int64)[:, None]
    row = torch.where(ok, b * ncells + (iy * W + ix).long(), B * ncells)    # (B, N)

    cx = (ix.to(dt) + 0.5) * vx + x0
    cy = (iy.to(dt) + 0.5) * vy + y0
    payload = torch.cat([points, (points[..., 0] - cx)[..., None],
                         (points[..., 1] - cy)[..., None],
                         torch.ones_like(points[..., :1])], dim=-1)         # (B, N, C+3)
    payload = torch.where(ok[..., None], payload, 0.0)
    grid = torch.zeros((B * ncells + 1, C + 3), dtype=dt, device=dev)
    grid.index_add_(0, row.reshape(-1), payload.reshape(-1, C + 3))
    grid = grid[:-1].view(B, H, W, C + 3)
    cnt = grid[..., -1:]
    means = grid[..., :-1] / torch.clamp(cnt, min=1.0)
    return torch.cat([means, torch.log1p(cnt)], dim=-1)
