"""bev_pool: sum camera-frustum features into a BEV grid (Lift-Splat);
counterpart of `pdm_ssd_tpu/ops/bev_pool.py`, an XLA scatter there.

One `index_add_` with the z axis folded into channels: point p of cloud b
adds its C features to row (b * (Y * X + 1) + y * X + x) * Z + z of a
(B * (Y * X + 1) * Z, C) table, which read as (B, Y * X + 1, Z * C) puts
cell (y, x)'s level z at channels z * C .. z * C + C. Points outside the
grid or not valid go to each cloud's last cell, which is dropped.

On CUDA `index_add_` adds with atomics, so the order of a cell's sums, and
with it its last bits, changes from run to run.
"""
from __future__ import annotations

import torch


def bev_pool(feats: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor | None,
             nx: tuple) -> torch.Tensor:
    """feats (B, P, C) frustum features; coords (B, P, 3) integer (ix, iy,
    iz) cells; valid (B, P) bool or None (all valid); nx the grid's (X, Y,
    Z). Returns (B, Y, X, Z * C)."""
    B, P, C = feats.shape
    X, Y, Z = (int(n) for n in nx)
    ix, iy, iz = coords[..., 0].long(), coords[..., 1].long(), coords[..., 2].long()
    ok = (ix >= 0) & (ix < X) & (iy >= 0) & (iy < Y) & (iz >= 0) & (iz < Z)
    if valid is not None:
        ok = ok & valid
    n_xy = Y * X
    cell = torch.where(ok, iy * X + ix, n_xy)
    cloud = torch.arange(B, device=feats.device)[:, None] * (n_xy + 1)
    rows = (cloud + cell) * Z + torch.where(ok, iz, 0)
    table = feats.new_zeros((B * (n_xy + 1) * Z, C))
    table.index_add_(0, rows.reshape(-1), feats.reshape(-1, C))
    return table.view(B, n_xy + 1, Z * C)[:, :n_xy].reshape(B, Y, X, Z * C)
