"""ROI-aware grid pooling of Part-A2 (counterpart of
`pdm_ssd_tpu/ops/roiaware.py`).

Up to P points inside each ROI are selected (`pool_roi_points`, shared with
the other ROI heads), each lands in its cell of a G^3 grid over the ROI's
box in the box's frame, and the cells pool their points' features: the
average (a sum by a one-hot matrix product and a count), or the maximum (a
scatter-reduce `amax` into (B * R * G^3, C) rows). Empty cells are 0. The
JAX package takes the maximum over a (B, R, P, G^3, C) masked tensor, about
3.6 GB at G = 12, P = 128, 128 ROIs, C = 16 and B = 2; the scatter-reduce
gives the same values, and its gradient, like `jnp.max`'s, is shared
equally among a cell's equal maxima. The JAX package rounds the averaged
features to bf16 before its one-hot product; the port keeps them in float32
(a known deviation, bounded in `tests/test_torch_port_parta2.py`).
"""
from __future__ import annotations

import torch

from . import box_ops


def roi_cells(points: torch.Tensor, rois: torch.Tensor, grid_size: int, num_sampled: int,
              roi_mask: torch.Tensor | None = None) -> tuple:
    """The selected points of each ROI and their cells: idx (B, R, P) int32
    into the points, valid (B, R, P), and cid (B, R, P) in [0, G^3), the
    cell (x, y, z) of the box frame as (x * G + y) * G + z."""
    from ..models.roi_heads.pointrcnn_head import pool_roi_points
    B, R = rois.shape[:2]
    G, P = int(grid_size), int(num_sampled)
    idx, valid = pool_roi_points(points, rois, P, extra=0.0, roi_mask=roi_mask)
    pxyz = torch.gather(points, 1, idx.reshape(B, R * P, 1).long().expand(-1, -1, 3))
    local = pxyz.reshape(B, R, P, 3) - rois[:, :, None, :3]
    local = box_ops.rotate_points_along_z(local.reshape(B * R, P, 3),
                                          -rois[..., 6].reshape(B * R)).reshape(B, R, P, 3)
    rel = local / rois[:, :, None, 3:6].clamp(min=1e-4) + 0.5
    cell = (rel * G).to(torch.int32).clamp(0, G - 1)        # truncation, as astype(int32)
    cid = (cell[..., 0] * G + cell[..., 1]) * G + cell[..., 2]
    return idx, valid, cid


def roiaware_pool(points: torch.Tensor, feats: torch.Tensor, rois: torch.Tensor,
                  grid_size: int, pool: str = 'max', num_sampled: int = 128,
                  roi_mask: torch.Tensor | None = None) -> torch.Tensor:
    """points (B, N, 3), feats (B, N, C), rois (B, R, 7) -> (B, R, G, G, G, C)
    pooled by 'avg' or 'max', empty cells 0."""
    B, R = rois.shape[:2]
    G, P = int(grid_size), int(num_sampled)
    G3, C = G ** 3, feats.shape[-1]
    idx, valid, cid = roi_cells(points, rois, G, P, roi_mask)
    pfeat = torch.gather(feats, 1, idx.reshape(B, R * P, 1).long().expand(-1, -1, C))
    pfeat = pfeat.reshape(B * R, P, C)
    if pool == 'avg':
        onehot = ((cid.reshape(B * R, P, 1) == torch.arange(G3, device=cid.device))
                  & valid.reshape(B * R, P, 1)).to(feats.dtype)               # (BR, P, G3)
        sums = torch.bmm(onehot.transpose(1, 2), pfeat)                      # (BR, G3, C)
        cnt = onehot.sum(dim=1)[..., None]
        out = torch.where(cnt > 0, sums / cnt.clamp(min=1.0), 0.0)
    elif pool == 'max':
        rows = (torch.arange(B * R, device=cid.device)[:, None] * G3 + cid.reshape(B * R, P))
        rows = torch.where(valid.reshape(B * R, P), rows, B * R * G3)       # a spare row
        out = feats.new_zeros((B * R * G3 + 1, C))
        out = out.scatter_reduce(0, rows.reshape(-1, 1).expand(-1, C), pfeat.reshape(-1, C),
                                 reduce='amax', include_self=False)
        out = out[:-1]
    else:
        raise ValueError(f'unknown pool {pool!r}')
    return out.reshape(B, R, G, G, G, C)
