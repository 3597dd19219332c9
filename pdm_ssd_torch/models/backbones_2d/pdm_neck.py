"""PDM neck: point dilation into a BEV grid (counterpart of
`pdm_ssd_tpu/models/backbones_2d/pdm_neck.py`).

Each center of the source SA level dilates into a Gx x Gy x Gz window of
grid cells. A cell's features are the degree-2 solid-harmonic basis of its
offset, contracted against per-center coefficients and weighted by a
Gaussian, plus the Gaussian itself as a density channel. The contributions
of all centers are summed with `index_add_` into a (B*H*W*Dz + 1, C+1) grid
whose last row takes the cells outside the grid; z is folded into the
channels, giving `spatial_features` (B, H, W, Dz*(C+1)).

On CUDA `index_add_` adds with atomics, so the order of the sum, and with it
the last bits of the grid, changes from run to run.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...utils.config import as_cfg


def solid_harmonics_deg2(o: torch.Tensor) -> torch.Tensor:
    """Real solid harmonics r^l*Y_lm for l<=2 of offsets (..., 3) -> (..., 9):
    [1, x, y, z, xy, yz, 3z^2-r^2, xz, x^2-y^2]."""
    x, y, z = o[..., 0], o[..., 1], o[..., 2]
    r2 = x * x + y * y + z * z
    return torch.stack([torch.ones_like(x), x, y, z,
                        x * y, y * z, 3 * z * z - r2, x * z, x * x - y * y], dim=-1)


class PDMNeck(nn.Module):
    N_SH = 9

    def __init__(self, model_cfg, in_channels: int, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        self.cfg = cfg
        self.sh_proj = nn.Linear(in_channels, self.N_SH * cfg.NUM_BEV_FEATURES, bias=False,
                                 device=device)
        gx, gy, gz = cfg.GRID_KERNEL
        # window offsets in cells, (G3, 3), x outer and z inner
        self.offs = np.stack(np.meshgrid(np.arange(gx) - gx // 2, np.arange(gy) - gy // 2,
                                         np.arange(gz) - gz // 2, indexing='ij'),
                             axis=-1).reshape(-1, 3)

    @property
    def num_bev_features(self) -> int:
        return (self.cfg.NUM_BEV_FEATURES + 1) * self.cfg.NUM_Z_BINS

    def forward(self, batch: dict) -> dict:
        cfg = self.cfg
        lvl = cfg.get('SOURCE_LEVEL', -1)
        centers = batch['sa_xyz'][lvl]              # (B, M, 3)
        feats = batch['sa_features'][lvl]           # (B, M, C)
        B, M, _ = feats.shape
        W, H = cfg.BEV_SIZE
        Dz = cfg.NUM_Z_BINS
        Cout = cfg.NUM_BEV_FEATURES
        sigma = cfg.get('GAUSSIAN_SIGMA', 1.0)
        dev = feats.device
        pc_min = torch.tensor(cfg.POINT_CLOUD_RANGE[:3], dtype=torch.float32, device=dev)
        cell = torch.tensor(cfg.VOXEL_SIZE, dtype=torch.float32, device=dev)

        coeffs = self.sh_proj(feats).reshape(B, M, self.N_SH, Cout)
        rel = (centers - pc_min) / cell                            # (B, M, 3)
        offs = torch.as_tensor(self.offs, dtype=torch.long, device=dev)
        cell_idx = torch.floor(rel).long()[:, :, None, :] + offs       # (B, M, G3, 3)
        o = (cell_idx.float() + 0.5) - rel[:, :, None, :]
        basis = solid_harmonics_deg2(o / max(float(sigma), 1e-6))  # (B, M, G3, 9)
        gauss = torch.exp(-0.5 * (o * o).sum(dim=-1) / (sigma ** 2))
        cell_feats = torch.einsum('bmgs,bmsc->bmgc', basis, coeffs) * gauss[..., None]
        payload = torch.cat([cell_feats, gauss[..., None]], dim=-1)   # (B, M, G3, Cout+1)

        ix, iy, iz = cell_idx.unbind(dim=-1)
        ok = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H) & (iz >= 0) & (iz < Dz)
        if batch.get('sa_mask') is not None:
            ok = ok & batch['sa_mask'][lvl][:, :, None]
        bidx = torch.arange(B, device=dev)[:, None, None]
        row = ((bidx * H + iy) * W + ix) * Dz + iz
        dump = B * H * W * Dz
        row = torch.where(ok, row, dump)
        Cp = Cout + 1
        grid = torch.zeros((dump + 1, Cp), dtype=payload.dtype, device=dev)
        grid.index_add_(0, row.reshape(-1), payload.reshape(-1, Cp))
        batch['spatial_features'] = grid[:dump].view(B, H, W, Dz * Cp)
        batch['spatial_features_stride'] = 1
        return batch
