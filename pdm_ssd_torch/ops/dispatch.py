"""Device dispatch for the port's kernels (counterpart of
`pdm_ssd_tpu/ops/dispatch.py`).

A CPU tensor runs the plain PyTorch version. A CUDA tensor launches the
Hopper kernel, or raises: no CUDA work falls back to the plain version or to
the CPU. Any other device raises.
"""
from __future__ import annotations

import torch

from . import fps, group
from . import pointnet2 as plain


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    kind = xyz.device.type
    if kind == 'cpu':
        return plain.farthest_point_sample(xyz, npoint)
    if kind == 'cuda':
        return fps.farthest_point_sample_cuda(xyz.contiguous(), npoint)
    raise NotImplementedError(f'no FPS for device {xyz.device}')


def window_select(table: torch.Tensor, center_cells: torch.Tensor, grid_w: int,
                  xyz: torch.Tensor, new_xyz: torch.Tensor, radii, nsamples):
    """In-ball selection for all radii of one SA level: a list over radii of
    (rel_xyz, idx, hit). Indices are int64 from the plain version and int32
    from the kernel."""
    kind = xyz.device.type
    if kind == 'cpu':
        return group.window_select_plain(table, center_cells, grid_w, xyz, new_xyz,
                                         radii, nsamples)
    if kind == 'cuda':
        return group.window_select_cuda(table.to(torch.int32), center_cells.to(torch.int32),
                                        grid_w, xyz.contiguous(), new_xyz.contiguous(),
                                        radii, nsamples)
    raise NotImplementedError(f'no window selection for device {xyz.device}')


def gather_rows(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    kind = features.device.type
    if kind == 'cpu':
        return group.gather_rows_plain(features, idx)
    if kind == 'cuda':
        return group.gather_rows_cuda(features, idx.to(torch.int32).contiguous())
    raise NotImplementedError(f'no row gather for device {features.device}')


def scatter_add_rows(vals: torch.Tensor, idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    kind = vals.device.type
    if kind == 'cpu':
        return group.scatter_add_rows_plain(vals, idx, n_rows)
    if kind == 'cuda':
        return group.scatter_add_rows_cuda(vals.contiguous(), idx.to(torch.int32).contiguous(),
                                           n_rows)
    raise NotImplementedError(f'no row scatter-add for device {vals.device}')
