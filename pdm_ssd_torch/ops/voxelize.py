"""Point clouds -> the fixed-shape voxel batch that `Detector3D` consumes.

The contract is the JAX package's voxelizer
(`pdm_ssd_tpu/datasets/processor/data_processor.py`, `_numpy_voxelize`):
cells by `floor((xyz - range_min) / voxel_size)` in float32, points outside
the grid dropped, a stable sort by the flat key `(z*H + y)*W + x`, the first
`max_points` points of each cell in cloud order, the first `max_voxels`
cells in key order, coordinates **zyx**. Written on tensors, so it runs on
the device of the cloud; a batch is padded to `(B, V, P, C)`.
"""
from __future__ import annotations

import torch


def grid_size(point_cloud_range, voxel_size) -> tuple:
    """(W, H, D) cells of the range at this voxel size."""
    lo = torch.tensor(point_cloud_range[:3], dtype=torch.float32)
    hi = torch.tensor(point_cloud_range[3:6], dtype=torch.float32)
    vs = torch.tensor(voxel_size, dtype=torch.float32)
    return tuple(int(g) for g in torch.round((hi - lo) / vs).long())


def voxelize(points: torch.Tensor, point_cloud_range, voxel_size, max_points: int,
             max_voxels: int):
    """One cloud. points (N, C) float32 with xyz first. Returns
    voxels (max_voxels, max_points, C), coords (max_voxels, 3) int32 zyx,
    num_points (max_voxels,) int32 and the number of cells filled; slots past
    that number are zero."""
    dev = points.device
    W, H, D = grid_size(point_cloud_range, voxel_size)
    lo = torch.tensor(point_cloud_range[:3], dtype=torch.float32, device=dev)
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    grid = torch.tensor([W, H, D], device=dev)
    cells = torch.floor((points[:, :3] - lo) / vs).long()
    ok = ((cells >= 0) & (cells < grid)).all(dim=1)
    points, cells = points[ok], cells[ok]
    flat = (cells[:, 2] * H + cells[:, 1]) * W + cells[:, 0]
    flat, order = torch.sort(flat, stable=True)
    points = points[order]
    keys, counts = torch.unique_consecutive(flat, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    cell = torch.repeat_interleave(torch.arange(keys.numel(), device=dev), counts)
    rank = torch.arange(flat.numel(), device=dev) - starts[cell]
    keep = (rank < max_points) & (cell < max_voxels)
    C = points.shape[1]
    voxels = torch.zeros((max_voxels, max_points, C), dtype=points.dtype, device=dev)
    voxels[cell[keep], rank[keep]] = points[keep]
    n_vox = min(int(keys.numel()), max_voxels)
    keys = keys[:n_vox]
    coords = torch.zeros((max_voxels, 3), dtype=torch.int32, device=dev)
    coords[:n_vox] = torch.stack([keys // (H * W), (keys // W) % H, keys % W], -1).int()
    num_points = torch.zeros((max_voxels,), dtype=torch.int32, device=dev)
    num_points[:n_vox] = counts[:n_vox].clamp(max=max_points).int()
    return voxels, coords, num_points, n_vox


def voxelize_batch(points: torch.Tensor, point_cloud_range, voxel_size, max_points: int,
                   max_voxels: int) -> dict:
    """points (B, N, C) -> {'voxels' (B, V, P, C), 'voxel_coords' (B, V, 3)
    int32 zyx, 'voxel_num_points' (B, V) int32, 'voxel_mask' (B, V) bool}."""
    per = [voxelize(p, point_cloud_range, voxel_size, max_points, max_voxels) for p in points]
    slots = torch.arange(max_voxels, device=points.device)
    return {'voxels': torch.stack([p[0] for p in per]),
            'voxel_coords': torch.stack([p[1] for p in per]),
            'voxel_num_points': torch.stack([p[2] for p in per]),
            'voxel_mask': torch.stack([slots < p[3] for p in per])}
