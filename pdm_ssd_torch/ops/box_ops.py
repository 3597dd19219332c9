"""3D box geometry on tensors (counterpart of `pdm_ssd_tpu/ops/box_ops.py`).

Boxes are (x, y, z, dx, dy, dz, heading[, ...]) with (x, y, z) the box
center and the heading a rotation around +z. Tensors in, tensors out; the
host-side numpy helpers of the JAX package wait for the dataset path.
"""
from __future__ import annotations

import math

import torch


def rotate_points_along_z(points: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """points (B, N, 3 + C), angle (B,) radians."""
    cosa, sina = torch.cos(angle), torch.sin(angle)
    zeros, ones = torch.zeros_like(cosa), torch.ones_like(cosa)
    rot = torch.stack([cosa, sina, zeros, -sina, cosa, zeros, zeros, zeros, ones],
                      dim=-1).reshape(-1, 3, 3)
    xyz = torch.matmul(points[..., :3], rot)
    return torch.cat([xyz, points[..., 3:]], dim=-1)


def limit_period(val: torch.Tensor, offset: float = 0.5, period: float = math.pi):
    """Wrap an angle into [-offset * period, (1 - offset) * period)."""
    return val - torch.floor(val / period + offset) * period


def boxes_to_corners_3d(boxes3d: torch.Tensor) -> torch.Tensor:
    """(N, 7) -> (N, 8, 3) corners: the bottom face counter-clockwise from
    (+x, +y), then the top face in the same order."""
    template = torch.tensor([[1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
                             [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]],
                            dtype=boxes3d.dtype, device=boxes3d.device) / 2.0
    corners = boxes3d[:, None, 3:6] * template[None, :, :]
    corners = rotate_points_along_z(corners, boxes3d[:, 6])
    return corners + boxes3d[:, None, 0:3]


def enlarge_box3d(boxes3d: torch.Tensor, extra_width=(0., 0., 0.)) -> torch.Tensor:
    """Grow dx, dy, dz by `extra_width`, added once (each side grows by half
    of it); center and heading stay."""
    extra = torch.tensor(extra_width, dtype=boxes3d.dtype, device=boxes3d.device)
    out = boxes3d.clone()
    out[..., 3:6] += extra
    return out


def points_in_boxes(points: torch.Tensor, boxes: torch.Tensor,
                    box_mask: torch.Tensor | None = None) -> torch.Tensor:
    """points (B, N, 3), boxes (B, M, 7), box_mask (B, M) bool or None ->
    (B, N) int32 index of the first (lowest-index) box that contains the
    point, -1 if none. The z test is `<=`, the x and y tests `<` with a
    margin of 1e-5."""
    margin = 1e-5
    shift = points[:, :, None, :] - boxes[:, None, :, :3]        # (B, N, M, 3)
    cosa = torch.cos(-boxes[..., 6])[:, None, :]
    sina = torch.sin(-boxes[..., 6])[:, None, :]
    local_x = shift[..., 0] * cosa - shift[..., 1] * sina
    local_y = shift[..., 0] * sina + shift[..., 1] * cosa
    in_box = ((shift[..., 2].abs() <= boxes[:, None, :, 5] / 2.0)
              & (local_x.abs() < boxes[:, None, :, 3] / 2.0 + margin)
              & (local_y.abs() < boxes[:, None, :, 4] / 2.0 + margin))
    if box_mask is not None:
        in_box = in_box & box_mask[:, None, :]
    M = boxes.shape[1]
    order = torch.arange(M, dtype=torch.int32, device=boxes.device)
    first = torch.where(in_box, order, M).amin(dim=-1)
    return torch.where(first < M, first, -1).to(torch.int32)
