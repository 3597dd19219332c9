"""Host-side (numpy) box helpers of the data path: copies of the numpy
functions of `pdm_ssd_tpu/ops/box_ops.py:100-130`, whose module imports JAX.
The corner test computes the corners in numpy, as `boxes_to_corners_3d` of
that module does in JAX."""
from __future__ import annotations

import numpy as np

# corner template in the reference's order (`box_utils.boxes_to_corners_3d`)
_CORNERS = np.array([[1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
                     [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]], np.float32) / 2.0


def mask_points_by_range(points: np.ndarray, limit_range) -> np.ndarray:
    """Point range mask (`common_utils.mask_points_by_range`). Only x/y are
    tested, like the reference."""
    return ((points[:, 0] >= limit_range[0]) & (points[:, 0] <= limit_range[3])
            & (points[:, 1] >= limit_range[1]) & (points[:, 1] <= limit_range[4]))


def boxes_to_corners_3d(boxes3d: np.ndarray) -> np.ndarray:
    """(N, 7+) center boxes -> (N, 8, 3) corners, rotated about z by the
    heading."""
    corners = boxes3d[:, None, 3:6] * _CORNERS[None].astype(boxes3d.dtype)
    c, s = np.cos(boxes3d[:, 6])[:, None], np.sin(boxes3d[:, 6])[:, None]
    x = corners[..., 0] * c - corners[..., 1] * s
    y = corners[..., 0] * s + corners[..., 1] * c
    return np.stack([x, y, corners[..., 2]], axis=-1) + boxes3d[:, None, 0:3]


def mask_boxes_outside_range_numpy(boxes: np.ndarray, limit_range, min_num_corners: int = 1,
                                   use_center_to_filter: bool = True) -> np.ndarray:
    """GT-box range filter (`box_utils.mask_boxes_outside_range_numpy:93`)."""
    if boxes.shape[1] > 7:
        boxes = boxes[:, :7]
    if use_center_to_filter:
        center = boxes[:, 0:3]
        return ((center >= np.asarray(limit_range[0:3])) &
                (center <= np.asarray(limit_range[3:6]))).all(axis=-1)
    corners = boxes_to_corners_3d(boxes)
    inside = ((corners >= np.asarray(limit_range[0:3])) &
              (corners <= np.asarray(limit_range[3:6]))).all(axis=2)
    return inside.sum(axis=1) >= min_num_corners
