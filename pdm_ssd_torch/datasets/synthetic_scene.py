"""Seeded LiDAR scenes for the generated mini sets of ONCE, Argoverse 2,
Lyft, Pandaset and the custom layout (`<set>/synthetic.py`).

A scene is a cloud in the sensor's frame (x forward, y left, z up, the
sensor 1.7 m above a flat ground) around labelled objects: a ground plane
and clutter from -50 to 70.4 m in x and +-45 m in y, and the points of each
object's box. Half the objects at least lie inside the KITTI range of the
flagship (`pdm_ssd_point.yaml`: 0 to 70.4 m ahead, +-40 m across), so that
its loops see ground truth; the rest lie anywhere around the sensor, as a
360-degree set's do.
"""
from __future__ import annotations

import numpy as np

from .kitti.kitti_utils import points_in_boxes_cpu

GROUND_Z = -1.7
# (dx, dy, dz) of each kind of object, in metres
KIND_SIZES = {'vehicle': (4.3, 1.85, 1.6), 'bus': (11.0, 2.9, 3.2),
              'truck': (7.5, 2.6, 3.0), 'pedestrian': (0.8, 0.65, 1.75),
              'cyclist': (1.8, 0.65, 1.7)}


def scene(rng: np.random.RandomState, kinds: tuple, probs: tuple, n_bg: int = 6000,
          n_objects: tuple = (6, 11)) -> tuple:
    """One cloud and its objects, drawn from `rng`: (points (N, 4) float32
    [x, y, z, intensity in [0, 1)], boxes (M, 7) float32 [x, y, z, dx, dy,
    dz, heading] with z at the box centre, kind index (M,) into `kinds`,
    points in each box (M,))."""
    M = rng.randint(*n_objects)
    boxes, kind_idx = [], []
    for i in range(M):
        k = rng.choice(len(kinds), p=probs)
        size = np.asarray(KIND_SIZES[kinds[k]]) * rng.uniform(0.9, 1.1, 3)
        for _ in range(100):
            if i % 2 == 0:      # inside the flagship's range
                xy = rng.uniform([4.0, -30.0], [60.0, 30.0])
            else:               # anywhere around the sensor
                xy = rng.uniform([-45.0, -40.0], [65.0, 40.0])
            if np.hypot(*xy) > 3.0 and all(np.hypot(*(xy - b[:2])) > 1.0 + (b[3] + size[0]) / 2
                                          for b in boxes):
                break
        boxes.append([xy[0], xy[1], GROUND_Z + size[2] / 2, *size, rng.uniform(-np.pi, np.pi)])
        kind_idx.append(k)
    boxes = np.asarray(boxes, np.float32).reshape(-1, 7)

    ground = np.stack([rng.uniform(-50.0, 70.4, n_bg), rng.uniform(-45.0, 45.0, n_bg),
                       GROUND_Z + rng.normal(0.0, 0.03, n_bg)], -1)
    n_clutter = n_bg // 8
    clutter = np.stack([rng.uniform(-50.0, 70.4, n_clutter), rng.uniform(-45.0, 45.0, n_clutter),
                        rng.uniform(GROUND_Z, 1.0, n_clutter)], -1)
    bg = np.concatenate([ground, clutter])
    bg = bg[points_in_boxes_cpu(bg, boxes).sum(0) == 0] if len(boxes) else bg
    objs = []
    for b in boxes:
        # nearer objects return more points
        n = int(np.clip(4000.0 / max(np.hypot(b[0], b[1]), 5.0), 20, 400))
        local = rng.uniform(-0.5, 0.5, (n, 3)) * b[3:6]
        c, s = np.cos(b[6]), np.sin(b[6])
        objs.append(np.stack([local[:, 0] * c - local[:, 1] * s + b[0],
                              local[:, 0] * s + local[:, 1] * c + b[1],
                              local[:, 2] + b[2]], -1))
    xyz = np.concatenate([bg] + objs).astype(np.float32)
    points = np.concatenate([xyz, rng.rand(len(xyz), 1).astype(np.float32)], -1)
    counts = points_in_boxes_cpu(points[:, :3], boxes).sum(1) if len(boxes) else np.zeros(0)
    return points, boxes, np.asarray(kind_idx, np.int64), counts.astype(np.int64)
