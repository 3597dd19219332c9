"""KITTI label files as vectorized numpy tables (copy of
`pdm_ssd_tpu/datasets/kitti/object3d.py`): one parse produces arrays over all
objects in the frame; difficulty and corners are vectorized expressions. The
KITTI label column layout and the official difficulty rubric (bbox height /
occlusion / truncation bands) are protocol constants.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# official KITTI difficulty bands: (min bbox height px, max occlusion,
# max truncation) for Easy / Moderate / Hard
_DIFFICULTY_BANDS = ((40.0, 0, 0.15), (25.0, 1, 0.30), (25.0, 2, 0.50))

CLASS_IDS = {'Car': 1, 'Pedestrian': 2, 'Cyclist': 3, 'Van': 4}


@dataclass
class LabelTable:
    """Columnar view of one frame's label file. All arrays share length N.

    `dims` is ordered (l, h, w) as printed in the label line; `loc` is the
    camera-frame bottom-center; `ry` the camera yaw.
    """
    name: np.ndarray        # (N,) <U str
    truncated: np.ndarray   # (N,) f32
    occluded: np.ndarray    # (N,) f32
    alpha: np.ndarray       # (N,) f32
    bbox: np.ndarray        # (N, 4) f32 image box
    dims: np.ndarray        # (N, 3) f32 (l, h, w)
    loc: np.ndarray         # (N, 3) f32 camera frame
    ry: np.ndarray          # (N,) f32
    score: np.ndarray       # (N,) f32 (-1 for GT files)

    def __len__(self):
        return len(self.name)

    @classmethod
    def from_file(cls, path) -> 'LabelTable':
        with open(path) as f:
            rows = [ln.split() for ln in f if ln.strip()]
        return cls.from_rows(rows)

    @classmethod
    def from_rows(cls, rows) -> 'LabelTable':
        names = np.array([r[0] for r in rows]) if rows else np.zeros((0,), '<U10')
        num = np.array(
            [[float(v) for v in r[1:15]] + [float(r[15]) if len(r) > 15 else -1.0]
             for r in rows], np.float32).reshape(len(rows), 15)
        return cls(
            name=names,
            truncated=num[:, 0], occluded=num[:, 1], alpha=num[:, 2],
            bbox=num[:, 3:7],
            # label order is h, w, l -> store (l, h, w)
            dims=num[:, [9, 7, 8]],
            loc=num[:, 10:13], ry=num[:, 13], score=num[:, 14],
        )

    @property
    def cls_id(self) -> np.ndarray:
        return np.array([CLASS_IDS.get(n, -1) for n in self.name], np.int32)

    def difficulty(self) -> np.ndarray:
        """(N,) int32 in {0 easy, 1 moderate, 2 hard, -1 unknown}, vectorized
        over the official bands."""
        height = self.bbox[:, 3] - self.bbox[:, 1] + 1.0
        conds = [(height >= h) & (self.occluded <= o) & (self.truncated <= t)
                 for h, o, t in _DIFFICULTY_BANDS]
        return np.select(conds, [0, 1, 2], default=-1).astype(np.int32)

    def camera_corners(self) -> np.ndarray:
        """(N, 8, 3) camera-frame box corners (y-down, loc at bottom face),
        one einsum over all boxes."""
        l, h, w = self.dims[:, 0], self.dims[:, 1], self.dims[:, 2]
        sx = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float32)
        sy = np.array([0, 0, 0, 0, -1, -1, -1, -1], np.float32)
        sz = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float32)
        local = np.stack([
            sx[None] * (l[:, None] / 2),
            sy[None] * h[:, None],
            sz[None] * (w[:, None] / 2),
        ], axis=-1)                                            # (N, 8, 3)
        c, s = np.cos(self.ry), np.sin(self.ry)
        zero, one = np.zeros_like(c), np.ones_like(c)
        rot = np.stack([c, zero, s, zero, one, zero, -s, zero, c],
                       axis=-1).reshape(-1, 3, 3)
        return np.einsum('nij,nkj->nki', rot, local) + self.loc[:, None, :]


def get_objects_from_label(label_file) -> LabelTable:
    """Parse a label file. Returns the columnar table (the per-object
    `Object3d` list of the reference is replaced by column indexing)."""
    return LabelTable.from_file(label_file)
