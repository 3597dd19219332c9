"""KITTI calibration: precomposed homogeneous transforms (copy of
`pdm_ssd_tpu/datasets/kitti/calibration.py`). The calib file is parsed by
key, the rectified-camera<->lidar mapping is precomposed once into a pair of
4x4 matrices, and every transform is one `_apply` of those matrices.
"""
from __future__ import annotations

import numpy as np


def _homogenize(mat: np.ndarray) -> np.ndarray:
    """Embed a (3,3) rotation or (3,4) rigid transform into a 4x4."""
    out = np.eye(4, dtype=np.float32)
    out[:3, :mat.shape[1]] = mat
    return out


def _apply(T: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """(4,4) @ (N,3) -> (N,3), without materializing homogeneous columns."""
    return pts @ T[:3, :3].T + T[:3, 3]


def read_calib_file(path) -> dict:
    """Key->matrix dict from a KITTI calib txt ('KEY: v v v ...' lines)."""
    out = {}
    with open(path) as f:
        for line in f:
            if ':' not in line:
                continue
            key, vals = line.split(':', 1)
            try:
                out[key.strip()] = np.array(vals.split(), dtype=np.float32)
            except ValueError:
                continue
    return out


class Calibration:
    """Accepts a calib-file path or a dict with P2 (3,4), R0 (3,3) and
    Tr_velo2cam (3,4) entries."""

    def __init__(self, src):
        if isinstance(src, (str,)) or hasattr(src, 'read_text'):
            raw = read_calib_file(src)
            mats = {'P2': raw['P2'].reshape(3, 4),
                    'R0': raw['R0_rect'].reshape(3, 3),
                    'Tr_velo2cam': raw['Tr_velo_to_cam'].reshape(3, 4)}
        else:
            mats = src
        self.P2 = np.asarray(mats['P2'], np.float32)
        self.R0 = np.asarray(mats['R0'], np.float32)
        self.V2C = np.asarray(mats['Tr_velo2cam'], np.float32)

        # rect <- velo composed once; both directions cached
        self._rect_from_velo = _homogenize(self.R0) @ _homogenize(self.V2C)
        self._velo_from_rect = np.linalg.inv(self._rect_from_velo)

    # intrinsics (P2 = K [I | t])
    @property
    def fu(self):
        return self.P2[0, 0]

    @property
    def fv(self):
        return self.P2[1, 1]

    @property
    def cu(self):
        return self.P2[0, 2]

    @property
    def cv(self):
        return self.P2[1, 2]

    @property
    def tx(self):
        return -self.P2[0, 3] / self.P2[0, 0]

    @property
    def ty(self):
        return -self.P2[1, 3] / self.P2[1, 1]

    # ---- frame transforms ----

    def lidar_to_rect(self, pts_lidar: np.ndarray) -> np.ndarray:
        return _apply(self._rect_from_velo, np.asarray(pts_lidar, np.float32))

    def rect_to_lidar(self, pts_rect: np.ndarray) -> np.ndarray:
        return _apply(self._velo_from_rect, np.asarray(pts_rect, np.float32))

    # ---- projections ----

    def rect_to_img(self, pts_rect: np.ndarray):
        """(N,3) rect -> ((N,2) pixels, (N,) depth in the P2 camera)."""
        uvw = pts_rect @ self.P2[:, :3].T + self.P2[:, 3]
        pix = uvw[:, :2] / uvw[:, 2:3]
        depth = uvw[:, 2] - self.P2[2, 3]
        return pix, depth

    def lidar_to_img(self, pts_lidar: np.ndarray):
        return self.rect_to_img(self.lidar_to_rect(pts_lidar))

    def img_to_rect(self, u, v, depth_rect):
        """Pixel + rect depth -> (N,3) rect points (inverse pinhole with the
        P2 baseline offsets)."""
        x = (np.asarray(u) - self.cu) / self.fu * depth_rect + self.tx
        y = (np.asarray(v) - self.cv) / self.fv * depth_rect + self.ty
        return np.stack([x, y, np.asarray(depth_rect)], axis=-1).reshape(-1, 3)

    def corners3d_to_img_boxes(self, corners3d: np.ndarray):
        """(N,8,3) rect corners -> ((N,4) image aabbs, (N,8,2) pixel corners)."""
        uvw = np.einsum('nkj,ij->nki', corners3d, self.P2[:, :3]) + self.P2[:, 3]
        pix = uvw[..., :2] / uvw[..., 2:3]                    # (N, 8, 2)
        boxes = np.concatenate([pix.min(axis=1), pix.max(axis=1)], axis=1)
        return boxes.astype(np.float32), pix
