"""Host-side (numpy) rotated BEV IoU for the GT sampler's collision check
and the KITTI evaluator (copy of `pdm_ssd_tpu/utils/np_iou.py`).

The same Sutherland-Hodgman clipping as the JAX package's numpy path. That
module first tries a native C++ library and falls back on any exception; the
port has the numpy path only, so a host without a compiler computes the same
numbers as one with.
"""
from __future__ import annotations

import numpy as np

_P = 16
_EPS = 1e-8


def _bev_corners(boxes: np.ndarray) -> np.ndarray:
    """(N, 7) -> (N, 4, 2) CCW corners."""
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    hx, hy = boxes[:, 3] / 2.0, boxes[:, 4] / 2.0
    local = np.array([[1, 1], [-1, 1], [-1, -1], [1, -1]], np.float32)
    lx = local[None, :, 0] * hx[:, None]
    ly = local[None, :, 1] * hy[:, None]
    x = lx * c[:, None] - ly * s[:, None] + boxes[:, None, 0]
    y = lx * s[:, None] + ly * c[:, None] + boxes[:, None, 1]
    return np.stack([x, y], axis=-1)


def boxes_bev_overlap_cpu(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(N, 7) x (M, 7) -> (N, M) rotated BEV intersection area, by vectorized
    polygon clipping."""
    N, M = len(boxes_a), len(boxes_b)
    if N == 0 or M == 0:
        return np.zeros((N, M), np.float32)
    ca = _bev_corners(boxes_a.astype(np.float32))   # (N, 4, 2)
    cb = _bev_corners(boxes_b.astype(np.float32))   # (M, 4, 2)

    # pairwise state: verts (N, M, P, 2), cnt (N, M)
    verts = np.zeros((N, M, _P, 2), np.float32)
    verts[:, :, :4] = ca[:, None, :, :]
    cnt = np.full((N, M), 4, np.int64)

    for k in range(4):
        a = cb[:, k]                    # (M, 2)
        b = cb[:, (k + 1) % 4]          # (M, 2)
        e = b - a                       # (M, 2)
        # signed dist of each vertex to edge: cross(e, v - a)
        d = (e[None, :, None, 0] * (verts[..., 1] - a[None, :, None, 1])
             - e[None, :, None, 1] * (verts[..., 0] - a[None, :, None, 0]))  # (N,M,P)
        idx = np.arange(_P)
        nxt_idx = np.where(idx[None, None] + 1 < cnt[..., None], idx + 1, 0)  # (N,M,P)
        d_nxt = np.take_along_axis(d, nxt_idx, axis=2)
        v_nxt = np.take_along_axis(verts, nxt_idx[..., None].repeat(2, -1), axis=2)
        cur_in = d >= 0
        nxt_in = d_nxt >= 0
        live = idx[None, None] < cnt[..., None]
        denom = d - d_nxt
        t = d / np.where(np.abs(denom) > _EPS, denom, _EPS)
        inter = verts + t[..., None] * (v_nxt - verts)

        out_verts = np.zeros((N, M, 2 * _P, 2), np.float32)
        out_valid = np.zeros((N, M, 2 * _P), bool)
        out_verts[:, :, 0::2] = verts
        out_valid[:, :, 0::2] = live & cur_in
        out_verts[:, :, 1::2] = inter
        out_valid[:, :, 1::2] = live & (cur_in != nxt_in)
        order = np.argsort(~out_valid, axis=2, kind='stable')[..., :_P]
        verts = np.take_along_axis(out_verts, order[..., None].repeat(2, -1), axis=2)
        cnt = out_valid.sum(axis=2)

    # shoelace with invalid slots replaced by v0
    live = np.arange(_P)[None, None] < cnt[..., None]
    v = np.where(live[..., None], verts, verts[:, :, :1])
    v_next = np.roll(v, -1, axis=2)
    cross = v[..., 0] * v_next[..., 1] - v_next[..., 0] * v[..., 1]
    area = np.abs(cross.sum(axis=2)) / 2.0
    return np.where(cnt >= 3, area, 0.0).astype(np.float32)


def boxes_bev_iou_cpu(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    overlap = boxes_bev_overlap_cpu(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return overlap / np.clip(area_a + area_b - overlap, 1e-6, None)


def rect_overlap_cpu(rects_a: np.ndarray, rects_b: np.ndarray) -> np.ndarray:
    """(N, 5) x (M, 5) rotated-rect [cx, cy, dx, dy, angle] intersection areas."""
    def to7(r):
        out = np.zeros((len(r), 7), np.float32)
        out[:, 0:2] = r[:, 0:2]
        out[:, 3:5] = r[:, 2:4]
        out[:, 6] = r[:, 4]
        return out
    return boxes_bev_overlap_cpu(to7(rects_a), to7(rects_b))
