"""Rotated BEV IoU and rotated NMS (counterpart of `pdm_ssd_tpu/ops/iou3d.py`).

The overlap is the JAX package's vectorized Sutherland-Hodgman clip: box a
is clipped by the four edges of box b with growing vertex buffers, and the
area is the shoelace sum. Compaction after each clip is an exclusive
`cumsum` rank and a scatter. `nms_bev` takes the pre-NMS top K by score
(ties lower index first), suppresses by IoU > thresh in one sequential
greedy pass over the K candidates, vectorized over the batch, and returns
`post_maxsize` slots with a keep mask.
"""
from __future__ import annotations

import torch

from .selection import topk

_EPS = 1e-8


def _boxes_to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(R, 7) -> (R, 4, 2) BEV corners, counter-clockwise."""
    cx, cy, dx, dy, rz = boxes[:, 0], boxes[:, 1], boxes[:, 3], boxes[:, 4], boxes[:, 6]
    c, s = torch.cos(rz), torch.sin(rz)
    local = torch.tensor([[1., 1.], [-1., 1.], [-1., -1.], [1., -1.]], device=boxes.device)
    lx = local[None, :, 0] * (dx / 2)[:, None]
    ly = local[None, :, 1] * (dy / 2)[:, None]
    x = lx * c[:, None] - ly * s[:, None] + cx[:, None]
    y = lx * s[:, None] + ly * c[:, None] + cy[:, None]
    return torch.stack([x, y], dim=-1)


def _compact(verts: torch.Tensor, valid: torch.Tensor, out_slots: int):
    """Move the valid vertices, in order, to the front of an `out_slots`
    buffer (zeros behind). verts (R, S, 2), valid (R, S) -> (verts, cnt (R,))."""
    R = verts.shape[0]
    v = valid.long()
    rank = torch.cumsum(v, dim=1) - v
    slot = torch.where(valid & (rank < out_slots), rank, out_slots)
    out = torch.zeros((R, out_slots + 1, 2), dtype=verts.dtype, device=verts.device)
    out.scatter_(1, slot[..., None].expand(-1, -1, 2), verts)
    return out[:, :out_slots], v.sum(dim=1)


def _clip_halfplane(verts, cnt, a, b, out_slots: int):
    """Clip the convex polygons (prefix `cnt` of verts (R, P, 2)) by the
    half-plane left of the edge a -> b ((R, 2) each)."""
    P = verts.shape[1]
    e = b - a
    d = (e[:, None, 0] * (verts[..., 1] - a[:, None, 1])
         - e[:, None, 1] * (verts[..., 0] - a[:, None, 0]))    # (R, P)
    idx = torch.arange(P, device=verts.device)[None, :]
    live = idx < cnt[:, None]
    wrap = (idx + 1) == cnt[:, None]                           # cyclic successor of the last
    d_nxt = torch.where(wrap, d[:, :1], torch.roll(d, -1, dims=1))
    v_nxt = torch.where(wrap[..., None], verts[:, :1], torch.roll(verts, -1, dims=1))
    cur_in = d >= 0.0
    nxt_in = d_nxt >= 0.0
    denom = d - d_nxt
    t = d / torch.where(denom.abs() > _EPS, denom, torch.full_like(denom, _EPS))
    inter = verts + t[..., None] * (v_nxt - verts)
    R = verts.shape[0]
    out_verts = torch.stack([verts, inter], dim=2).reshape(R, 2 * P, 2)
    out_valid = torch.stack([live & cur_in, live & (cur_in != nxt_in)], dim=2).reshape(R, 2 * P)
    return _compact(out_verts, out_valid, out_slots)


def overlap_bev_pairs(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Exact rotated-rectangle intersection areas of R pairs: (R, 7), (R, 7) -> (R,)."""
    R = boxes_a.shape[0]
    ca = _boxes_to_corners(boxes_a)
    cb = _boxes_to_corners(boxes_b)
    verts = ca
    cnt = torch.full((R,), 4, dtype=torch.long, device=boxes_a.device)
    for k in range(4):
        verts, cnt = _clip_halfplane(verts, cnt, cb[:, k], cb[:, (k + 1) % 4], out_slots=5 + k)
    idx = torch.arange(verts.shape[1], device=verts.device)[None, :]
    v = torch.where((idx < cnt[:, None])[..., None], verts, verts[:, :1])
    v_next = torch.roll(v, -1, dims=1)
    cross = v[..., 0] * v_next[..., 1] - v_next[..., 0] * v[..., 1]
    area = cross.sum(dim=1).abs() / 2.0
    return torch.where(cnt >= 3, area, 0.0)


def boxes_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 7) x (..., M, 7) -> (..., N, M) rotated BEV IoU; entry (i, j)
    clips box a_i by box b_j."""
    lead = boxes_a.shape[:-2]
    N, M = boxes_a.shape[-2], boxes_b.shape[-2]
    aa = boxes_a[..., :, None, :].expand(*lead, N, M, boxes_a.shape[-1]).reshape(-1, boxes_a.shape[-1])
    bb = boxes_b[..., None, :, :].expand(*lead, N, M, boxes_b.shape[-1]).reshape(-1, boxes_b.shape[-1])
    overlap = overlap_bev_pairs(aa, bb).reshape(*lead, N, M)
    area_a = (boxes_a[..., 3] * boxes_a[..., 4])[..., :, None]
    area_b = (boxes_b[..., 3] * boxes_b[..., 4])[..., None, :]
    return overlap / torch.clamp(area_a + area_b - overlap, min=1e-6)


def nms_bev(boxes: torch.Tensor, scores: torch.Tensor, thresh: float, pre_maxsize: int,
            post_maxsize: int, valid: torch.Tensor | None = None):
    """Batched rotated-BEV NMS with fixed-size outputs.

    boxes (B, N, 7), scores (B, N), valid (B, N) or None. Returns idx
    (B, post_maxsize) int64 indices into N (0 where empty) and keep
    (B, post_maxsize) bool, kept boxes in score order first."""
    B, N = scores.shape
    s = scores if valid is None else torch.where(valid, scores, float('-inf'))
    K = min(pre_maxsize, N)
    top_scores, order = topk(s, K)
    cand = torch.gather(boxes, 1, order[..., None].expand(-1, -1, boxes.shape[-1]))
    suppress = boxes_iou_bev(cand, cand) > thresh                   # (B, K, K)
    cand_valid = torch.isfinite(top_scores)
    keep = cand_valid.clone()
    for i in range(1, K):
        hit = (suppress[:, i, :i] & keep[:, :i]).any(dim=1)
        keep[:, i] = cand_valid[:, i] & ~hit
    rank = torch.sort(torch.where(keep, 0, 1), dim=1, stable=True).indices
    P = min(post_maxsize, K)
    sel = rank[:, :P]
    out_idx = torch.gather(order, 1, sel)
    out_mask = torch.gather(keep, 1, sel)
    if P < post_maxsize:
        out_idx = torch.nn.functional.pad(out_idx, (0, post_maxsize - P))
        out_mask = torch.nn.functional.pad(out_mask, (0, post_maxsize - P))
    return torch.where(out_mask, out_idx, 0), out_mask
