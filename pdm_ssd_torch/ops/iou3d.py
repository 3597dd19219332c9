"""Rotated BEV IoU, 3D IoU and rotated NMS (counterpart of `pdm_ssd_tpu/ops/iou3d.py`).

The overlap is the JAX package's vectorized Sutherland-Hodgman clip: box a
is clipped by the four edges of box b with growing vertex buffers, and the
area is the shoelace sum. Compaction after each clip is an exclusive
`cumsum` rank and a scatter. `nms_bev` takes the pre-NMS top K by score
(ties lower index first), suppresses by IoU > thresh in one sequential
greedy pass over the K candidates, vectorized over the batch, and returns
`post_maxsize` slots with a keep mask. `circle_nms` suppresses by center
distance, with the same keep set computed as the JAX package's fixpoint.
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
    # the scan runs along the outer axis of the transposed counts: S is at
    # most 14, and PyTorch's scan along so short an innermost axis is slow
    # (13 scans of 2M rows: 109 ms of one PointRCNN predict on an H100 at
    # 700 W, read with `tools/profile_predict.py`; under 2.3 ms this way)
    rank = torch.cumsum(v.t().contiguous(), dim=0).t() - v
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


def boxes_overlap_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 7) x (..., M, 7) -> (..., N, M) rotated BEV intersection
    areas; entry (i, j) clips box a_i by box b_j."""
    lead = boxes_a.shape[:-2]
    N, M = boxes_a.shape[-2], boxes_b.shape[-2]
    aa = boxes_a[..., :, None, :].expand(*lead, N, M, boxes_a.shape[-1]).reshape(-1, boxes_a.shape[-1])
    bb = boxes_b[..., None, :, :].expand(*lead, N, M, boxes_b.shape[-1]).reshape(-1, boxes_b.shape[-1])
    return overlap_bev_pairs(aa, bb).reshape(*lead, N, M)


def boxes_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 7) x (..., M, 7) -> (..., N, M) rotated BEV IoU."""
    overlap = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[..., 3] * boxes_a[..., 4])[..., :, None]
    area_b = (boxes_b[..., 3] * boxes_b[..., 4])[..., None, :]
    return overlap / torch.clamp(area_a + area_b - overlap, min=1e-6)


def boxes_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 7) x (M, 7) -> (N, M) 3D IoU: the BEV overlap times the overlap of
    the z extents, over the union of the volumes
    (`iou3d_nms_utils.boxes_iou3d_gpu:48-81`)."""
    overlap_bev = boxes_overlap_bev(boxes_a, boxes_b)
    a_max = (boxes_a[:, 2] + boxes_a[:, 5] / 2)[:, None]
    a_min = (boxes_a[:, 2] - boxes_a[:, 5] / 2)[:, None]
    b_max = (boxes_b[:, 2] + boxes_b[:, 5] / 2)[None, :]
    b_min = (boxes_b[:, 2] - boxes_b[:, 5] / 2)[None, :]
    overlap_h = torch.clamp(torch.minimum(a_max, b_max) - torch.maximum(a_min, b_min), min=0.0)
    overlap_3d = overlap_bev * overlap_h
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return overlap_3d / torch.clamp(vol_a + vol_b - overlap_3d, min=1e-6)


def _suppression_matrix(cand: torch.Tensor, thresh: float, blk: int = 512) -> torch.Tensor:
    """(B, K, 7) -> (B, K, K) bool: rotated BEV IoU > thresh, built in tiles
    of `blk` rows. The clip keeps some hundred bytes of temporaries per box
    pair, so the whole K x K at once would take gigabytes at K = 1024 and
    more; the values are those of the untiled computation."""
    K = cand.shape[1]
    if K <= blk:
        return boxes_iou_bev(cand, cand) > thresh
    return torch.cat([boxes_iou_bev(cand[:, r0:r0 + blk], cand) > thresh
                      for r0 in range(0, K, blk)], dim=1)


def _keep_slots(order: torch.Tensor, keep: torch.Tensor, post_maxsize: int):
    """Kept candidates (already in score order) first, stably, cut or
    zero-padded to `post_maxsize` slots: (idx into N, keep mask)."""
    rank = torch.sort(torch.where(keep, 0, 1), dim=1, stable=True).indices
    P = min(post_maxsize, keep.shape[1])
    sel = rank[:, :P]
    out_idx = torch.gather(order, 1, sel)
    out_mask = torch.gather(keep, 1, sel)
    if P < post_maxsize:
        out_idx = torch.nn.functional.pad(out_idx, (0, post_maxsize - P))
        out_mask = torch.nn.functional.pad(out_mask, (0, post_maxsize - P))
    return torch.where(out_mask, out_idx, 0), out_mask


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
    suppress = _suppression_matrix(cand, thresh)                    # (B, K, K)
    cand_valid = torch.isfinite(top_scores)
    keep = cand_valid.clone()
    for i in range(1, K):
        hit = (suppress[:, i, :i] & keep[:, :i]).any(dim=1)
        keep[:, i] = cand_valid[:, i] & ~hit
    return _keep_slots(order, keep, post_maxsize)


def greedy_suppress(overlap: torch.Tensor, cand_valid: torch.Tensor) -> torch.Tensor:
    """The greedy keep set keep[i] = valid[i] & !any_{j<i}(keep[j] &
    overlap[i, j]) of (B, K, K) bool `overlap` (candidates in rank order),
    by the JAX package's Jacobi fixpoint: from keep = valid, recompute every
    entry from the last keep set until nothing changes. After step t the
    first t entries are final, so it ends within K steps; the steps are as
    many as the deepest chain of suppressions, each one batched matvec and
    one comparison read by the host."""
    K = overlap.shape[-1]
    idx = torch.arange(K, device=overlap.device)
    prev = overlap & (idx[None, :] < idx[:, None])              # higher-ranked only
    keep = cand_valid
    for _ in range(K):
        new = cand_valid & ~(prev & keep[:, None, :]).any(dim=-1)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def circle_nms(boxes: torch.Tensor, scores: torch.Tensor, radius: float, pre_maxsize: int,
               post_maxsize: int, valid: torch.Tensor | None = None):
    """Batched center-distance NMS with fixed-size outputs
    (`centernet_utils.circle_nms` analog): a candidate is suppressed by a
    higher-scoring kept one whose BEV center lies within `radius`
    (d^2 <= radius^2). Arguments and returns as `nms_bev`."""
    N = scores.shape[1]
    s = scores if valid is None else torch.where(valid, scores, float('-inf'))
    K = min(pre_maxsize, N)
    top_scores, order = topk(s, K)
    cb = torch.gather(boxes[..., :2], 1, order[..., None].expand(-1, -1, 2))
    d2 = ((cb[:, :, None, :] - cb[:, None, :, :]) ** 2).sum(dim=-1)    # (B, K, K)
    keep = greedy_suppress(d2 <= radius * radius, torch.isfinite(top_scores))
    return _keep_slots(order, keep, post_maxsize)
