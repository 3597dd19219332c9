"""CenterNet heatmap targets and fixed-K decode (counterpart of
`pdm_ssd_tpu/ops/centernet.py`)."""
from __future__ import annotations

import torch

from .selection import two_stage_topk

RMAX = 24  # largest Gaussian radius in cells


def gaussian_radius(height: torch.Tensor, width: torch.Tensor,
                    min_overlap: float = 0.5) -> torch.Tensor:
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt((b1 ** 2 - 4 * c1).clamp(min=0))) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt((b2 ** 2 - 16 * c2).clamp(min=0))) / 2
    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt((b3 ** 2 - 4 * a3 * c3).clamp(min=0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def draw_gaussians_dense(heatmap: torch.Tensor, centers_int: torch.Tensor,
                         radius: torch.Tensor, class_ids: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Max-compose one Gaussian per object onto a class heatmap.

    heatmap (B, C, H, W); centers_int (B, M, 2) integer (x, y) cells; radius
    (B, M) integer; class_ids (B, M) in [0, C); valid (B, M) bool. Each
    object contributes exp(-(dx^2 + dy^2) / (2 sigma^2)), sigma = (2r + 1) / 6
    with r clipped to [1, RMAX], on the square |dx|, |dy| <= r."""
    _, C, H, W = heatmap.shape
    dev = heatmap.device
    r = radius.clamp(1, RMAX)
    sigma = (2 * r.float() + 1) / 6.0
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    dx = xs - centers_int[..., 0, None, None]                     # (B, M, H, W)
    dy = ys - centers_int[..., 1, None, None]
    g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma[..., None, None] ** 2))
    inside = ((dx.abs() <= r[..., None, None]) & (dy.abs() <= r[..., None, None])
              & valid[..., None, None])
    g = torch.where(inside, g, 0.0)
    per_class = [torch.where((class_ids == c)[..., None, None], g, 0.0).amax(dim=1)
                 for c in range(C)]
    return torch.maximum(heatmap, torch.stack(per_class, dim=1))


def assign_center_targets(gt_boxes: torch.Tensor, gt_valid: torch.Tensor, num_classes: int,
                          feature_map_size, feature_map_stride, voxel_size,
                          point_cloud_range, gaussian_overlap: float = 0.1,
                          min_radius: int = 2):
    """CenterHead targets of one head for a batch.

    gt_boxes (B, M, 8): x y z dx dy dz heading class (1-indexed); gt_valid
    (B, M) bool; feature_map_size (W, H). Returns heatmap (B, C, H, W),
    target boxes (B, M, 8) (offsets in the cell, z, log sizes, cos, sin),
    inds (B, M) int32 = y * W + x, mask (B, M) int32, and the raw boxes of
    the kept slots (B, M, 8). Float-to-int casts truncate."""
    W, H = int(feature_map_size[0]), int(feature_map_size[1])
    x, y, z = gt_boxes[..., 0], gt_boxes[..., 1], gt_boxes[..., 2]
    coord_x = (x - point_cloud_range[0]) / voxel_size[0] / feature_map_stride
    coord_y = (y - point_cloud_range[1]) / voxel_size[1] / feature_map_stride
    center = torch.stack([coord_x.clamp(0, W - 0.5), coord_y.clamp(0, H - 0.5)], dim=-1)
    center_int = center.to(torch.int32)
    dx = gt_boxes[..., 3] / voxel_size[0] / feature_map_stride
    dy = gt_boxes[..., 4] / voxel_size[1] / feature_map_stride
    radius = gaussian_radius(dx, dy, min_overlap=gaussian_overlap).to(torch.int32)
    radius = radius.clamp(min=min_radius)
    ok = (gt_valid & (dx > 0) & (dy > 0)
          & (center_int[..., 0] >= 0) & (center_int[..., 0] <= W)
          & (center_int[..., 1] >= 0) & (center_int[..., 1] <= H))
    cls_ids = (gt_boxes[..., -1].to(torch.int32) - 1).clamp(0, num_classes - 1)
    heatmap = torch.zeros((gt_boxes.shape[0], num_classes, H, W), dtype=torch.float32,
                          device=gt_boxes.device)
    heatmap = draw_gaussians_dense(heatmap, center_int, radius, cls_ids, ok)
    vals = torch.cat([center - center_int.float(), z[..., None],
                      torch.log(gt_boxes[..., 3:6].clamp(min=1e-5)),
                      torch.cos(gt_boxes[..., 6])[..., None],
                      torch.sin(gt_boxes[..., 6])[..., None],
                      gt_boxes[..., 7:-1]], dim=-1)
    ret_boxes = torch.where(ok[..., None], vals, 0.0)
    inds = torch.where(ok, center_int[..., 1] * W + center_int[..., 0], 0)
    src = torch.where(ok[..., None], gt_boxes, 0.0)
    return heatmap, ret_boxes, inds, ok.to(torch.int32), src


def topk_heatmap(scores: torch.Tensor, K: int):
    """(B, C, H, W) -> top-K over all classes and positions:
    (scores, flat yx indices, classes, ys, xs), each (B, K)."""
    B, C, H, W = scores.shape
    topk_score, topk_ind = two_stage_topk(scores.reshape(B, C * H * W), K)
    topk_classes = topk_ind // (H * W)
    topk_inds = topk_ind % (H * W)
    topk_ys = (topk_inds // W).float()
    topk_xs = (topk_inds % W).float()
    return topk_score, topk_inds, topk_classes, topk_ys, topk_xs


def decode_bbox_from_heatmap(heatmap, rot_cos, rot_sin, center, center_z, dim,
                             point_cloud_range, voxel_size, feature_map_stride,
                             K=100, score_thresh=None, post_center_limit_range=None):
    """All channel tensors are (B, C_head, H, W). Returns fixed-shape boxes
    (B, K, 7), scores (B, K), labels (B, K) and mask (B, K)."""
    B = heatmap.shape[0]
    scores, inds, class_ids, ys, xs = topk_heatmap(heatmap, K)

    def gather(feat):   # (B, C, H, W) -> (B, K, C)
        C = feat.shape[1]
        flat = feat.reshape(B, C, -1).transpose(1, 2)
        return torch.gather(flat, 1, inds[..., None].expand(-1, -1, C))

    center = gather(center)
    rot_sin = gather(rot_sin)[..., 0]
    rot_cos = gather(rot_cos)[..., 0]
    center_z = gather(center_z)[..., 0]
    dim = gather(dim)
    angle = torch.atan2(rot_sin, rot_cos)
    xs = xs + center[..., 0]
    ys = ys + center[..., 1]
    xs = xs * feature_map_stride * voxel_size[0] + point_cloud_range[0]
    ys = ys * feature_map_stride * voxel_size[1] + point_cloud_range[1]
    boxes = torch.cat([xs[..., None], ys[..., None], center_z[..., None], dim,
                       angle[..., None]], dim=-1)

    mask = torch.ones((B, K), dtype=torch.bool, device=heatmap.device)
    if post_center_limit_range is not None:
        lim = torch.tensor(post_center_limit_range, dtype=torch.float32, device=heatmap.device)
        mask &= (boxes[..., :3] >= lim[:3]).all(dim=-1)
        mask &= (boxes[..., :3] <= lim[3:]).all(dim=-1)
    if score_thresh is not None:
        mask &= scores > score_thresh
    return {'pred_boxes': boxes, 'pred_scores': scores, 'pred_labels': class_ids,
            'pred_mask': mask}
