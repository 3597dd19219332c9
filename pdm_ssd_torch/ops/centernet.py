"""CenterNet heatmap decode, fixed K (counterpart of the decode half of
`pdm_ssd_tpu/ops/centernet.py`). Target assignment is training work, not
ported yet."""
from __future__ import annotations

import torch

from .selection import two_stage_topk


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
