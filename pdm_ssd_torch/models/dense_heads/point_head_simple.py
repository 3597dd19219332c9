"""Auxiliary point-classification head, train-only (counterpart of
`pdm_ssd_tpu/models/dense_heads/point_head_simple.py`): per-point foreground
supervision of the backbone, dropped at inference (the detector's
post-processing reads nothing of it)."""
from __future__ import annotations

import torch
from torch import nn

from ...ops import box_ops, losses
from ...parallel import ddp
from ...utils.config import as_cfg
from ..layers import FCStack


class PointHeadSimple(nn.Module):
    def __init__(self, model_cfg, input_channels: int, num_class: int, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        self.cfg = cfg
        self.num_class = num_class
        self.cls_layers = FCStack(input_channels, tuple(cfg.CLS_FC), num_class, device=device)

    def forward(self, batch: dict) -> dict:
        key = 'point_features_before_fusion' \
            if self.cfg.get('USE_POINT_FEATURES_BEFORE_FUSION', False) else 'point_features'
        cls_preds = self.cls_layers(batch[key])
        batch['aux_point_cls_preds'] = cls_preds
        batch['aux_point_cls_scores'] = torch.sigmoid(cls_preds)
        return batch

    def assign_targets(self, batch: dict) -> dict:
        """Segment labels: 1 for a point inside a gt box, -1 (ignored) for one
        that only the box enlarged by GT_EXTRA_WIDTH contains, else 0."""
        points = batch['point_coords']           # (B, N, 3)
        gt_boxes = batch['gt_boxes']             # (B, M, 8), class last
        gt_mask = batch.get('gt_mask')
        if gt_mask is None:
            gt_mask = (gt_boxes[..., 3:6] > 0).any(dim=-1)
        extra = self.cfg.TARGET_CONFIG.get('GT_EXTRA_WIDTH', [0.2, 0.2, 0.2])
        ext_boxes = box_ops.enlarge_box3d(gt_boxes, extra)
        fg = box_ops.points_in_boxes(points, gt_boxes[..., :7], box_mask=gt_mask) >= 0
        ignore = fg ^ (box_ops.points_in_boxes(points, ext_boxes[..., :7], box_mask=gt_mask) >= 0)
        labels = torch.where(ignore, -1, fg.to(torch.int32))
        return {'aux_point_cls_labels': labels}

    def get_loss(self, batch: dict, targets: dict) -> tuple:
        """Focal loss of every class column against the foreground label,
        normalised by max(number of foreground points, 1) of the global
        batch."""
        labels = targets['aux_point_cls_labels'].reshape(-1)
        cls_preds = batch['aux_point_cls_preds'].reshape(-1, self.num_class)
        positives = labels > 0
        cls_weights = (labels >= 0).float() / ddp.global_sum(positives.float().sum()).clamp(
            min=1.0)
        one_hot = positives[:, None].float().expand_as(cls_preds)
        loss = losses.sigmoid_focal_loss(cls_preds, one_hot, cls_weights).sum()
        loss = loss * self.cfg.LOSS_CONFIG.LOSS_WEIGHTS['point_cls_weight']
        return loss, {'aux_point_loss_cls': loss}
