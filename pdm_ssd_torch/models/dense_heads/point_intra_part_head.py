"""Part-A2's point head (counterpart of
`pdm_ssd_tpu/models/dense_heads/point_intra_part_head.py`): per voxel point,
a foreground segmentation and the intra-object part location (the point's
position in its box's frame, normalised to [0, 1]), over the UNet's padded
(B, V, C) point features with their mask."""
from __future__ import annotations

import torch
from torch import nn

from ...ops import box_ops, losses
from ...parallel import ddp
from ...utils.config import as_cfg
from ..layers import FCStack


class PointIntraPartOffsetHead(nn.Module):
    """Config: CLS_FC, PART_FC, TARGET_CONFIG.GT_EXTRA_WIDTH. Adds
    'point_cls_preds', 'point_part_preds' (logits), 'point_cls_scores' (the
    largest class sigmoid) and 'point_part_offset' (the part sigmoid)."""

    def __init__(self, model_cfg, input_channels: int, num_class: int, device=None):
        super().__init__()
        self.cfg = as_cfg(model_cfg)
        self.num_class = num_class
        self.cls_layers = FCStack(input_channels, tuple(self.cfg.get('CLS_FC', [128])),
                                  num_class, device=device)
        self.part_reg_layers = FCStack(input_channels, tuple(self.cfg.get('PART_FC', [128])), 3,
                                       device=device)

    def forward(self, batch: dict) -> dict:
        feats = batch['point_features']
        cls_preds = self.cls_layers(feats)
        part_preds = self.part_reg_layers(feats)
        batch['point_cls_preds'] = cls_preds
        batch['point_part_preds'] = part_preds
        batch['point_cls_scores'] = torch.sigmoid(cls_preds).amax(dim=-1)
        batch['point_part_offset'] = torch.sigmoid(part_preds)
        return batch

    def assign_targets(self, batch: dict) -> dict:
        """Labels 1 inside a ground-truth box, -1 (ignored) in the zone that
        only the box enlarged by GT_EXTRA_WIDTH holds and at masked points,
        else 0; part targets of the foreground points: the position in the
        owning box's frame over its size, plus 0.5, clipped to [0, 1] (0 at
        the others)."""
        points = batch['point_coords']                           # (B, V, 3)
        gt_boxes = batch['gt_boxes']
        gt_mask = batch.get('gt_mask')
        if gt_mask is None:
            gt_mask = (gt_boxes[..., 3:6] > 0).any(dim=-1)
        extra = self.cfg.get('TARGET_CONFIG', {})
        extra = extra.get('GT_EXTRA_WIDTH', [0.2, 0.2, 0.2]) if hasattr(extra, 'get') \
            else [0.2, 0.2, 0.2]
        ext_boxes = box_ops.enlarge_box3d(gt_boxes, extra)
        box_idx = box_ops.points_in_boxes(points, gt_boxes[..., :7], box_mask=gt_mask)
        ext_idx = box_ops.points_in_boxes(points, ext_boxes[..., :7], box_mask=gt_mask)
        fg = box_idx >= 0
        ignore = fg ^ (ext_idx >= 0)
        labels = torch.where(ignore, -1, fg.to(torch.int32))
        box = torch.gather(gt_boxes, 1, box_idx.clamp(min=0).long()[..., None]
                           .expand(-1, -1, gt_boxes.shape[-1]))          # (B, V, 8)
        local = points - box[..., :3]
        c, s = torch.cos(-box[..., 6]), torch.sin(-box[..., 6])
        lx = local[..., 0] * c - local[..., 1] * s
        ly = local[..., 0] * s + local[..., 1] * c
        part = torch.stack([lx / box[..., 3].clamp(min=1e-4) + 0.5,
                            ly / box[..., 4].clamp(min=1e-4) + 0.5,
                            local[..., 2] / box[..., 5].clamp(min=1e-4) + 0.5], dim=-1)
        part = torch.where(fg[..., None], part.clamp(0.0, 1.0), 0.0)
        if batch.get('point_mask') is not None:
            labels = torch.where(batch['point_mask'], labels, -1)
        return {'point_cls_labels': labels, 'point_part_labels': part}

    def get_loss(self, batch: dict, targets: dict) -> tuple:
        """The focal segmentation loss over the points not ignored, over the
        number of foreground points, and the binary cross entropy of the part
        sigmoid (clipped to [1e-6, 1 - 1e-6]) over the foreground points, both
        counts of the global batch."""
        labels = targets['point_cls_labels'].reshape(-1)
        cls_preds = batch['point_cls_preds'].reshape(-1, self.num_class)
        positives = labels > 0
        cls_weights = (labels >= 0).float() / ddp.global_sum(positives.float().sum()).clamp(
            min=1.0)
        one_hot = positives[:, None].float().expand_as(cls_preds)
        seg_loss = losses.sigmoid_focal_loss(cls_preds, one_hot, cls_weights).sum()
        part_preds = batch['point_part_preds'].reshape(-1, 3)
        part_tgt = targets['point_part_labels'].reshape(-1, 3)
        p = torch.sigmoid(part_preds).clamp(1e-6, 1 - 1e-6)
        bce = -(part_tgt * torch.log(p) + (1 - part_tgt) * torch.log(1 - p))
        w = positives.float()
        part_loss = (bce.sum(-1) * w).sum() / ddp.global_sum(w.sum()).clamp(min=1.0)
        return seg_loss + part_loss, {'part_seg_loss': seg_loss, 'part_reg_loss': part_loss}
