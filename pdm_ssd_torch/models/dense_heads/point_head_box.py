"""Point-wise box head, the vote branch of the hybrid head (counterpart of
`pdm_ssd_tpu/models/dense_heads/point_head_box.py`): forward, target
assignment, losses and box decode."""
from __future__ import annotations

import torch
from torch import nn

from ...ops import box_ops, losses
from ...ops.coders import build_box_coder
from ...utils.config import as_cfg
from ..layers import FCStack


class PointHeadBox(nn.Module):
    def __init__(self, model_cfg, input_channels: int, num_class: int, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        self.cfg = cfg
        self.num_class = num_class
        tc = cfg.TARGET_CONFIG
        self.box_coder = build_box_coder(tc.BOX_CODER, **tc.get('BOX_CODER_CONFIG', {}).to_dict())
        self.cls_layers = FCStack(input_channels, tuple(cfg.CLS_FC), num_class, device=device)
        self.box_layers = FCStack(input_channels, tuple(cfg.REG_FC), self.box_coder.code_size,
                                  device=device)

    def forward(self, batch: dict) -> dict:
        feats = batch['point_features']                 # (B, N, C)
        cls_preds = self.cls_layers(feats)
        batch['point_cls_preds'] = cls_preds
        batch['point_box_preds'] = self.box_layers(feats)
        batch['point_cls_scores'] = torch.sigmoid(cls_preds.amax(dim=-1))
        return batch

    def assign_targets(self, batch: dict) -> dict:
        """Per-point class and box targets: foreground from the gt box that
        contains the point, ignore (-1) for a point that only the box
        enlarged by GT_EXTRA_WIDTH contains (or only the plain one)."""
        points = batch['point_coords']           # (B, N, 3)
        gt_boxes = batch['gt_boxes']             # (B, M, 8), class last
        gt_mask = batch.get('gt_mask')           # (B, M) bool
        if gt_mask is None:
            gt_mask = (gt_boxes[..., 3:6] > 0).any(dim=-1)
        extra = self.cfg.TARGET_CONFIG.get('GT_EXTRA_WIDTH', [0.2, 0.2, 0.2])
        ext_boxes = box_ops.enlarge_box3d(gt_boxes, extra)
        box_idx = box_ops.points_in_boxes(points, gt_boxes[..., :7], box_mask=gt_mask)
        ext_idx = box_ops.points_in_boxes(points, ext_boxes[..., :7], box_mask=gt_mask)
        fg = box_idx >= 0
        ignore = fg ^ (ext_idx >= 0)
        rows = box_idx.clamp(min=0).long()[..., None].expand(-1, -1, gt_boxes.shape[-1])
        gt_of_pt = torch.gather(gt_boxes, 1, rows)                # (B, N, 8)
        gt_cls = gt_of_pt[..., -1].to(torch.int32)
        labels = torch.where(fg, 1 if self.num_class == 1 else gt_cls, 0)
        labels = torch.where(ignore, -1, labels)
        enc = self.box_coder.encode(gt_of_pt[..., :-1], points, gt_cls)
        return {'point_cls_labels': labels, 'point_box_labels': torch.where(fg[..., None], enc, 0.0)}

    def get_loss(self, batch: dict, targets: dict) -> tuple:
        """Focal class loss and weighted smooth-L1 box loss, both normalised
        by max(number of foreground points, 1)."""
        labels = targets['point_cls_labels'].reshape(-1)
        cls_preds = batch['point_cls_preds'].reshape(-1, self.num_class)
        positives = labels > 0
        pos_norm = positives.float().sum()
        cls_weights = (positives | (labels == 0)).float() / pos_norm.clamp(min=1.0)
        one_hot = torch.nn.functional.one_hot(labels.clamp(min=0).long(),
                                              self.num_class + 1)[..., 1:].float()
        cls_loss = losses.sigmoid_focal_loss(cls_preds, one_hot, cls_weights).sum()
        box_preds = batch['point_box_preds'].reshape(-1, batch['point_box_preds'].shape[-1])
        box_labels = targets['point_box_labels'].reshape(-1, box_preds.shape[-1])
        reg_weights = positives.float() / pos_norm.clamp(min=1.0)
        lw = self.cfg.LOSS_CONFIG.LOSS_WEIGHTS
        box_loss = losses.weighted_smooth_l1(box_preds, box_labels, reg_weights,
                                             code_weights=lw.get('code_weights')).sum()
        total = cls_loss * lw['point_cls_weight'] + box_loss * lw['point_box_weight']
        return total, {'point_loss_cls': cls_loss, 'point_loss_box': box_loss,
                       'point_pos_num': pos_norm}

    def generate_predicted_boxes(self, points, cls_preds, box_preds):
        """Decode per-point boxes with the argmax class's mean size."""
        pred_classes = torch.argmax(cls_preds, dim=-1)
        return cls_preds, self.box_coder.decode(box_preds, points, pred_classes + 1)
