"""Two-stage ROI refinement template with fixed-size outputs (counterpart of
`pdm_ssd_tpu/models/roi_heads/roi_head_template.py`): the proposal layer and
the decode of canonical residuals. Target assignment and the ROI losses
belong to the training path, which is not ported yet."""
from __future__ import annotations

import torch
from torch import nn

from ...ops import box_ops, iou3d
from ...ops.coders import ResidualCoder
from ...utils.config import as_cfg
from ..model_nms import take_rows


class RoIHeadTemplate(nn.Module):
    def __init__(self, model_cfg, num_class: int):
        super().__init__()
        self.model_cfg = as_cfg(model_cfg)
        self.num_class = num_class

    @torch.no_grad()
    def proposal_layer(self, batch: dict) -> dict:
        """Class-agnostic rotated NMS over the first stage's boxes into exactly
        NMS_POST_MAXSIZE slots and a validity mask. No gradient flows back
        into the first stage through the proposals. Adds 'rois' (B, R, 7),
        'roi_scores', 'roi_labels' (1-based, 0 where empty) and 'roi_mask'."""
        cfg = self.model_cfg.NMS_CONFIG['TRAIN' if self.training else 'TEST']
        boxes = batch['batch_box_preds']                        # (B, N, 7+)
        cls_preds = batch['batch_cls_preds']                    # (B, N, nc)
        scores = torch.sigmoid(cls_preds).amax(dim=-1)
        labels = torch.argmax(cls_preds, dim=-1) + 1
        idx, keep = iou3d.nms_bev(boxes[..., :7], scores, cfg.NMS_THRESH,
                                  pre_maxsize=cfg.NMS_PRE_MAXSIZE,
                                  post_maxsize=cfg.NMS_POST_MAXSIZE)
        batch['rois'] = take_rows(boxes, idx)[..., :7]
        batch['roi_scores'] = take_rows(scores, idx) * keep
        batch['roi_labels'] = take_rows(labels, idx) * keep
        batch['roi_mask'] = keep
        return batch

    def assign_targets(self, batch: dict):
        raise NotImplementedError('ROI target assignment is not ported yet '
                                  '(ROADMAP Queue 1 item 5, PointRCNN training)')

    def get_loss(self, batch: dict, targets: dict):
        raise NotImplementedError('the ROI losses are not ported yet '
                                  '(ROADMAP Queue 1 item 5, PointRCNN training)')

    def generate_predicted_boxes(self, rois, rcnn_cls, rcnn_reg):
        """Decode canonical residuals back to the global frame: rois (B, R, 7),
        rcnn_cls (B, R, 1), rcnn_reg (B, R, 7) -> boxes (B, R, 7), scores (B, R)."""
        B, R = rois.shape[:2]
        zeros = torch.zeros_like(rois[..., :3])
        canonical_roi = torch.cat([zeros, rois[..., 3:6], zeros[..., :1]], dim=-1)
        local = ResidualCoder().decode(rcnn_reg, canonical_roi)
        center = box_ops.rotate_points_along_z(
            local[..., :3].reshape(B * R, 1, 3),
            rois[..., 6].reshape(B * R)).reshape(B, R, 3) + rois[..., :3]
        heading = local[..., 6] + rois[..., 6]
        boxes = torch.cat([center, local[..., 3:6], heading[..., None]], dim=-1)
        return boxes, torch.sigmoid(rcnn_cls[..., 0])
