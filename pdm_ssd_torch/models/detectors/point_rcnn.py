"""PointRCNN (counterpart of `pdm_ssd_tpu/models/detectors/point_rcnn.py`):
point backbone -> per-point proposals -> canonical ROI refinement, then one
rotated NMS on the refined boxes. The serving path; its training path is
not ported yet."""
from __future__ import annotations

import copy

import torch
from torch import nn

from ...ops import iou3d
from ...utils.config import as_cfg
from ..backbones_3d.pointnet2_backbone import PointNet2MSG
from ..dense_heads.point_head_box import PointHeadBox
from ..model_nms import take_rows
from ..roi_heads.pointrcnn_head import PointRCNNHead


class PointRCNN(nn.Module):
    def __init__(self, model_cfg, num_class: int, dataset_cfg, class_names=None, device=None):
        super().__init__()
        cfg = as_cfg(copy.deepcopy(model_cfg))
        ds_cfg = as_cfg(dataset_cfg)
        self.model_cfg = cfg
        self.num_class = num_class
        self.backbone_3d = PointNet2MSG(cfg.BACKBONE_3D, ds_cfg.get('NUM_POINT_FEATURES', 4),
                                        tuple(ds_cfg.POINT_CLOUD_RANGE), device=device)
        n_feat = self.backbone_3d.num_point_features
        self.point_head = PointHeadBox(cfg.POINT_HEAD, n_feat, num_class, device=device)
        self.roi_head = PointRCNNHead(cfg.ROI_HEAD, num_class, n_feat, device=device)

    def forward(self, batch: dict, generator: torch.Generator | None = None,
                target_generator: torch.Generator | None = None) -> dict:
        """`generator` is handed to the backbone's 'random' sampling levels,
        `target_generator` to the ROI head's target sampling in training."""
        batch = dict(batch)
        batch = self.backbone_3d(batch, generator)
        batch = self.point_head(batch)
        cls_preds, box_preds = self.point_head.generate_predicted_boxes(
            batch['point_coords'], batch['point_cls_preds'], batch['point_box_preds'])
        batch['batch_cls_preds'] = cls_preds
        batch['batch_box_preds'] = box_preds
        return self.roi_head(batch, target_generator)

    def get_training_loss(self, batch: dict) -> tuple:
        """The point head's targets and loss plus the ROI head's loss on its
        'roi_targets', from a training forward's output. Returns (loss, tb)."""
        p_loss, tb = self.point_head.get_loss(batch, self.point_head.assign_targets(batch))
        r_loss, tb2 = self.roi_head.get_loss(batch, batch['roi_targets'])
        loss = p_loss + r_loss
        return loss, {**tb, **tb2, 'loss': loss}

    def forward_with_loss(self, batch: dict, target_generator: torch.Generator | None = None):
        """Forward in training mode with the batch's 'gt_boxes' and 'gt_mask',
        then `get_training_loss`: (loss, tb). `target_generator` draws the ROI
        targets' sampling (see `RoIHeadTemplate.assign_targets`)."""
        return self.get_training_loss(self(batch, target_generator=target_generator))

    @torch.inference_mode()
    def predict(self, batch: dict) -> dict:
        """Forward + post-processing. The model must be in eval mode."""
        if self.training:
            raise RuntimeError('predict needs eval mode (call model.eval())')
        return self.post_process(self(batch))

    def post_process(self, batch: dict) -> dict:
        """Refined boxes through one rotated NMS by the ROI head's scores.
        Returns (B, P, 7) boxes and (B, P) scores, labels (1-based) and mask."""
        pp = self.model_cfg.POST_PROCESSING
        boxes, scores = self.roi_head.generate_predicted_boxes(
            batch['rois'], batch['rcnn_cls_preds'], batch['rcnn_reg_preds'])
        labels = batch['roi_labels']
        valid = batch['roi_mask'] & (scores > pp.get('SCORE_THRESH', 0.1))
        nms_cfg = pp.NMS_CONFIG
        idx, keep = iou3d.nms_bev(boxes, scores, nms_cfg.NMS_THRESH,
                                  pre_maxsize=nms_cfg.NMS_PRE_MAXSIZE,
                                  post_maxsize=nms_cfg.NMS_POST_MAXSIZE, valid=valid)
        return {'pred_boxes': take_rows(boxes, idx), 'pred_scores': take_rows(scores, idx) * keep,
                'pred_labels': take_rows(labels, idx) * keep, 'pred_mask': keep}
