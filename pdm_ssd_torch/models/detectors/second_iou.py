"""SECOND-IoU (counterpart of `pdm_ssd_tpu/models/detectors/second_iou.py`):
PV-RCNN's first stage on the dense ladder, then `SECONDHead`, whose IoU
prediction rectifies the first stage's scores; the boxes stay the first
stage's ROIs."""
from __future__ import annotations

import torch

from ...ops import iou3d
from ..model_nms import take_rows
from ..roi_heads.second_head import SECONDHead
from .detector3d import _grid_info
from .pv_rcnn import PVRCNN


class SECONDNetIoU(PVRCNN):
    def _build_second_stage(self, cfg, ds, device) -> None:
        """No keypoints and no point head; `roi_head` crops the BEV map."""
        _, voxel = _grid_info(ds)
        self.pfe = None
        self.point_head = None
        self.roi_head = SECONDHead(cfg.ROI_HEAD, self.num_class,
                                   self.backbone_2d.num_bev_features, voxel,
                                   tuple(ds.POINT_CLOUD_RANGE), device=device)

    def forward(self, batch: dict, target_generator: torch.Generator | None = None) -> dict:
        """`target_generator` draws the ROI head's target sampling in training."""
        return self.roi_head(self.first_stage(batch), target_generator)

    def post_process(self, batch: dict) -> dict:
        """The IoU-rectified score roi_score^(1 - w) * sigmoid(iou)^w (w =
        IOU_RECTIFIER, 0.71 by default; the ROI score clipped to [1e-6, 1],
        the IoU from below at 1e-6), the ROIs as the boxes, one rotated NMS."""
        pp = self.model_cfg.POST_PROCESSING
        w = float(pp.get('IOU_RECTIFIER', 0.71))
        rois = batch['rois'][..., :7]
        roi_scores = batch['roi_scores'].clamp(1e-6, 1.0)
        iou = torch.sigmoid(batch['rcnn_iou_preds'][..., 0]).clamp(min=1e-6)
        scores = roi_scores ** (1 - w) * iou ** w
        labels = batch['roi_labels']
        valid = batch['roi_mask'] & (scores > pp.get('SCORE_THRESH', 0.1))
        nms_cfg = pp.NMS_CONFIG
        idx, keep = iou3d.nms_bev(rois, scores, nms_cfg.NMS_THRESH,
                                  pre_maxsize=nms_cfg.NMS_PRE_MAXSIZE,
                                  post_maxsize=nms_cfg.NMS_POST_MAXSIZE, valid=valid)
        return {'pred_boxes': take_rows(rois, idx), 'pred_scores': take_rows(scores, idx) * keep,
                'pred_labels': take_rows(labels, idx) * keep, 'pred_mask': keep}
