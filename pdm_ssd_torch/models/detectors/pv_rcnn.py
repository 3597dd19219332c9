"""PV-RCNN (counterpart of `pdm_ssd_tpu/models/detectors/pv_rcnn.py`):

    MeanVFE -> the dense or sparse voxel ladder (by BACKBONE_3D.NAME)
    -> BaseBEVBackbone -> AnchorHeadSingle (the proposals)
    -> VoxelSetAbstraction (keypoints) -> PointHeadSimple (training only)
    -> PVRCNNHead (keypoint grid pooling and refinement),

then one rotated NMS on the refined boxes. The submodules carry the JAX
package's names, so `utils/weights.from_flax` maps its tree one to one.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from ...ops import iou3d
from ...utils.config import as_cfg
from ..backbones_2d.base_bev_backbone import BaseBEVBackbone
from ..backbones_3d.pfe import VoxelSetAbstraction, is_sparse_ladder, stage_channels
from ..backbones_3d.vfe import build_vfe
from ..dense_heads.anchor_head import AnchorHeadSingle
from ..dense_heads.point_head_simple import PointHeadSimple
from ..model_nms import take_rows
from ..roi_heads.pvrcnn_head import PVRCNNHead
from .detector3d import _grid_info, build_voxel_backbone_3d


class PVRCNN(nn.Module):
    def __init__(self, model_cfg, num_class: int, dataset_cfg, class_names=None, device=None):
        super().__init__()
        cfg = as_cfg(copy.deepcopy(model_cfg))
        ds = as_cfg(dataset_cfg)
        self.model_cfg = cfg
        self.num_class = num_class
        self._build_first_stage(cfg, ds, class_names, device)
        self._build_second_stage(cfg, ds, device)

    def _build_second_stage(self, cfg, ds, device) -> None:
        """`pfe`, `point_head` and `roi_head`."""
        pc_range = tuple(ds.POINT_CLOUD_RANGE)
        num_pf = ds.get('NUM_POINT_FEATURES', 4)
        _, voxel = _grid_info(ds)
        self.pfe = VoxelSetAbstraction(cfg.PFE, voxel, pc_range,
                                       self.backbone_3d.num_bev_features, num_pf,
                                       stage_channels(cfg.BACKBONE_3D),
                                       is_sparse_ladder(cfg.BACKBONE_3D), device=device)
        # the head reads 'point_features_before_fusion', the sources' widths
        # together, or the fused features: the true width of either (the JAX
        # package passes NUM_OUTPUT_FEATURES, which flax's Dense ignores)
        self.point_head = None
        if cfg.get('POINT_HEAD') is not None:
            width = (self.pfe.num_fused_features
                     if cfg.POINT_HEAD.get('USE_POINT_FEATURES_BEFORE_FUSION', False)
                     else self.pfe.num_point_features)
            self.point_head = PointHeadSimple(cfg.POINT_HEAD, width, 1, device=device)
        self.roi_head = PVRCNNHead(cfg.ROI_HEAD, self.num_class, self.pfe.num_point_features,
                                   device=device)

    def _build_first_stage(self, cfg, ds, class_names, device) -> None:
        """`vfe`, `backbone_3d`, `backbone_2d` and `dense_head`."""
        pc_range = tuple(ds.POINT_CLOUD_RANGE)
        num_pf = ds.get('NUM_POINT_FEATURES', 4)
        (gw, gh, gd), voxel = _grid_info(ds)
        self.vfe = build_vfe(cfg.VFE, num_pf, voxel, pc_range, (gw, gh), device=device)
        self.backbone_3d = build_voxel_backbone_3d(cfg.BACKBONE_3D,
                                                   self.vfe.get_output_feature_dim(),
                                                   (gw, gh, gd), voxel, pc_range, device=device)
        self.backbone_2d = BaseBEVBackbone(cfg.BACKBONE_2D, self.backbone_3d.num_bev_features,
                                           device=device)
        stride = cfg.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.get('FEATURE_MAP_STRIDE', 8)
        self.dense_head = AnchorHeadSingle(cfg.DENSE_HEAD, self.backbone_2d.num_bev_features,
                                           self.num_class, class_names,
                                           grid_size=(gw // stride, gh // stride),
                                           point_cloud_range=pc_range, device=device)

    def first_stage(self, batch: dict) -> dict:
        """The voxel ladder, the BEV backbone and the anchor head, with their
        decoded boxes as the proposals' candidates."""
        batch = dict(batch)
        batch = self.vfe(batch)
        batch = self.backbone_3d(batch)
        batch = self.backbone_2d(batch)
        batch = self.dense_head(batch)
        # the decoded boxes feed the proposal layer only, which takes no gradient
        with torch.no_grad():
            cls_preds, box_preds = self.dense_head.generate_predicted_boxes(batch)
        batch['batch_cls_preds'] = cls_preds
        batch['batch_box_preds'] = box_preds
        return batch

    def forward(self, batch: dict, target_generator: torch.Generator | None = None) -> dict:
        """`target_generator` draws the ROI head's target sampling in training."""
        batch = self.pfe(self.first_stage(batch))
        if self.point_head is not None:
            batch = self.point_head(batch)
        return self.roi_head(batch, target_generator)

    def get_training_loss(self, batch: dict) -> tuple:
        """The anchor head's loss, the point head's, and the ROI head's on its
        'roi_targets', from a training forward's output. Returns (loss, tb)."""
        loss, tb = self.dense_head.get_loss(batch, self.dense_head.assign_targets(batch))
        if self.point_head is not None:
            p_loss, p_tb = self.point_head.get_loss(batch, self.point_head.assign_targets(batch))
            loss, tb = loss + p_loss, {**tb, **p_tb}
        r_loss, r_tb = self.roi_head.get_loss(batch, batch['roi_targets'])
        loss = loss + r_loss
        return loss, {**tb, **r_tb, 'loss': loss}

    def forward_with_loss(self, batch: dict, target_generator: torch.Generator | None = None):
        """Forward in training mode with the batch's 'gt_boxes' and 'gt_mask'
        (a sparse ladder's batch prepared by `get_host_prepare(...,
        training=True)`), then `get_training_loss`: (loss, tb)."""
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
