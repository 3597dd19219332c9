"""Part-A2 (counterpart of `pdm_ssd_tpu/models/detectors/parta2.py`):

    MeanVFE -> DenseUNetV2 or SparseUNetV2 (by BACKBONE_3D.NAME: the encoder's
    BEV map and the decoder's voxel-point features)
    -> BaseBEVBackbone -> AnchorHeadSingle (the proposals)
    -> PointIntraPartOffsetHead (segmentation and part locations)
    -> PartA2FCHead (ROI-aware pooling and refinement),

with PV-RCNN's losses and post-processing.
"""
from __future__ import annotations

import torch

from ..dense_heads.point_intra_part_head import PointIntraPartOffsetHead
from ..roi_heads.parta2_head import PartA2FCHead
from .pv_rcnn import PVRCNN


class PartA2Net(PVRCNN):
    DATA_PARALLEL_HELD = ('SparseUNetV2',)

    def _build_second_stage(self, cfg, ds, device) -> None:
        """No keypoints; the point head reads the UNet's point features."""
        self.pfe = None
        agnostic = cfg.POINT_HEAD.get('CLASS_AGNOSTIC', True)
        self.point_head = PointIntraPartOffsetHead(cfg.POINT_HEAD,
                                                   self.backbone_3d.num_point_features,
                                                   1 if agnostic else self.num_class,
                                                   device=device)
        self.roi_head = PartA2FCHead(cfg.ROI_HEAD, self.num_class,
                                     self.backbone_3d.num_point_features, device=device)

    def forward(self, batch: dict, target_generator: torch.Generator | None = None) -> dict:
        """`target_generator` draws the ROI head's target sampling in training."""
        return self.roi_head(self.point_head(self.first_stage(batch)), target_generator)
