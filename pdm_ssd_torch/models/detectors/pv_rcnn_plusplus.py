"""PV-RCNN++ (counterpart of `pdm_ssd_tpu/models/detectors/pv_rcnn_plusplus.py`):
PV-RCNN's modules in another order. The proposals, and in training their
targets, come first, from the one draw of the target generator; the
keypoints are then sampled near them (SAMPLE_METHOD 'SPC', sector FPS), the
raw points aggregated by VectorPool, and the ROI head pools the keypoints
around the ROIs it is given."""
from __future__ import annotations

import torch

from .pv_rcnn import PVRCNN


class PVRCNNPlusPlus(PVRCNN):
    def forward(self, batch: dict, target_generator: torch.Generator | None = None) -> dict:
        """`target_generator` draws the ROI head's target sampling in training."""
        batch = self.roi_head.proposal_layer(self.first_stage(batch))
        if self.training and 'gt_boxes' in batch:
            batch['roi_targets'] = self.roi_head.assign_targets(batch, target_generator)
        batch = self.pfe(batch)
        if self.point_head is not None:
            batch = self.point_head(batch)
        return self.roi_head(batch, target_generator, skip_proposals=True)
