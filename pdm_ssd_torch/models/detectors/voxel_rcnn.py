"""Voxel R-CNN (counterpart of `pdm_ssd_tpu/models/detectors/voxel_rcnn.py`):
PV-RCNN's first stage, losses and post-processing with no keypoints and no
point head, and `VoxelRCNNHead`, which pools the ladder's voxels around each
ROI's grid points."""
from __future__ import annotations

import torch

from ..backbones_3d.pfe import is_sparse_ladder, stage_channels
from ..roi_heads.voxelrcnn_head import VoxelRCNNHead
from .detector3d import _grid_info
from .pv_rcnn import PVRCNN


class VoxelRCNN(PVRCNN):
    DATA_PARALLEL_HELD = ('SparseVoxelBackBone8x', 'SparseVoxelResBackBone8x')

    def _build_second_stage(self, cfg, ds, device) -> None:
        """No keypoints and no point head; `roi_head` pools the ladder's
        stages."""
        _, voxel = _grid_info(ds)
        self.pfe = None
        self.point_head = None
        self.roi_head = VoxelRCNNHead(cfg.ROI_HEAD, self.num_class, voxel,
                                      tuple(ds.POINT_CLOUD_RANGE),
                                      stage_channels(cfg.BACKBONE_3D),
                                      is_sparse_ladder(cfg.BACKBONE_3D), device=device)

    def forward(self, batch: dict, target_generator: torch.Generator | None = None) -> dict:
        """`target_generator` draws the ROI head's target sampling in training."""
        return self.roi_head(self.first_stage(batch), target_generator)
