"""Voxel R-CNN's ROI head: voxel-neighbourhood grid pooling and refinement
(counterpart of `pdm_ssd_tpu/models/roi_heads/voxelrcnn_head.py`).

Each ROI spawns a GRID_SIZE^3 lattice; every grid point pools the 3x3x3
window of voxel cells around it at each stage that FEATURES_SOURCE names
(`VoxelNeighborAgg` on the dense ladder's volumes, `SparseVoxelNeighborAgg`
on the sparse ladder's slot tables), then the shared, class and box FC
stacks run over the flattened grid.
"""
from __future__ import annotations

import torch

from ..backbones_3d.pfe import SparseVoxelNeighborAgg, VoxelNeighborAgg, sparse_stage_dims
from ..layers import FCStack, SharedMLP
from .pvrcnn_head import dense_grid_points
from .roi_head_template import RoIHeadTemplate


class VoxelRCNNHead(RoIHeadTemplate):
    """Config: GRID_SIZE, ROI_GRID_POOL {FEATURES_SOURCE, MLPS per source},
    SHARED_FC, CLS_FC, REG_FC, NMS_CONFIG, TARGET_CONFIG, LOSS_CONFIG.
    `stage_widths` maps each 'x_conv<k>' to its channels, `sparse` says
    which ladder they come from."""

    def __init__(self, model_cfg, num_class: int, voxel_size, point_cloud_range,
                 stage_widths: dict, sparse: bool, device=None):
        super().__init__(model_cfg, num_class)
        cfg = self.model_cfg
        pool = cfg.ROI_GRID_POOL
        self.grid = int(cfg.get('GRID_SIZE', 6))
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.pc_range = tuple(float(v) for v in point_cloud_range)
        self.sparse = sparse
        self.sources = list(pool.FEATURES_SOURCE)
        agg_cls = SparseVoxelNeighborAgg if sparse else VoxelNeighborAgg
        width = 0
        for src in self.sources:
            mlp = [int(c) for c in pool[src].MLPS]
            self.add_module(f'agg_{src}', agg_cls(stage_widths[src], mlp, voxel_size,
                                                  point_cloud_range, device=device))
            width += mlp[-1]
        shared = list(cfg.get('SHARED_FC', [256, 256]))
        self.shared_fc = SharedMLP(self.grid ** 3 * width, shared, device=device)
        self.cls_fc = FCStack(shared[-1], tuple(cfg.get('CLS_FC', [256, 256])), 1, device=device)
        self.reg_fc = FCStack(shared[-1], tuple(cfg.get('REG_FC', [256, 256])), 7, device=device)

    def forward(self, batch: dict, target_generator: torch.Generator | None = None) -> dict:
        """In training with ground truth in the batch, the head predicts on the
        subsampled, reordered ROIs of `assign_targets` (drawn from
        `target_generator`), whose targets it adds as 'roi_targets'."""
        batch = self.proposal_layer(batch)
        if self.training and 'gt_boxes' in batch:
            batch['roi_targets'] = self.assign_targets(batch, target_generator)
        rois = batch['rois']
        B, R = rois.shape[:2]
        G3 = self.grid ** 3
        grid = dense_grid_points(rois, self.grid).reshape(B, R * G3, 3)
        feats = []
        for src in self.sources:
            agg = getattr(self, f'agg_{src}')
            if self.sparse:
                f, co, mk, stride = batch['multi_scale_3d_features_sparse'][src]
                feats.append(agg(f, co, mk, grid, int(stride),
                                 sparse_stage_dims(self.pc_range, self.voxel_size, stride)))
            else:
                vol, occ, stride = batch['multi_scale_3d_features'][src]
                feats.append(agg(vol, occ, grid, int(stride)))
        pooled = torch.cat(feats, dim=-1)                                  # (B, R * G3, SC)
        x = self.shared_fc(pooled.reshape(B, R, G3 * pooled.shape[-1]))
        batch['rcnn_cls_preds'] = self.cls_fc(x)
        batch['rcnn_reg_preds'] = self.reg_fc(x)
        return batch
