"""Part-A2's ROI head (counterpart of
`pdm_ssd_tpu/models/roi_heads/parta2_head.py`): each ROI's G^3 grid pooled
from the UNet's voxel points, the part features (part offsets gated by the
segmentation score, and the score) by the average and the UNet's features
by the maximum (`ops/roiaware.roiaware_pool`), a dense 3x3x3 conv stack on
each pooled grid, their concatenation through a stride-2 conv, and the
shared, class and box FC stacks over the flattened grid.

The convs run on (B * R, C, G, G, G) volumes (cuDNN), flattened channels
last as the JAX package flattens them.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops import roiaware
from ..layers import BatchNorm3d, FCStack, SharedMLP, conv_same
from .roi_head_template import RoIHeadTemplate


class PartA2FCHead(RoIHeadTemplate):
    """Config: ROI_AWARE_POOL {POOL_SIZE, NUM_FEATURES, MAX_POINTS},
    SEG_MASK_SCORE_THRESH, SHARED_FC, CLS_FC, REG_FC, NMS_CONFIG,
    TARGET_CONFIG, LOSS_CONFIG. `input_channels` is the UNet's point
    feature width. Layers: 'part_conv0' / 'part_bn0' (4 -> NUM_FEATURES),
    'rpn_conv0' / 'rpn_bn0' (input_channels -> NUM_FEATURES), 'down_conv' /
    'down_bn' (2 * NUM_FEATURES, stride 2), BatchNorm eps 1e-5."""

    def __init__(self, model_cfg, num_class: int, input_channels: int, device=None):
        super().__init__(model_cfg, num_class)
        cfg = self.model_cfg
        pool = cfg.ROI_AWARE_POOL
        self.grid = int(pool.get('POOL_SIZE', 12))
        self.max_points = int(pool.get('MAX_POINTS', 128))
        self.seg_thresh = float(cfg.get('SEG_MASK_SCORE_THRESH', 0.3))
        cp = int(pool.get('NUM_FEATURES', 16))

        self.part_conv0 = nn.Conv3d(4, cp, 3, bias=False, device=device)
        self.part_bn0 = BatchNorm3d(cp, eps=1e-5, momentum=0.1, device=device)
        self.rpn_conv0 = nn.Conv3d(input_channels, cp, 3, bias=False, device=device)
        self.rpn_bn0 = BatchNorm3d(cp, eps=1e-5, momentum=0.1, device=device)
        self.down_conv = nn.Conv3d(2 * cp, 2 * cp, 3, stride=2, bias=False, device=device)
        self.down_bn = BatchNorm3d(2 * cp, eps=1e-5, momentum=0.1, device=device)
        g = -(-self.grid // 2)
        shared = list(cfg.get('SHARED_FC', [256, 256]))
        self.shared_fc = SharedMLP(g ** 3 * 2 * cp, shared, device=device)
        self.cls_fc = FCStack(shared[-1], tuple(cfg.get('CLS_FC', [256, 256])), 1, device=device)
        self.reg_fc = FCStack(shared[-1], tuple(cfg.get('REG_FC', [256, 256])), 7, device=device)

    @staticmethod
    def _conv_bn_relu(conv: nn.Conv3d, bn: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(bn(conv_same(conv, x)))

    def pool(self, batch: dict, rois: torch.Tensor) -> tuple:
        """The pooled grids of the part features (average) and of the UNet's
        features (maximum): (B, R, G, G, G, 4) and (B, R, G, G, G, C)."""
        pts = batch['point_coords']
        seg = batch['point_cls_scores']
        part = torch.where((seg > self.seg_thresh)[..., None], batch['point_part_offset'], 0.0)
        part_feats = torch.cat([part, seg[..., None]], dim=-1)
        roi_mask = batch.get('roi_mask')
        G, P = self.grid, self.max_points
        pooled_part = roiaware.roiaware_pool(pts, part_feats, rois, G, 'avg', P, roi_mask)
        pooled_rpn = roiaware.roiaware_pool(pts, batch['point_features'], rois, G, 'max', P,
                                            roi_mask)
        return pooled_part, pooled_rpn

    def forward(self, batch: dict, target_generator: torch.Generator | None = None) -> dict:
        """In training with ground truth in the batch, the head predicts on
        the ROIs of `assign_targets` (drawn from `target_generator`)."""
        batch = self.proposal_layer(batch)
        if self.training and 'gt_boxes' in batch:
            batch['roi_targets'] = self.assign_targets(batch, target_generator)
        rois = batch['rois']
        B, R = rois.shape[:2]
        G = self.grid
        pooled_part, pooled_rpn = self.pool(batch, rois)

        def volume(x):                  # (B, R, G, G, G, C) -> (B * R, C, G, G, G)
            return x.reshape(B * R, G, G, G, -1).permute(0, 4, 1, 2, 3)

        xp = self._conv_bn_relu(self.part_conv0, self.part_bn0, volume(pooled_part))
        xr = self._conv_bn_relu(self.rpn_conv0, self.rpn_bn0, volume(pooled_rpn))
        x = self._conv_bn_relu(self.down_conv, self.down_bn, torch.cat([xp, xr], dim=1))
        x = self.shared_fc(x.permute(0, 2, 3, 4, 1).reshape(B, R, -1))
        batch['rcnn_cls_preds'] = self.cls_fc(x)                            # (B, R, 1)
        batch['rcnn_reg_preds'] = self.reg_fc(x)                            # (B, R, 7)
        return batch
