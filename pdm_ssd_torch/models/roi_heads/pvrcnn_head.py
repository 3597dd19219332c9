"""PV-RCNN's ROI head: keypoint grid pooling and refinement (counterpart of
`pdm_ssd_tpu/models/roi_heads/pvrcnn_head.py`).

Each ROI spawns a GRID_SIZE^3 lattice of grid points in its frame. Up to
POOL_MAX_KEYPOINTS keypoints a ROI are preselected from the ROI enlarged by
twice the largest pool radius (`pool_roi_points`). Each radius branch then
takes, for every grid point, the first NSAMPLE preselected keypoints within
its radius, in the preselection's slot order: one exact first-K ball query
over all branches with the B * R ROIs as the batch, the P preselected
keypoints as the points and the grid points as the centres
(`dispatch.ball_query_level`), then a row gather of their offsets and of
their features projected by `pre_feat_<i>` (`dispatch.grouping_operation`,
whose backward is the row scatter-add). The JAX package computes the same
selection with triangular bf16 matmuls and extracts it with one-hot matmuls
of bf16 values; the port keeps the extracted offsets and features in
float32 (a known deviation, ROADMAP Queue 3). An empty ball extracts zeros,
as the one-hot does. Then `pre_xyz_<i>`, BatchNorm, ReLU, the rest of the
branch's MLP, the max over the samples, and the shared, class and box FC
stacks over the flattened grid.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops import box_ops, dispatch
from ..layers import BatchNormLast, FCStack, SharedMLP
from ..model_nms import take_rows
from .pointrcnn_head import pool_roi_points
from .roi_head_template import RoIHeadTemplate


def dense_grid_points(rois: torch.Tensor, grid_size: int) -> torch.Tensor:
    """(B, R, 7) -> (B, R, G^3, 3): the centres of the G^3 cells of each ROI,
    in the global frame; cell (i, j, k) is lattice point i * G^2 + j * G + k."""
    B, R = rois.shape[:2]
    g = grid_size
    idx = np.stack(np.meshgrid(np.arange(g), np.arange(g), np.arange(g), indexing='ij'),
                   -1).reshape(-1, 3)
    unit = (torch.as_tensor(idx, dtype=torch.float32, device=rois.device) + 0.5) / g - 0.5
    local = unit[None, None] * rois[:, :, None, 3:6]                       # (B, R, G3, 3)
    G3 = g ** 3
    rot = box_ops.rotate_points_along_z(local.reshape(B * R, G3, 3),
                                        rois[..., 6].reshape(B * R)).reshape(B, R, G3, 3)
    return rot + rois[:, :, None, :3]


class PVRCNNHead(RoIHeadTemplate):
    """Config: GRID_SIZE, POOL_MAX_KEYPOINTS, ROI_GRID_POOL {POOL_RADIUS,
    NSAMPLE, MLPS}, SHARED_FC, CLS_FC, REG_FC, NMS_CONFIG, TARGET_CONFIG,
    LOSS_CONFIG. `input_channels` is the keypoints' feature width."""

    def __init__(self, model_cfg, num_class: int, input_channels: int, device=None):
        super().__init__(model_cfg, num_class)
        cfg = self.model_cfg
        pool = cfg.ROI_GRID_POOL
        self.grid = int(cfg.get('GRID_SIZE', 6))
        self.max_keypoints = int(cfg.get('POOL_MAX_KEYPOINTS', 64))
        self.radii = [float(r) for r in pool.POOL_RADIUS]
        self.nsamples = [int(n) for n in pool.NSAMPLE]
        mlps = [list(m) for m in pool.MLPS]
        self.h1 = [int(m[0]) for m in mlps]
        self.rest = [list(m[1:]) for m in mlps]
        for i, h in enumerate(self.h1):
            self.add_module(f'pre_feat_{i}', nn.Linear(input_channels, h, bias=False,
                                                       device=device))
            self.add_module(f'pre_xyz_{i}', nn.Linear(3, h, bias=False, device=device))
            self.add_module(f'bn0_{i}', BatchNormLast(h, eps=1e-5, momentum=0.1, device=device))
            if self.rest[i]:
                self.add_module(f'mlp_rest_{i}', SharedMLP(h, self.rest[i], device=device))
        width = self.grid ** 3 * sum(int(m[-1]) for m in mlps)
        shared = list(cfg.get('SHARED_FC', [256, 256]))
        self.shared_fc = SharedMLP(width, shared, device=device)
        self.cls_fc = FCStack(shared[-1], tuple(cfg.get('CLS_FC', [256, 256])), 1, device=device)
        self.reg_fc = FCStack(shared[-1], tuple(cfg.get('REG_FC', [256, 256])), 7, device=device)

    def grid_select(self, batch: dict, rois: torch.Tensor) -> tuple:
        """The grid pool's selection: the preselected keypoints' slots (B, R,
        P) and validity, their xyz (B * R, P, 3), the grid points (B * R,
        G^3, 3), and for each branch the (B * R, G^3, K) indices into the
        P slots and the (B * R, G^3) mask of empty balls."""
        kp = batch['point_coords']                                         # (B, Nk, 3)
        B, R = rois.shape[:2]
        P, G3 = self.max_keypoints, self.grid ** 3
        idx, valid = pool_roi_points(kp, rois, P, extra=2.0 * max(self.radii),
                                     roi_mask=batch.get('roi_mask'))
        sel_xyz = take_rows(kp, idx.reshape(B, R * P).long()).reshape(B * R, P, 3)
        grid = dense_grid_points(rois, self.grid).reshape(B * R, G3, 3)
        valid_flat = valid.reshape(B * R, P)
        gidx = dispatch.ball_query_level(self.radii, self.nsamples, sel_xyz, grid,
                                         mask=valid_flat)
        empties = []
        for r, gi in zip(self.radii, gidx):
            # a ball is empty where its first sample (point 0 then) is no hit
            first = gi[..., 0].long()
            d = torch.gather(sel_xyz, 1, first[..., None].expand(-1, -1, 3)) - grid
            d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
            hit = (d2 < float(np.float32(r * r))) & torch.gather(valid_flat, 1, first)
            empties.append(~hit)
        return idx, valid, sel_xyz, grid, gidx, empties

    def group_branch(self, sel_xyz, grid, pre, gi, empty) -> tuple:
        """The offsets (B * R, G^3, K, 3) of one branch's samples from their
        grid points and their projected features (B * R, G^3, K, H), zero in
        an empty ball."""
        rel = dispatch.grouping_operation(sel_xyz, gi) - grid[:, :, None, :]
        gfeat = dispatch.grouping_operation(pre, gi)
        live = ~empty[..., None, None]
        return torch.where(live, rel, 0.0), torch.where(live, gfeat, 0.0)

    def forward(self, batch: dict, target_generator: torch.Generator | None = None,
                skip_proposals: bool = False) -> dict:
        """In training with ground truth in the batch, the head predicts on the
        subsampled, reordered ROIs of `assign_targets` (drawn from
        `target_generator`), whose targets it adds as 'roi_targets'. With
        `skip_proposals` (PV-RCNN++, which draws its proposals and targets
        before the keypoints) it takes the batch's ROIs as they are."""
        if not skip_proposals:
            batch = self.proposal_layer(batch)
            if self.training and 'gt_boxes' in batch:
                batch['roi_targets'] = self.assign_targets(batch, target_generator)
        rois = batch['rois']                                               # (B, R, 7)
        B, R = rois.shape[:2]
        P, G3 = self.max_keypoints, self.grid ** 3
        idx, valid, sel_xyz, grid, gidx, empties = self.grid_select(batch, rois)
        kf = batch['point_features']                                       # (B, Nk, C)
        sel_feat = take_rows(kf, idx.reshape(B, R * P).long()).reshape(B, R, P, -1)
        sel_feat = torch.where(valid[..., None], sel_feat, 0.0)
        branches = []
        for i, (gi, empty) in enumerate(zip(gidx, empties)):
            # pre_feat is linear without a bias: applied before the gather, as
            # in the JAX package, it moves H instead of C channels a sample
            pre = getattr(self, f'pre_feat_{i}')(sel_feat).reshape(B * R, P, self.h1[i])
            rel, gfeat = self.group_branch(sel_xyz, grid, pre, gi, empty)
            h = torch.relu(getattr(self, f'bn0_{i}')(gfeat + getattr(self, f'pre_xyz_{i}')(rel)))
            if self.rest[i]:
                h = getattr(self, f'mlp_rest_{i}')(h)
            branches.append(h.amax(dim=2))                                 # (B * R, G3, C')
        pooled = torch.cat(branches, dim=-1)
        x = self.shared_fc(pooled.reshape(B, R, G3 * pooled.shape[-1]))
        batch['rcnn_cls_preds'] = self.cls_fc(x)                           # (B, R, 1)
        batch['rcnn_reg_preds'] = self.reg_fc(x)                           # (B, R, 7)
        return batch
