"""SECOND-IoU's ROI head (counterpart of
`pdm_ssd_tpu/models/roi_heads/second_head.py`): a rotated GRID_SIZE^2
lattice of each ROI sampled bilinearly from the BEV map, shared FC layers
and one IoU logit a ROI, which rectifies the first stage's score at
post-processing (`detectors/second_iou.py`). Training regresses the logit to
the ROI's IoU with its ground truth.

The crop reads the BEV map and the ROIs without their gradients, as the JAX
package's `stop_gradient` does: the head trains its own layers only.
"""
from __future__ import annotations

import torch

from ..layers import FCStack, SharedMLP
from .roi_head_template import RoIHeadTemplate


def rotated_bev_crop(bev: torch.Tensor, rois: torch.Tensor, grid_size: int, pc_range,
                     voxel_size, downsample: float) -> torch.Tensor:
    """bev (B, H, W, C), rois (B, R, 7) -> (B, R, G, G, C): the bilinear
    samples of each ROI's rotated G x G lattice (cell centres of the ROI's
    BEV footprint; lattice axis 0 along the box's x), four corner gathers of
    the flattened map with the lower corner clipped into it."""
    B, H, W, C = bev.shape
    R = rois.shape[1]
    G = int(grid_size)
    u = (torch.arange(G, dtype=torch.float32, device=bev.device) + 0.5) / G - 0.5
    gx, gy = torch.meshgrid(u, u, indexing='ij')                        # (G, G)
    lx = gx[None, None] * rois[:, :, None, None, 3]
    ly = gy[None, None] * rois[:, :, None, None, 4]
    c = torch.cos(rois[..., 6])[..., None, None]
    s = torch.sin(rois[..., 6])[..., None, None]
    wx = lx * c - ly * s + rois[:, :, None, None, 0]
    wy = lx * s + ly * c + rois[:, :, None, None, 1]
    fx = (wx - pc_range[0]) / (voxel_size[0] * downsample) - 0.5
    fy = (wy - pc_range[1]) / (voxel_size[1] * downsample) - 0.5
    x0 = torch.floor(fx).to(torch.int64).clamp(0, W - 2)
    y0 = torch.floor(fy).to(torch.int64).clamp(0, H - 2)
    ax = (fx - x0).clamp(0.0, 1.0)[..., None]
    ay = (fy - y0).clamp(0.0, 1.0)[..., None]
    flat = bev.reshape(B, H * W, C)

    def corner(dy, dx):
        idx = ((y0 + dy) * W + (x0 + dx)).reshape(B, R * G * G, 1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(B, R, G, G, C)

    return (corner(0, 0) * (1 - ax) * (1 - ay) + corner(0, 1) * ax * (1 - ay)
            + corner(1, 0) * (1 - ax) * ay + corner(1, 1) * ax * ay)


class SECONDHead(RoIHeadTemplate):
    """Config: ROI_GRID_POOL {GRID_SIZE, DOWNSAMPLE_RATIO}, SHARED_FC,
    IOU_FC, NMS_CONFIG, TARGET_CONFIG, LOSS_CONFIG {IOU_LOSS, LOSS_WEIGHTS}.
    `input_channels` is the BEV map's width."""

    def __init__(self, model_cfg, num_class: int, input_channels: int, voxel_size,
                 point_cloud_range, device=None):
        super().__init__(model_cfg, num_class)
        cfg = self.model_cfg
        pool = cfg.ROI_GRID_POOL
        self.grid = int(pool.get('GRID_SIZE', 7))
        self.downsample = float(pool.get('DOWNSAMPLE_RATIO', 8))
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.pc_range = tuple(float(v) for v in point_cloud_range)
        shared = list(cfg.get('SHARED_FC', [256, 256]))
        self.shared_fc = SharedMLP(self.grid ** 2 * input_channels, shared, device=device)
        self.iou_fc = FCStack(shared[-1], tuple(cfg.get('IOU_FC', [256])), 1, device=device)

    def forward(self, batch: dict, target_generator: torch.Generator | None = None) -> dict:
        """Adds 'rcnn_iou_preds' (B, R, 1); in training with ground truth,
        the ROIs of `assign_targets` and their 'roi_targets'."""
        batch = self.proposal_layer(batch)
        if self.training and 'gt_boxes' in batch:
            batch['roi_targets'] = self.assign_targets(batch, target_generator)
        rois = batch['rois']
        B, R = rois.shape[:2]
        crop = rotated_bev_crop(batch['spatial_features_2d'].detach(), rois.detach(), self.grid,
                                self.pc_range, self.voxel_size, self.downsample)
        batch['rcnn_iou_preds'] = self.iou_fc(self.shared_fc(crop.reshape(B, R, -1)))
        return batch

    def get_loss(self, batch: dict, targets: dict) -> tuple:
        """The IoU loss over the ROIs whose label is not ignored: binary cross
        entropy of the sigmoid (clipped to [1e-6, 1 - 1e-6]), L2, or smooth
        L1 (beta 1/9) of the logit against the label, by IOU_LOSS."""
        cfg = self.model_cfg.LOSS_CONFIG
        pred = batch['rcnn_iou_preds'][..., 0].reshape(-1)
        labels = targets['rcnn_cls_labels'].reshape(-1)
        valid = (labels >= 0).to(pred.dtype)
        kind = cfg.get('IOU_LOSS', 'BinaryCrossEntropy')
        if kind == 'BinaryCrossEntropy':
            p = torch.sigmoid(pred).clamp(1e-6, 1 - 1e-6)
            per = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))
        elif kind == 'L2':
            per = (pred - labels) ** 2
        else:
            d = (pred - labels).abs()
            beta = 1.0 / 9.0
            per = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
        loss = (per * valid).sum() / valid.sum().clamp(min=1.0)
        loss = loss * cfg.get('LOSS_WEIGHTS', {}).get('rcnn_iou_weight', 1.0)
        return loss, {'rcnn_loss_iou': loss}
