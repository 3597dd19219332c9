"""Anchor-based dense head (counterpart of
`pdm_ssd_tpu/models/dense_heads/anchor_head.py`): `generate_anchors`, the
forward of `AnchorHeadSingle`, its box decode with the direction classifier,
the axis-aligned target assignment over `nearest_bev_iou` and the losses.
The ATSS assigner and `AnchorHeadMulti` are not ported (ROADMAP Queue 1
item 9).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...ops import losses
from ...ops.box_ops import limit_period
from ...ops.coders import ResidualCoder
from ...utils.config import as_cfg


def generate_anchors(anchor_cfg_list, grid_size, point_cloud_range):
    """Anchors (A, 7) float32 ordered [class][y][x][size][rot] and each class's
    (start, end) slice. grid_size: (W, H) of the feature map.

    By default positions span the range endpoint-inclusive with stride
    (max - min) / (n - 1); `align_center: True` puts them at cell centers with
    stride (max - min) / n."""
    W, H = grid_size
    x0, y0 = point_cloud_range[0], point_cloud_range[1]
    x1, y1 = point_cloud_range[3], point_cloud_range[4]
    all_anchors = []
    class_slices = []
    ofs = 0
    for cfg in anchor_cfg_list:
        sizes = np.array(cfg['anchor_sizes'], np.float32)        # (S, 3)
        rots = np.array(cfg['anchor_rotations'], np.float32)     # (R,)
        heights = np.array(cfg['anchor_bottom_heights'], np.float32)
        if cfg.get('align_center', False):
            stride_x = (x1 - x0) / W
            stride_y = (y1 - y0) / H
            xs = x0 + (np.arange(W) + 0.5) * stride_x
            ys = y0 + (np.arange(H) + 0.5) * stride_y
        else:
            stride_x = (x1 - x0) / max(W - 1, 1)
            stride_y = (y1 - y0) / max(H - 1, 1)
            xs = np.arange(x0, x1 + 1e-5, stride_x, dtype=np.float32)[:W]
            ys = np.arange(y0, y1 + 1e-5, stride_y, dtype=np.float32)[:H]
        gy, gx = np.meshgrid(ys, xs, indexing='ij')              # (H, W)
        S, R = len(sizes), len(rots)
        a = np.zeros((H * W, S, R, 7), np.float32)
        a[..., 0] = gx.reshape(-1, 1, 1)
        a[..., 1] = gy.reshape(-1, 1, 1)
        a[..., 2] = heights[0] + sizes[None, :, None, 2] / 2.0   # center z
        a[..., 3:6] = sizes[None, :, None, :]
        a[..., 6] = rots[None, None, :]
        a = a.reshape(-1, 7)
        all_anchors.append(a)
        class_slices.append((ofs, ofs + len(a)))
        ofs += len(a)
    return np.concatenate(all_anchors, axis=0), class_slices


def nearest_bev_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Axis-aligned BEV IoU after snapping each heading to the nearest axis.
    boxes_a (..., N, 7), boxes_b (..., M, 7) -> (..., N, M), the leading axes
    broadcast. The JAX package's order of operations, so that ties (which
    the force-match compares with ==) fall alike."""
    def to_bev(b):
        rot = limit_period(b[..., 6], 0.5, math.pi).abs()
        swap = rot > math.pi / 4
        dx = torch.where(swap, b[..., 4], b[..., 3])
        dy = torch.where(swap, b[..., 3], b[..., 4])
        return torch.stack([b[..., 0] - dx / 2, b[..., 1] - dy / 2,
                            b[..., 0] + dx / 2, b[..., 1] + dy / 2], dim=-1)

    a = to_bev(boxes_a)[..., :, None, :]
    b = to_bev(boxes_b)[..., None, :, :]
    iw = torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0])
    ih = torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1])
    inter = iw.clamp(min=0) * ih.clamp(min=0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter).clamp(min=1e-6)


class AnchorHeadSingle(nn.Module):
    """Config as the JAX package's: ANCHOR_GENERATOR_CONFIG (a list, one entry
    per class, with its matched and unmatched IoU thresholds),
    TARGET_ASSIGNER_CONFIG, LOSS_CONFIG, USE_DIRECTION_CLASSIFIER,
    DIR_OFFSET, DIR_LIMIT_OFFSET, NUM_DIR_BINS. Takes 'spatial_features_2d'
    (B, H, W, C), channels last."""

    def __init__(self, model_cfg, input_channels: int, num_class: int, class_names, grid_size,
                 point_cloud_range, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        self.model_cfg = cfg
        self.num_class = num_class
        self.coder = ResidualCoder()
        gen_cfg = [c.to_dict() if hasattr(c, 'to_dict') else dict(c)
                   for c in cfg.ANCHOR_GENERATOR_CONFIG]
        # numpy, built once; `anchors` puts them on the device they are asked for
        self.anchors_np, self.class_slices = generate_anchors(gen_cfg, tuple(grid_size),
                                                              tuple(point_cloud_range))
        self._anchors = {}
        self.n_cls_groups = len(gen_cfg)
        # each anchor's class (1-based) and IoU thresholds, by its class block
        A = len(self.anchors_np)
        self.anchor_rule_np = np.zeros((3, A), np.float32)
        for ci, (s0, s1) in enumerate(self.class_slices):
            self.anchor_rule_np[:, s0:s1] = np.array(
                [[ci + 1], [gen_cfg[ci].get('matched_threshold', 0.6)],
                 [gen_cfg[ci].get('unmatched_threshold', 0.45)]], np.float32)
        na = sum(len(c['anchor_sizes']) * len(c['anchor_rotations']) for c in gen_cfg)
        self.num_anchors_per_location = na
        self.num_dir_bins = cfg.get('NUM_DIR_BINS', 2)
        self.conv_cls = nn.Conv2d(input_channels, na * num_class, 1, device=device)
        self.conv_cls.bias_init = -math.log((1 - 0.01) / 0.01)
        self.conv_box = nn.Conv2d(input_channels, na * self.coder.code_size, 1, device=device)
        self.conv_dir_cls = None
        if cfg.get('USE_DIRECTION_CLASSIFIER', True):
            self.conv_dir_cls = nn.Conv2d(input_channels, na * self.num_dir_bins, 1,
                                          device=device)

    def anchors(self, device) -> torch.Tensor:
        """(A, 7) float32 on `device`."""
        device = torch.device(device)
        if device not in self._anchors:
            self._anchors[device] = torch.from_numpy(self.anchors_np).to(device)
        return self._anchors[device]

    def _anchor_major(self, t: torch.Tensor, ch: int) -> torch.Tensor:
        """Conv output (B, groups * rot * ch, H, W), channels ordered
        [class][rot][ch] -> (B, A, ch) with anchors ordered [class][y][x][rot]."""
        B, _, H, W = t.shape
        n_rot = self.num_anchors_per_location // self.n_cls_groups
        t = t.reshape(B, self.n_cls_groups, n_rot, ch, H, W)
        return t.permute(0, 1, 4, 5, 2, 3).reshape(B, -1, ch)

    def forward(self, batch: dict) -> dict:
        x = batch['spatial_features_2d'].permute(0, 3, 1, 2)      # NHWC -> NCHW
        cls_preds, box_preds = self.conv_cls(x), self.conv_box(x)
        batch['anchor_cls_preds'] = self._anchor_major(cls_preds, self.num_class)
        batch['anchor_box_preds'] = self._anchor_major(box_preds, self.coder.code_size)
        # the raw conv maps, channels last as the JAX package returns them
        batch['anchor_cls_preds_map'] = cls_preds.permute(0, 2, 3, 1)
        batch['anchor_box_preds_map'] = box_preds.permute(0, 2, 3, 1)
        if self.conv_dir_cls is not None:
            dir_preds = self.conv_dir_cls(x)
            batch['anchor_dir_preds'] = self._anchor_major(dir_preds, self.num_dir_bins)
            batch['anchor_dir_preds_map'] = dir_preds.permute(0, 2, 3, 1)
        return batch

    @torch.no_grad()
    def assign_targets(self, batch: dict) -> dict:
        """`AxisAlignedTargetAssigner` over the whole anchor grid: per-class
        thresholds by anchor block, gts of other classes ignored, and every
        anchor that ties a gt's largest IoU (above 0) forced positive. Reads
        'gt_boxes' (B, M, 8), class last, and 'gt_mask' (B, M). Returns
        'anchor_cls_labels' (B, A) int64 (class, 0 background, -1 ignored),
        'anchor_box_targets' (B, A, 7) and 'anchor_dir_targets' (B, A)."""
        cfg = self.model_cfg
        if cfg.TARGET_ASSIGNER_CONFIG.get('NAME') == 'ATSSTargetAssigner':
            raise NotImplementedError('the ATSS target assigner is not ported yet (ROADMAP '
                                      'Queue 1 item 9, the pillar family)')
        gts, gmask = batch['gt_boxes'], batch['gt_mask']
        anchors = self.anchors(gts.device)
        rule = torch.from_numpy(self.anchor_rule_np).to(gts.device)
        anchor_cls, matched_t, unmatched_t = rule[0].long(), rule[1], rule[2]
        iou = nearest_bev_iou(anchors, gts[..., :7])                     # (B, A, M)
        gt_cls = gts[..., -1].long()
        same_class = anchor_cls[None, :, None] == gt_cls[:, None, :]
        iou = torch.where(same_class & gmask[:, None, :], iou, -1.0)
        best_gt_iou, best_gt = iou.max(dim=2).values, iou.argmax(dim=2)
        gt_max = iou.max(dim=1).values                                   # (B, M)
        force = ((iou == gt_max[:, None, :]) & (iou > 0)).any(dim=2)
        pos = (best_gt_iou >= matched_t) | force
        neg = (best_gt_iou < unmatched_t) & ~pos
        labels = torch.where(pos, gt_cls.gather(1, best_gt),
                             torch.where(neg, 0, -1))
        tgt = gts.gather(1, best_gt[..., None].expand(-1, -1, gts.shape[-1]))[..., :7]
        box_targets = torch.where(pos[..., None], self.coder.encode(tgt, anchors[None]), 0.0)
        dir_offset = cfg.get('DIR_OFFSET', 0.78539)
        offset_rot = limit_period(tgt[..., 6] - dir_offset, 0, 2 * math.pi)
        dir_targets = (offset_rot / (2 * math.pi / self.num_dir_bins)).to(torch.int64) \
            .clamp(0, self.num_dir_bins - 1)
        return {'anchor_cls_labels': labels, 'anchor_box_targets': box_targets,
                'anchor_dir_targets': dir_targets}

    def get_loss(self, batch: dict, targets: dict) -> tuple:
        """Focal classification loss normalised by positives per cloud, the
        sin-difference smooth L1 box loss and the direction cross-entropy,
        each summed over the batch and divided by B. Returns (total, tb) with
        'anchor_cls_loss', 'anchor_loc_loss' and 'anchor_dir_loss'."""
        lw = self.model_cfg.LOSS_CONFIG.LOSS_WEIGHTS
        labels = targets['anchor_cls_labels']
        B = labels.shape[0]
        pos, neg = labels > 0, labels == 0
        pos_norm = pos.sum(dim=1, keepdim=True).to(torch.float32).clamp(min=1.0)
        cls_w = (pos | neg).to(torch.float32) / pos_norm
        one_hot = torch.nn.functional.one_hot(labels.clamp(min=0), self.num_class + 1)[..., 1:]
        cls_loss = losses.sigmoid_focal_loss(batch['anchor_cls_preds'],
                                             one_hot.to(torch.float32), cls_w).sum() \
            / B * lw['cls_weight']

        box_preds, box_tgt = batch['anchor_box_preds'], targets['anchor_box_targets']
        # the sin-difference on the heading channel
        sin_diff = torch.sin(box_preds[..., 6:7]) * torch.cos(box_tgt[..., 6:7])
        cos_diff = torch.cos(box_preds[..., 6:7]) * torch.sin(box_tgt[..., 6:7])
        bp = torch.cat([box_preds[..., :6], sin_diff, box_preds[..., 7:]], dim=-1)
        bt = torch.cat([box_tgt[..., :6], cos_diff, box_tgt[..., 7:]], dim=-1)
        reg_w = pos.to(torch.float32) / pos_norm
        loc_loss = losses.weighted_smooth_l1(bp, bt, reg_w,
                                             code_weights=lw.get('code_weights')).sum() \
            / B * lw['loc_weight']
        total = cls_loss + loc_loss
        tb = {'anchor_cls_loss': cls_loss, 'anchor_loc_loss': loc_loss}
        if 'anchor_dir_preds' in batch:
            dir_oh = torch.nn.functional.one_hot(targets['anchor_dir_targets'],
                                                 self.num_dir_bins).to(torch.float32)
            dir_loss = losses.weighted_cross_entropy(batch['anchor_dir_preds'], dir_oh,
                                                     reg_w).sum() / B * lw['dir_weight']
            total = total + dir_loss
            tb['anchor_dir_loss'] = dir_loss
        return total, tb

    def generate_predicted_boxes(self, batch: dict):
        """(cls_preds (B, A, nc), boxes (B, A, 7)): the residuals decoded
        against the anchors, the heading snapped into the predicted
        direction bin."""
        cfg = self.model_cfg
        box_preds = batch['anchor_box_preds']
        boxes = self.coder.decode(box_preds, self.anchors(box_preds.device)[None])
        if 'anchor_dir_preds' in batch:
            dir_offset = cfg.get('DIR_OFFSET', 0.78539)
            period = 2 * math.pi / self.num_dir_bins
            dir_labels = torch.argmax(batch['anchor_dir_preds'], dim=-1)
            rot = limit_period(boxes[..., 6] - dir_offset, cfg.get('DIR_LIMIT_OFFSET', 0.0), period)
            rot = rot + dir_offset + period * dir_labels.to(boxes.dtype)
            boxes = torch.cat([boxes[..., :6], rot[..., None], boxes[..., 7:]], dim=-1)
        return batch['anchor_cls_preds'], boxes
