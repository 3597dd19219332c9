"""Anchor-based dense head (counterpart of
`pdm_ssd_tpu/models/dense_heads/anchor_head.py`): `generate_anchors`, the
forward of `AnchorHeadSingle` and its box decode with the direction
classifier. The serving path; target assignment and the losses are not
ported yet.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

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


class AnchorHeadSingle(nn.Module):
    """Config as the JAX package's: ANCHOR_GENERATOR_CONFIG (a list, one entry
    per class), USE_DIRECTION_CLASSIFIER, DIR_OFFSET, DIR_LIMIT_OFFSET,
    NUM_DIR_BINS. Takes 'spatial_features_2d' (B, H, W, C), channels last."""

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

    def assign_targets(self, batch: dict):
        raise NotImplementedError('AnchorHeadSingle.assign_targets is not ported yet '
                                  '(ROADMAP Queue 1 item 6, SECOND training)')

    def get_loss(self, batch: dict, targets: dict):
        raise NotImplementedError('AnchorHeadSingle.get_loss is not ported yet '
                                  '(ROADMAP Queue 1 item 6, SECOND training)')

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
