"""Anchor-based dense head (counterpart of
`pdm_ssd_tpu/models/dense_heads/anchor_head.py`): `generate_anchors`, the
forward of `AnchorHeadSingle`, its box decode with the direction classifier,
the axis-aligned and the ATSS target assignment over `nearest_bev_iou`, the
losses, and `AnchorHeadMulti` (a shared trunk, one head per class group).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...ops import losses
from ...ops.box_ops import limit_period
from ...ops.coders import ResidualCoder
from ...parallel import ddp
from ...utils.config import as_cfg
from ..layers import BatchNorm2d


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
        gen_cfg = self._setup(model_cfg, num_class, grid_size, point_cloud_range)
        cfg = self.model_cfg
        self.n_cls_groups = len(gen_cfg)
        na = sum(len(c['anchor_sizes']) * len(c['anchor_rotations']) for c in gen_cfg)
        self.num_anchors_per_location = na
        self.conv_cls = nn.Conv2d(input_channels, na * num_class, 1, device=device)
        self.conv_cls.bias_init = -math.log((1 - 0.01) / 0.01)
        self.conv_box = nn.Conv2d(input_channels, na * self.coder.code_size, 1, device=device)
        self.conv_dir_cls = None
        if cfg.get('USE_DIRECTION_CLASSIFIER', True):
            self.conv_dir_cls = nn.Conv2d(input_channels, na * self.num_dir_bins, 1,
                                          device=device)

    def _setup(self, model_cfg, num_class: int, grid_size, point_cloud_range) -> list:
        """Config, coder and anchors; returns the anchor generator's list."""
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
        # each anchor's class (1-based) and IoU thresholds, by its class block
        self.anchor_rule_np = np.zeros((3, len(self.anchors_np)), np.float32)
        for ci, (s0, s1) in enumerate(self.class_slices):
            self.anchor_rule_np[:, s0:s1] = np.array(
                [[ci + 1], [gen_cfg[ci].get('matched_threshold', 0.6)],
                 [gen_cfg[ci].get('unmatched_threshold', 0.45)]], np.float32)
        self.num_dir_bins = cfg.get('NUM_DIR_BINS', 2)
        return gen_cfg

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
        gts, gmask = batch['gt_boxes'], batch['gt_mask']
        anchors = self.anchors(gts.device)
        tcfg = cfg.TARGET_ASSIGNER_CONFIG
        if tcfg.get('NAME') == 'ATSSTargetAssigner':
            labels, tgt, pos = atss_assign(anchors, gts, gmask, int(tcfg.get('TOPK', 9)))
            return self._targets(labels, tgt[..., :7], pos, anchors)
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
        return self._targets(labels, tgt, pos, anchors)

    def _targets(self, labels, tgt, pos, anchors) -> dict:
        """The target dict from labels, each anchor's gt box (B, A, 7) and
        its positives: box residuals where positive, direction bins."""
        box_targets = torch.where(pos[..., None], self.coder.encode(tgt, anchors[None]), 0.0)
        dir_offset = self.model_cfg.get('DIR_OFFSET', 0.78539)
        offset_rot = limit_period(tgt[..., 6] - dir_offset, 0, 2 * math.pi)
        dir_targets = (offset_rot / (2 * math.pi / self.num_dir_bins)).to(torch.int64) \
            .clamp(0, self.num_dir_bins - 1)
        return {'anchor_cls_labels': labels, 'anchor_box_targets': box_targets,
                'anchor_dir_targets': dir_targets}

    def get_loss(self, batch: dict, targets: dict) -> tuple:
        """Focal classification loss normalised by positives per cloud, the
        sin-difference smooth L1 box loss and the direction cross-entropy,
        each summed over the batch and divided by B, the global batch's
        clouds. Returns (total, tb) with 'anchor_cls_loss', 'anchor_loc_loss'
        and 'anchor_dir_loss'."""
        lw = self.model_cfg.LOSS_CONFIG.LOSS_WEIGHTS
        labels = targets['anchor_cls_labels']
        B = ddp.global_count(labels.shape[0], labels.device)
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


class AnchorHeadMulti(AnchorHeadSingle):
    """A shared 3x3 Conv + BN + ReLU trunk (`shared_conv`, `shared_bn`,
    SHARED_CONV_NUM_FILTER wide), then per RPN_HEAD_CFGS group 1x1 convs
    `head<g>_cls` / `_box` / `_dir` for its classes' anchors. The outputs are
    assembled in the global anchor-major layout of `AnchorHeadSingle` with
    the logits of the classes foreign to an anchor's head at -10, so the
    assigners, losses and decode are `AnchorHeadSingle`'s. As in the JAX
    package, a class's anchors are ordered [rotation][y][x] here, while
    `generate_anchors` orders them [y][x][rotation]."""

    def __init__(self, model_cfg, input_channels: int, num_class: int, class_names, grid_size,
                 point_cloud_range, device=None):
        nn.Module.__init__(self)
        gen_cfg = self._setup(model_cfg, num_class, grid_size, point_cloud_range)
        cfg = self.model_cfg
        self.use_dir = cfg.get('USE_DIRECTION_CLASSIFIER', True)
        self.cls_names = [c['class_name'] for c in gen_cfg]
        self.n_rot = [len(c['anchor_sizes']) * len(c['anchor_rotations']) for c in gen_cfg]
        self.groups = [list(hc['HEAD_CLS_NAME']) for hc in cfg.RPN_HEAD_CFGS]
        shared = cfg.get('SHARED_CONV_NUM_FILTER', 64)
        self.shared_conv = nn.Conv2d(input_channels, shared, 3, padding=1, bias=False,
                                     device=device)
        self.shared_bn = BatchNorm2d(shared, eps=1e-3, momentum=0.01, device=device)
        code = self.coder.code_size
        for gi, group in enumerate(self.groups):
            n_loc = sum(self.n_rot[self.cls_names.index(n)] for n in group)
            conv_cls = nn.Conv2d(shared, n_loc * len(group), 1, device=device)
            conv_cls.bias_init = -math.log((1 - 0.01) / 0.01)
            self.add_module(f'head{gi}_cls', conv_cls)
            self.add_module(f'head{gi}_box', nn.Conv2d(shared, n_loc * code, 1, device=device))
            if self.use_dir:
                self.add_module(f'head{gi}_dir', nn.Conv2d(shared, n_loc * self.num_dir_bins, 1,
                                                           device=device))

    def forward(self, batch: dict) -> dict:
        x = batch['spatial_features_2d'].permute(0, 3, 1, 2)      # NHWC -> NCHW
        h = torch.relu(self.shared_bn(self.shared_conv(x)))
        B, _, H, W = h.shape
        code, nd = self.coder.code_size, self.num_dir_bins
        per_class = {}
        for gi, group in enumerate(self.groups):
            n_loc = sum(self.n_rot[self.cls_names.index(n)] for n in group)
            gcls = getattr(self, f'head{gi}_cls')(h).reshape(B, n_loc, len(group), H, W)
            gbox = getattr(self, f'head{gi}_box')(h).reshape(B, n_loc, code, H, W)
            gdir = (getattr(self, f'head{gi}_dir')(h).reshape(B, n_loc, nd, H, W)
                    if self.use_dir else None)
            off = 0
            for ln, name in enumerate(group):
                sl = slice(off, off + self.n_rot[self.cls_names.index(name)])
                per_class[name] = (gcls[:, sl, ln], gbox[:, sl],
                                   gdir[:, sl] if gdir is not None else None)
                off = sl.stop
        cls_out, box_out, dir_out = [], [], []
        for ci, name in enumerate(self.cls_names):
            logit, box, dirp = per_class[name]                   # (B, nr, H, W), (B, nr, c, H, W)
            full = torch.full((*logit.shape, self.num_class), -10.0, dtype=logit.dtype,
                              device=logit.device)
            full[..., ci] = logit
            cls_out.append(full.reshape(B, -1, self.num_class))
            box_out.append(box.permute(0, 1, 3, 4, 2).reshape(B, -1, code))
            if dirp is not None:
                dir_out.append(dirp.permute(0, 1, 3, 4, 2).reshape(B, -1, nd))
        batch['anchor_cls_preds'] = torch.cat(cls_out, dim=1)
        batch['anchor_box_preds'] = torch.cat(box_out, dim=1)
        if self.use_dir:
            batch['anchor_dir_preds'] = torch.cat(dir_out, dim=1)
        return batch


@torch.no_grad()
def atss_assign(anchors: torch.Tensor, gts: torch.Tensor, gmask: torch.Tensor, topk: int):
    """ATSS target assignment, batched (`atss_assign_single` of the JAX
    package): per gt the `topk` anchors nearest its center are candidates
    (ties to the lower anchor index); a candidate is positive where its IoU
    reaches the mean plus the deviation of its gt's candidate IoUs and its
    center lies inside the gt's BEV rectangle; an anchor claimed by several
    gts keeps the one of highest IoU; every valid gt also forces its best
    anchor. anchors (A, 7), gts (B, M, 8) class last, gmask (B, M). Returns
    (labels (B, A), each anchor's gt (B, A, 8), positives (B, A))."""
    B, M = gmask.shape
    A = anchors.shape[0]
    iou = nearest_bev_iou(anchors, gts[..., :7])                          # (B, A, M)
    iou = torch.where(gmask[:, None, :], iou, -1.0)
    d = anchors[None, :, None, :3] - gts[:, None, :, :3]
    dist = torch.sqrt((d * d).sum(-1))
    dist = torch.where(gmask[:, None, :], dist, torch.inf).transpose(1, 2)  # (B, M, A)
    cand = torch.sort(dist, dim=-1, stable=True).indices[..., :topk]      # (B, M, K)
    cand_iou = iou.transpose(1, 2).gather(2, cand)
    mean = cand_iou.mean(dim=2, keepdim=True)
    std = cand_iou.std(dim=2, correction=0, keepdim=True)
    is_pos = cand_iou >= mean + std + 1e-6
    local = anchors[cand][..., :3] - gts[:, :, None, :3]                 # (B, M, K, 3)
    c, s = torch.cos(-gts[..., 6])[..., None], torch.sin(-gts[..., 6])[..., None]
    lx = local[..., 0] * c - local[..., 1] * s
    ly = local[..., 0] * s + local[..., 1] * c
    in_gt = (lx.abs() <= gts[..., 3:4] / 2) & (ly.abs() <= gts[..., 4:5] / 2)
    is_pos = is_pos & in_gt & gmask[..., None]
    # the candidates of one gt are distinct anchors: a plain scatter
    claimed = torch.full((B, M, A), -torch.inf, dtype=iou.dtype, device=iou.device)
    claimed.scatter_(2, cand, torch.where(is_pos, cand_iou, -torch.inf))
    best_iou, best_gt = claimed.max(dim=1)                              # (B, A)
    gt_best_anchor = iou.argmax(dim=1)                                  # (B, M)
    zeros = torch.zeros((B, A), dtype=torch.long, device=iou.device)
    force = zeros.scatter_reduce(1, gt_best_anchor, gmask.long(), 'amax') > 0
    m_ids = torch.arange(M, device=iou.device).expand(B, M)
    forced_gt = zeros.scatter_reduce(1, gt_best_anchor, torch.where(gmask, m_ids, 0), 'amax')
    pos = (best_iou > -torch.inf) | force
    gt_idx = torch.where(force & (best_iou <= -torch.inf), forced_gt, best_gt)
    gt_of_anchor = gts.gather(1, gt_idx[..., None].expand(-1, -1, gts.shape[-1]))
    labels = torch.where(pos, gt_of_anchor[..., 7].long(), 0)
    return labels, gt_of_anchor, pos
