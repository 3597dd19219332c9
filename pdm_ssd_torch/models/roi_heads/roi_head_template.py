"""Two-stage ROI refinement template with fixed-size outputs (counterpart of
`pdm_ssd_tpu/models/roi_heads/roi_head_template.py`): the proposal layer,
the proposal targets, the ROI losses and the decode of canonical residuals.

The targets are the JAX package's fixed-shape `ProposalTargetLayer`: exactly
ROI_PER_IMAGE ROIs a cloud, min(round(FG_RATIO * ROI_PER_IMAGE), n_fg)
foregrounds, the backgrounds split hard and easy by HARD_BG_RATIO, quotas
filled by ranks of one uniform draw per ROI slot, and a shortfall filled by
repeating the selected ROIs from the first. The draw is one (B, R) uniform
tensor from a `torch.Generator`, as the JAX package draws one
`jax.random.uniform` of the ROI mask's shape; a batch may carry that tensor
itself as 'roi_target_rand'.

One deliberate difference: the corner loss. The JAX package decodes every
ROI slot and masks the per-ROI loss by a multiply, so a background slot whose
decoded box overflows gives inf * 0 = NaN. The port decodes the foreground
slots only (a background slot decodes a zero residual on its matched ground
truth) and selects with `torch.where`: the same value wherever the JAX one is
finite, and no NaN where it is not.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops import box_ops, iou3d, losses
from ...ops.coders import ResidualCoder
from ...parallel import ddp
from ...utils.config import as_cfg
from ..model_nms import take_rows


class RoIHeadTemplate(nn.Module):
    def __init__(self, model_cfg, num_class: int):
        super().__init__()
        self.model_cfg = as_cfg(model_cfg)
        self.num_class = num_class

    @torch.no_grad()
    def proposal_layer(self, batch: dict) -> dict:
        """Class-agnostic rotated NMS over the first stage's boxes into exactly
        NMS_POST_MAXSIZE slots and a validity mask. No gradient flows back
        into the first stage through the proposals. Adds 'rois' (B, R, 7),
        'roi_scores', 'roi_labels' (1-based, 0 where empty) and 'roi_mask'."""
        cfg = self.model_cfg.NMS_CONFIG['TRAIN' if self.training else 'TEST']
        boxes = batch['batch_box_preds']                        # (B, N, 7+)
        cls_preds = batch['batch_cls_preds']                    # (B, N, nc)
        scores = torch.sigmoid(cls_preds).amax(dim=-1)
        labels = torch.argmax(cls_preds, dim=-1) + 1
        idx, keep = iou3d.nms_bev(boxes[..., :7], scores, cfg.NMS_THRESH,
                                  pre_maxsize=cfg.NMS_PRE_MAXSIZE,
                                  post_maxsize=cfg.NMS_POST_MAXSIZE)
        batch['rois'] = take_rows(boxes, idx)[..., :7]
        batch['roi_scores'] = take_rows(scores, idx) * keep
        batch['roi_labels'] = take_rows(labels, idx) * keep
        batch['roi_mask'] = keep
        return batch

    @torch.no_grad()
    def assign_targets(self, batch: dict, generator: torch.Generator | None = None) -> dict:
        """Subsample and reorder the ROIs against the ground truth ('gt_boxes'
        (B, M, 8), 'gt_mask'): ROI_PER_IMAGE slots a cloud, selected ROIs in
        the random order of the draw, then repeated from the first. The draw
        is 'roi_target_rand' of the batch when it holds one, else one (B, R)
        uniform tensor from `generator` (a generator seeded with 0 when None).
        Rewrites the batch's 'rois', 'roi_mask', 'roi_scores' and
        'roi_labels' in the new order and returns the targets: 'rois',
        'roi_mask', 'gt_of_roi' (B, R', 8), 'rcnn_cls_labels' (-1 where
        ignored), 'rcnn_reg_targets' (canonical residuals), 'reg_valid_mask'
        and 'roi_ious'."""
        cfg = self.model_cfg.TARGET_CONFIG
        rois, roi_mask = batch['rois'], batch['roi_mask']        # (B, R, 7), (B, R)
        gts, gt_mask = batch['gt_boxes'], batch['gt_mask']       # (B, M, 8), (B, M)
        B, R = roi_mask.shape
        dev = rois.device
        rand = batch.get('roi_target_rand')
        if rand is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            # under data parallelism the global batch's draw, this rank's rows
            rand = ddp.rank_rows(torch.rand, B, R, generator=generator, device=dev)
        rand = rand.to(device=dev, dtype=torch.float32)

        roi_per_image = int(cfg.get('ROI_PER_IMAGE', R))
        fg_ratio = cfg.get('FG_RATIO', 0.5)
        hard_bg_ratio = cfg.get('HARD_BG_RATIO', 0.8)
        cls_fg = cfg.get('CLS_FG_THRESH', 0.6)
        cls_bg = cfg.get('CLS_BG_THRESH', 0.45)
        reg_fg = cfg.get('REG_FG_THRESH', 0.55)
        bg_lo = cfg.get('CLS_BG_THRESH_LO', 0.1)
        fg_thresh = min(reg_fg, cls_fg)
        score_type = cfg.get('CLS_SCORE_TYPE', 'cls')

        iou = iou3d.boxes_iou3d(rois, gts[..., :7])               # (B, R, M)
        iou = torch.where(gt_mask[:, None, :] & roi_mask[:, :, None], iou, -1.0)
        gt_idx = torch.argmax(iou, dim=2)                         # the first of equal maxima
        max_iou = torch.where(roi_mask, iou.amax(dim=2).clamp(min=0.0), -1.0)

        fg = (max_iou >= fg_thresh) & roi_mask
        hard = (max_iou < reg_fg) & (max_iou >= bg_lo) & roi_mask
        easy = (max_iou < bg_lo) & (max_iou >= 0) & roi_mask
        n_fg, n_hard, n_easy = (m.sum(dim=1) for m in (fg, hard, easy))
        fg_quota = n_fg.clamp(max=int(np.round(fg_ratio * roi_per_image)))
        bg_quota = roi_per_image - fg_quota
        # the hard share when both pools are there, else the one pool takes it all
        hard_want = torch.where(n_easy > 0, (bg_quota.float() * hard_bg_ratio).to(torch.int64),
                                bg_quota)
        hard_quota = torch.minimum(torch.where(n_hard > 0, hard_want, 0), n_hard)
        easy_quota = torch.minimum(bg_quota - hard_quota, n_easy)

        def rank_in_group(member):
            """0-based rank of each member in the draw's order; the others after."""
            order = torch.argsort(torch.where(member, rand, 2.0 + rand), dim=1, stable=True)
            rank = torch.empty_like(order)
            rank.scatter_(1, order, torch.arange(R, device=dev).expand(B, R))
            return rank

        sel = ((fg & (rank_in_group(fg) < fg_quota[:, None]))
               | (hard & (rank_in_group(hard) < hard_quota[:, None]))
               | (easy & (rank_in_group(easy) < easy_quota[:, None])))
        n_sel = sel.sum(dim=1)
        order = torch.argsort(torch.where(sel, rand, 2.0 + rand), dim=1, stable=True)
        slots = torch.arange(roi_per_image, device=dev)[None, :] % n_sel.clamp(min=1)[:, None]
        order = torch.gather(order, 1, slots)                     # (B, R')
        out_valid = torch.gather(sel, 1, order)

        gt_of_roi = take_rows(take_rows(gts, gt_idx), order)      # (B, R', 8)
        if score_type == 'roi_iou':
            cls_label = ((max_iou - cls_bg) / max(cls_fg - cls_bg, 1e-6)).clamp(0.0, 1.0)
        elif score_type == 'raw_roi_iou':
            cls_label = max_iou.clamp(0.0, 1.0)
        else:
            cls_label = torch.where(max_iou > cls_fg, 1.0, torch.where(max_iou < cls_bg, 0.0, -1.0))
        reg_fg_mask = (max_iou >= reg_fg) & roi_mask
        rois = take_rows(rois, order)
        max_iou = torch.gather(max_iou, 1, order)
        cls_label = torch.gather(cls_label, 1, order)
        reg_fg_mask = torch.gather(reg_fg_mask, 1, order)

        # canonical-frame regression targets: the ground truth in the ROI's frame
        Bo, Ro = order.shape
        shift = box_ops.rotate_points_along_z(
            (gt_of_roi[..., :3] - rois[..., :3]).reshape(Bo * Ro, 1, 3),
            -rois[..., 6].reshape(Bo * Ro)).reshape(Bo, Ro, 3)
        heading = box_ops.limit_period(gt_of_roi[..., 6] - rois[..., 6], offset=0.5,
                                       period=2 * np.pi)
        canonical_gt = torch.cat([shift, gt_of_roi[..., 3:6], heading[..., None]], dim=-1)
        reg_targets = ResidualCoder().encode(canonical_gt, self._canonical_roi(rois))

        batch['rois'] = rois
        batch['roi_mask'] = out_valid
        for key in ('roi_scores', 'roi_labels'):
            if key in batch:
                batch[key] = torch.gather(batch[key], 1, order)
        return {'rois': rois, 'roi_mask': out_valid, 'gt_of_roi': gt_of_roi,
                'rcnn_cls_labels': cls_label, 'rcnn_reg_targets': reg_targets,
                'reg_valid_mask': reg_fg_mask & out_valid, 'roi_ious': max_iou}

    def get_loss(self, batch: dict, targets: dict) -> tuple:
        """The ROI losses of a forward's 'rcnn_cls_preds' and 'rcnn_reg_preds'
        against `assign_targets`' targets: BCE over the labels that are not
        ignored, smooth L1 over the foreground residuals, and with
        CORNER_LOSS_REGULARIZATION the corner loss of the decoded foreground
        boxes, each over its count in the global batch. Returns (loss, tb)."""
        cfg = self.model_cfg.LOSS_CONFIG
        lw = cfg.LOSS_WEIGHTS
        cls_preds = batch['rcnn_cls_preds'][..., 0]               # (B, R)
        cls_labels = targets['rcnn_cls_labels']
        care = (cls_labels >= 0).to(cls_preds.dtype)
        bce = losses.sigmoid_bce_with_logits(cls_preds, cls_labels.clamp(0, 1))
        cls_loss = (bce * care).sum() / ddp.global_sum(care.sum()).clamp(min=1.0) \
            * lw['rcnn_cls_weight']

        reg_preds = batch['rcnn_reg_preds']                       # (B, R, 7)
        reg_mask = targets['reg_valid_mask']
        reg = losses.weighted_smooth_l1(reg_preds, targets['rcnn_reg_targets'],
                                        reg_mask.to(reg_preds.dtype),
                                        code_weights=lw.get('code_weights'))
        n_reg = ddp.global_sum(reg_mask.sum().to(reg_preds.dtype)).clamp(min=1.0)
        reg_loss = reg.sum() / n_reg * lw['rcnn_reg_weight']
        total = cls_loss + reg_loss
        tb = {'rcnn_cls_loss': cls_loss, 'rcnn_reg_loss': reg_loss}
        if cfg.get('CORNER_LOSS_REGULARIZATION', False):
            # a background slot decodes a zero residual on its matched ground
            # truth: its box is finite whatever the head predicts there
            fg = reg_mask[..., None]
            gt = targets['gt_of_roi'][..., :7]
            boxes, _ = self.generate_predicted_boxes(
                torch.where(fg, targets['rois'], gt), batch['rcnn_cls_preds'],
                torch.where(fg, reg_preds, 0.0))
            B, R = reg_mask.shape
            per_roi = losses.corner_loss_lidar(boxes.reshape(B * R, 7),
                                               gt.reshape(B * R, 7)).reshape(B, R)
            corner = torch.where(reg_mask, per_roi, 0.0).sum() / n_reg
            corner = corner * lw.get('rcnn_corner_weight', 1.0)
            total = total + corner
            tb['rcnn_corner_loss'] = corner
        return total, tb

    @staticmethod
    def _canonical_roi(rois: torch.Tensor) -> torch.Tensor:
        """The ROI as its own anchor: at the origin, heading 0, its sizes."""
        zeros = torch.zeros_like(rois[..., :3])
        return torch.cat([zeros, rois[..., 3:6], zeros[..., :1]], dim=-1)

    def generate_predicted_boxes(self, rois, rcnn_cls, rcnn_reg):
        """Decode canonical residuals back to the global frame: rois (B, R, 7),
        rcnn_cls (B, R, 1), rcnn_reg (B, R, 7) -> boxes (B, R, 7), scores (B, R)."""
        B, R = rois.shape[:2]
        local = ResidualCoder().decode(rcnn_reg, self._canonical_roi(rois))
        center = box_ops.rotate_points_along_z(
            local[..., :3].reshape(B * R, 1, 3),
            rois[..., 6].reshape(B * R)).reshape(B, R, 3) + rois[..., :3]
        heading = local[..., 6] + rois[..., 6]
        boxes = torch.cat([center, local[..., 3:6], heading[..., None]], dim=-1)
        return boxes, torch.sigmoid(rcnn_cls[..., 0])
