"""PDM-SSD detector (counterpart of `pdm_ssd_tpu/models/detectors/pdm_ssd.py`):
point or grid backbone -> point head (vote boxes, or the train-only
auxiliary head) -> PDM neck (point or grid form) -> BEV convs -> heatmap
head, then hybrid post-processing with fixed-size outputs and, with
POST_PROCESSING.TTA_FLIP, flip test-time augmentation."""
from __future__ import annotations

import copy
import math

import torch
from torch import nn

from ...ops import iou3d
from ...ops.selection import topk
from ...utils.config import as_cfg
from .. import model_nms
from ..backbones_2d.base_bev_backbone import BaseBEVBackbone
from ..backbones_2d.pdm_neck import PDMNeck
from ..backbones_2d.pdm_neck_conv import PDMNeckConv
from ..backbones_3d.grid_point_backbone import GridPointBackbone
from ..backbones_3d.pointnet2_backbone import PointNet2MSG
from ..dense_heads.center_head import CenterHead
from ..dense_heads.point_head_box import PointHeadBox
from ..dense_heads.point_head_simple import PointHeadSimple
from ..model_nms import take_rows


class PDMSSD(nn.Module):
    DATA_PARALLEL_HELD = True      # on every backbone (`parallel.ddp.check_held`)

    def __init__(self, model_cfg, num_class: int, dataset_cfg, class_names=None, device=None):
        super().__init__()
        cfg = as_cfg(copy.deepcopy(model_cfg))
        ds_cfg = as_cfg(dataset_cfg)
        self.model_cfg = cfg
        self.num_class = num_class
        pc_range = list(ds_cfg.POINT_CLOUD_RANGE)
        n_feat = ds_cfg.get('NUM_POINT_FEATURES', 4)
        if cfg.BACKBONE_3D.get('NAME', 'PointNet2MSG') == 'GridPointBackbone':
            self.backbone_3d = GridPointBackbone(cfg.BACKBONE_3D, n_feat, pc_range, device=device)
        else:
            self.backbone_3d = PointNet2MSG(cfg.BACKBONE_3D, n_feat, pc_range, device=device)
        self.point_head = None
        if cfg.get('POINT_HEAD') is not None:
            head_cls = {'PointHeadBox': PointHeadBox,
                        'PointHeadSimple': PointHeadSimple}[cfg.POINT_HEAD.NAME]
            n_cls = 1 if cfg.POINT_HEAD.get('CLASS_AGNOSTIC', False) else num_class
            self.point_head = head_cls(cfg.POINT_HEAD, self.backbone_3d.num_point_features,
                                       n_cls, device=device)
        self.pdm_neck = self.backbone_2d = self.dense_head = None
        if cfg.get('PDM_NECK') is not None:
            neck_cfg = cfg.PDM_NECK
            if 'POINT_CLOUD_RANGE' not in neck_cfg:
                neck_cfg['POINT_CLOUD_RANGE'] = pc_range
            neck_cls = PDMNeckConv if neck_cfg.get('NAME', 'PDMNeck') == 'PDMNeckConv' else PDMNeck
            self.pdm_neck = neck_cls(neck_cfg, self.backbone_3d.num_point_features, device=device)
            self.backbone_2d = BaseBEVBackbone(cfg.BACKBONE_2D, self.pdm_neck.num_bev_features,
                                               device=device)
            self.dense_head = CenterHead(
                cfg.DENSE_HEAD, self.backbone_2d.num_bev_features, num_class,
                grid_size=tuple(neck_cfg.BEV_SIZE), point_cloud_range=tuple(pc_range),
                voxel_size=tuple(neck_cfg.VOXEL_SIZE[:2]),
                class_names=tuple(class_names) if class_names else None, device=device)
        for axis in cfg.POST_PROCESSING.get('TTA_FLIP', []):
            if axis not in ('x', 'y'):
                raise ValueError(f"TTA_FLIP takes the axes 'x' and 'y', not {axis!r}")

    def forward(self, batch: dict) -> dict:
        batch = dict(batch)
        batch = self.backbone_3d(batch)
        if self.point_head is not None:
            batch = self.point_head(batch)
        if self.pdm_neck is not None:
            batch = self.pdm_neck(batch)
            batch = self.backbone_2d(batch)
            batch = self.dense_head(batch)
        return batch

    def get_training_loss(self, batch: dict) -> tuple:
        """Targets and losses of both heads on a forward's output. Returns
        (loss, tb) with every head's entries and 'loss' in `tb`."""
        tb = {}
        loss = torch.zeros((), dtype=torch.float32, device=batch['points'].device)
        if self.point_head is not None:
            head_loss, head_tb = self.point_head.get_loss(
                batch, self.point_head.assign_targets(batch))
            loss, tb = loss + head_loss, {**tb, **head_tb}
        if self.dense_head is not None:
            H, W = batch['spatial_features_2d'].shape[1:3]
            targets = self.dense_head.assign_targets(batch['gt_boxes'], batch['gt_mask'], (H, W))
            head_loss, head_tb = self.dense_head.get_loss(batch, targets)
            loss, tb = loss + head_loss, {**tb, **head_tb}
        tb['loss'] = loss
        return loss, tb

    def forward_with_loss(self, batch: dict, target_generator=None) -> tuple:
        """Forward, target assignment and losses: (loss, tb). BatchNorm uses
        batch statistics when the model is in training mode. The model draws
        no random targets: `target_generator` is taken and ignored."""
        return self.get_training_loss(self(batch))

    @torch.inference_mode()
    def predict(self, batch: dict) -> dict:
        """Forward + hybrid post-processing. The model must be in eval mode.

        With POST_PROCESSING.TTA_FLIP (e.g. ['y']) the model also runs on the
        cloud mirrored along each listed axis, mirrors those detections back
        (y: heading -> -heading; x: heading -> pi - heading), and one
        class-agnostic rotated NMS (`nms_bev`, whatever NMS_TYPE says, as in
        the JAX package) merges all the variants."""
        if self.training:
            raise RuntimeError('predict needs eval mode (call model.eval())')
        pp = self.model_cfg.POST_PROCESSING
        det = self.post_process(self(batch))
        flips = list(pp.get('TTA_FLIP', []))
        if not flips:
            return det
        dets = [det]
        for axis in flips:
            col = 0 if axis == 'x' else 1
            pts = batch['points'].clone()
            pts[..., col] *= -1.0
            fdet = self.post_process(self({**batch, 'points': pts}))
            boxes = fdet['pred_boxes'].clone()
            boxes[..., col] *= -1.0
            boxes[..., 6] = -boxes[..., 6] if axis == 'y' else math.pi - boxes[..., 6]
            dets.append({**fdet, 'pred_boxes': boxes})
        boxes, scores, labels, valid = (torch.cat([d[k] for d in dets], dim=1) for k in
                                        ('pred_boxes', 'pred_scores', 'pred_labels', 'pred_mask'))
        nms_cfg = pp.NMS_CONFIG
        idx, keep = iou3d.nms_bev(boxes, scores, nms_cfg.NMS_THRESH,
                                  pre_maxsize=nms_cfg.NMS_PRE_MAXSIZE,
                                  post_maxsize=nms_cfg.NMS_POST_MAXSIZE, valid=valid)
        return {'pred_boxes': take_rows(boxes, idx), 'pred_scores': take_rows(scores, idx) * keep,
                'pred_labels': take_rows(labels, idx) * keep, 'pred_mask': keep}

    def post_process(self, batch: dict) -> dict:
        """Heatmap boxes with scores calibrated by the best vote score within
        CALIBRATION_RADIUS, plus the top VOTE_TOPK vote boxes, through the
        NMS of NMS_TYPE (`model_nms.dispatch_nms`; `class_specific_nms` also
        gates each class at SCORE_THRESH). Returns (B, P, 7) boxes and (B,
        P) scores, labels (1-based) and mask."""
        pp = self.model_cfg.POST_PROCESSING
        cands = []
        if self.dense_head is not None:
            hm = self.dense_head.generate_predicted_boxes(batch)
            hm_boxes, hm_scores = hm['pred_boxes'], hm['pred_scores']
            hm_labels, hm_mask = hm['pred_labels'] + 1, hm['pred_mask']
            if self.point_head is not None and pp.get('SCORE_CALIBRATION', True):
                pts = batch['point_coords']                     # (B, N, 3)
                vote_scores = batch['point_cls_scores']         # (B, N)
                d2 = ((hm_boxes[:, :, None, :2] - pts[:, None, :, :2]) ** 2).sum(dim=-1)
                radius = pp.get('CALIBRATION_RADIUS', 1.0)
                near = d2 < radius * radius
                best_vote = torch.where(near, vote_scores[:, None, :], 0.0).amax(dim=-1)
                alpha = pp.get('CALIBRATION_ALPHA', 0.5)
                hm_scores = hm_scores ** (1 - alpha) * torch.maximum(best_vote, hm_scores) ** alpha
            cands.append((hm_boxes, hm_scores, hm_labels, hm_mask))

        if getattr(self.point_head, 'box_coder', None) is not None \
                and pp.get('USE_VOTE_BOXES', True) and 'point_box_preds' in batch:
            cls_preds, boxes = self.point_head.generate_predicted_boxes(
                batch['point_coords'], batch['point_cls_preds'], batch['point_box_preds'])
            scores = torch.sigmoid(cls_preds.amax(dim=-1))
            labels = torch.argmax(cls_preds, dim=-1) + 1
            K = min(pp.get('VOTE_TOPK', 256), scores.shape[1])
            top_scores, top_idx = topk(scores, K)
            cands.append((take_rows(boxes, top_idx), top_scores, take_rows(labels, top_idx),
                          torch.ones_like(top_scores, dtype=torch.bool)))

        boxes = torch.cat([c[0][..., :7] for c in cands], dim=1)
        scores = torch.cat([c[1] for c in cands], dim=1)
        labels = torch.cat([c[2] for c in cands], dim=1)
        valid = torch.cat([c[3] for c in cands], dim=1)
        thresh = pp.get('SCORE_THRESH', 0.1)
        valid = valid & (scores > thresh)
        per_class = pp.NMS_CONFIG.get('NMS_TYPE', 'nms_bev') == 'class_specific_nms'
        fb, fs, fl, fm = model_nms.dispatch_nms(boxes, scores, labels, valid, pp.NMS_CONFIG,
                                                self.num_class,
                                                score_thresh=thresh if per_class else None)
        return {'pred_boxes': fb, 'pred_scores': fs, 'pred_labels': fl, 'pred_mask': fm}
