"""TransFusion head (counterpart of
`pdm_ssd_tpu/models/dense_heads/transfusion_head.py`): a class heatmap
proposes NUM_PROPOSALS query cells (`two_stage_topk` over the map), each
query starts from its cell's BEV feature, the position encoding and its
class's embedding, then one decoder layer (self-attention among the queries,
cross-attention to every BEV token, an FFN) and five prediction branches.

Decode takes no NMS. Training matches ground truth to queries exactly: the
reference's cost (focal class cost 0.15, normalized BEV-center L1 0.25,
-IoU3D 0.25, `hungarian_assigner.py:63-118`) solved by the host's
Jonker-Volgenant (`ops/lap.lap_host`, as the JAX package's `pure_callback`
and the reference's `.cpu()` detour) or the auction (`LAP_BACKEND:
auction`), then the matched L1, the focal classification and the auxiliary
heatmap loss. Maps are NHWC at the boundaries.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops import centernet, iou3d, losses
from ...ops.lap import auction_lap, lap_host
from ...ops.selection import two_stage_topk
from ...utils.config import as_cfg
from ..layers import BatchNorm2d, LayerNorm, MultiHeadAttention

BRANCHES = ('center', 'height', 'dim', 'rot', 'cls')


def _pos_encoding(H: int, W: int, C: int) -> np.ndarray:
    """Sinusoidal 2D position encoding (H, W, C): sin and cos of y, then of
    x, C / 4 channels each, frequencies 10000^(-k / (C / 4 - 1))."""
    c4 = C // 4
    freq = np.exp(-np.log(10000.0) * np.arange(c4) / max(c4 - 1, 1))
    ys = np.arange(H)[:, None] * freq[None]
    xs = np.arange(W)[:, None] * freq[None]
    pe = np.zeros((H, W, C), np.float32)
    pe[..., 0:c4] = np.sin(ys)[:, None, :]
    pe[..., c4:2 * c4] = np.cos(ys)[:, None, :]
    pe[..., 2 * c4:3 * c4] = np.sin(xs)[None, :, :]
    pe[..., 3 * c4:4 * c4] = np.cos(xs)[None, :, :]
    return pe


class TransFusionHead(nn.Module):
    def __init__(self, model_cfg, input_channels: int, num_class: int, point_cloud_range,
                 voxel_size, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        self.cfg = cfg
        self.num_class = num_class
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(voxel_size)
        d = int(cfg.get('HIDDEN_CHANNEL', 128))
        self.num_proposals = int(cfg.get('NUM_PROPOSALS', 200))
        nh = int(cfg.get('NUM_HEADS', 4))
        self.shared = nn.Conv2d(input_channels, d, 3, padding=1, bias=False, device=device)
        self.shared_bn = BatchNorm2d(d, eps=1e-5, momentum=0.1, device=device)
        self.heatmap_conv = nn.Conv2d(d, num_class, 3, padding=1, device=device)
        self.heatmap_conv.bias_init = -2.19
        self.class_embed = nn.Embedding(num_class, d, device=device)
        self.ln_sa = LayerNorm(d, device=device)
        self.self_attn = MultiHeadAttention(d, d, nh, device=device)
        self.ln_ca = LayerNorm(d, device=device)
        self.cross_attn = MultiHeadAttention(d, d, nh, device=device)
        self.ln_ff = LayerNorm(d, device=device)
        self.ff1 = nn.Linear(d, 2 * d, device=device)
        self.ff2 = nn.Linear(2 * d, d, device=device)
        widths = {'center': 2, 'height': 1, 'dim': 3, 'rot': 2, 'cls': num_class}
        for name in BRANCHES:
            self.add_module(f'{name}_fc', nn.Linear(d, d, device=device))
            self.add_module(f'{name}_out', nn.Linear(d, widths[name], device=device))
        self._pe = {}           # (H, W, device, dtype) -> (H * W, d) encoding

    def pos_encoding(self, H: int, W: int, like: torch.Tensor) -> torch.Tensor:
        key = (H, W, like.device, like.dtype)
        if key not in self._pe:
            pe = _pos_encoding(H, W, self.ff2.out_features).reshape(H * W, -1)
            self._pe[key] = torch.from_numpy(pe).to(like.device, like.dtype)
        return self._pe[key]

    def forward(self, batch: dict) -> dict:
        x = batch['spatial_features_2d'].permute(0, 3, 1, 2)       # NHWC -> NCHW
        B, _, H, W = x.shape
        feat = torch.relu(self.shared_bn(self.shared(x)))            # (B, d, H, W)
        hm = self.heatmap_conv(feat).permute(0, 2, 3, 1)             # (B, H, W, nc)
        hm_sig = torch.sigmoid(hm)
        top_scores, top_idx = two_stage_topk(hm_sig.amax(dim=-1).reshape(B, H * W),
                                             self.num_proposals)     # (B, Q)
        cls_at = torch.gather(torch.argmax(hm_sig, dim=-1).reshape(B, H * W), 1, top_idx)
        tokens = feat.permute(0, 2, 3, 1).reshape(B, H * W, -1) + self.pos_encoding(H, W, feat)
        qfeat = losses.gather_feat(tokens, top_idx) + self.class_embed(cls_at)
        qfeat = qfeat + self.self_attn(self.ln_sa(qfeat))
        qfeat = qfeat + self.cross_attn(self.ln_ca(qfeat), tokens)
        qfeat = qfeat + self.ff2(torch.relu(self.ff1(self.ln_ff(qfeat))))
        batch['transfusion_preds'] = {
            name: getattr(self, f'{name}_out')(torch.relu(getattr(self, f'{name}_fc')(qfeat)))
            for name in BRANCHES}
        batch['transfusion_query'] = {'qx': (top_idx % W).to(x.dtype),
                                      'qy': (top_idx // W).to(x.dtype),
                                      'hm_score': top_scores, 'heatmap': hm}
        return batch

    def decode_boxes(self, batch: dict) -> tuple:
        """(boxes (B, Q, 7), scores, labels (0-based)): the center is the
        query's cell plus the predicted offset, the score the best class
        probability times the root of the query's heatmap score."""
        preds, q = batch['transfusion_preds'], batch['transfusion_query']
        stride = self.cfg.get('FEATURE_MAP_STRIDE', 8)
        xs = (q['qx'] + preds['center'][..., 0]) * stride * self.voxel_size[0] \
            + self.point_cloud_range[0]
        ys = (q['qy'] + preds['center'][..., 1]) * stride * self.voxel_size[1] \
            + self.point_cloud_range[1]
        dim = torch.exp(torch.clamp(preds['dim'], -5.0, 5.0))
        rot = torch.atan2(preds['rot'][..., 1], preds['rot'][..., 0])
        boxes = torch.cat([xs[..., None], ys[..., None], preds['height'], dim, rot[..., None]],
                          dim=-1)
        scores = (torch.sigmoid(preds['cls']).amax(dim=-1)
                  * torch.sqrt(torch.clamp(q['hm_score'], min=1e-6)))
        return boxes, scores, torch.argmax(preds['cls'], dim=-1)

    def generate_predicted_boxes(self, batch: dict) -> dict:
        boxes, scores, labels = self.decode_boxes(batch)
        thresh = self.cfg.get('POST_PROCESSING', {}).get('SCORE_THRESH', 0.0)
        return {'pred_boxes': boxes, 'pred_scores': scores, 'pred_labels': labels,
                'pred_mask': scores > thresh}

    def matching_cost(self, batch: dict) -> torch.Tensor:
        """(B, Q, M) cost of giving query q the ground-truth box m."""
        acfg = self.cfg.get('TARGET_ASSIGNER_CONFIG', None)
        w_cls = acfg.get('CLS_COST_WEIGHT', 0.15) if acfg else 0.15
        w_reg = acfg.get('REG_COST_WEIGHT', 0.25) if acfg else 0.25
        w_iou = acfg.get('IOU_COST_WEIGHT', 0.25) if acfg else 0.25
        alpha, gamma, eps = 0.25, 2.0, 1e-12
        boxes, _, _ = self.decode_boxes(batch)
        gt = batch['gt_boxes']                                        # (B, M, 8)
        B, Q = boxes.shape[:2]
        M = gt.shape[1]
        prob = torch.sigmoid(batch['transfusion_preds']['cls'])      # (B, Q, nc)
        neg_cost = -torch.log1p(-prob + eps) * (1 - alpha) * torch.pow(prob, gamma)
        pos_cost = -torch.log(prob + eps) * alpha * torch.pow(1 - prob, gamma)
        gt_cls = torch.clamp(gt[..., 7].to(torch.int64) - 1, 0, self.num_class - 1)
        cls_cost = torch.gather(pos_cost - neg_cost, 2, gt_cls[:, None, :].expand(B, Q, M))
        pc = torch.tensor(self.point_cloud_range, dtype=boxes.dtype, device=boxes.device)
        span = pc[3:5] - pc[0:2]
        nb = (boxes[..., :2] - pc[0:2]) / span
        ng = (gt[..., :2] - pc[0:2]) / span
        reg_cost = (nb[:, :, None] - ng[:, None, :]).abs().sum(dim=-1)
        iou = iou3d.boxes_iou3d(boxes[..., :7], gt[..., :7])
        return w_cls * cls_cost + w_reg * reg_cost - w_iou * iou

    @torch.no_grad()
    def assign_targets(self, batch: dict) -> dict:
        """{'q_of_gt': (B, M) int32}, the query matched to each valid
        ground-truth box (-1 for the masked ones), by the exact LAP of
        `matching_cost` with the boxes as bidders."""
        cost = self.matching_cost(batch).transpose(1, 2)              # (B, M, Q)
        gmask = batch['gt_mask']
        if self.cfg.get('LAP_BACKEND', 'host_jv') == 'auction':
            q_of_gt = torch.stack([auction_lap(c, bidder_mask=m) for c, m in zip(cost, gmask)])
        else:
            q_of_gt = lap_host(cost, gmask)
        return {'q_of_gt': q_of_gt}

    def get_loss(self, batch: dict, targets: dict) -> tuple:
        preds, q = batch['transfusion_preds'], batch['transfusion_query']
        gt = batch['gt_boxes']
        gmask = batch['gt_mask'] & (targets['q_of_gt'] >= 0)
        B, Q = q['qx'].shape
        qi = torch.clamp(targets['q_of_gt'], min=0).long()
        boxes, _, _ = self.decode_boxes(batch)
        matched = losses.gather_feat(boxes, qi)                       # (B, M, 7)
        dtheta = matched[..., 6] - gt[..., 6]
        reg_err = torch.cat([(matched[..., :6] - gt[..., :6]).abs(),
                             torch.atan2(torch.sin(dtheta), torch.cos(dtheta)).abs()[..., None]],
                            dim=-1)
        n_matched = torch.clamp(gmask.sum().to(boxes.dtype), min=1.0)
        reg_loss = torch.where(gmask[..., None], reg_err, 0.0).sum() / n_matched

        gt_cls = torch.clamp(gt[..., 7].to(torch.int64) - 1, 0, self.num_class - 1)
        onehot = (torch.nn.functional.one_hot(gt_cls, self.num_class).to(boxes.dtype)
                  * gmask[..., None])                                 # (B, M, nc)
        tgt = torch.zeros(B, Q, self.num_class, dtype=boxes.dtype, device=boxes.device)
        tgt = tgt.scatter_add(1, qi[..., None].expand_as(onehot), onehot).clamp(0.0, 1.0)
        w = torch.ones(B * Q, dtype=boxes.dtype, device=boxes.device) / n_matched
        cls_loss = losses.sigmoid_focal_loss(preds['cls'].reshape(B * Q, -1),
                                             tgt.reshape(B * Q, -1), w).sum()

        assigner = self.cfg.get('TARGET_ASSIGNER_CONFIG', None)
        hm_loss = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
        if assigner is not None:
            Hh, Wh = q['heatmap'].shape[1:3]
            hms = centernet.assign_center_targets(
                gt, batch['gt_mask'], num_classes=self.num_class, feature_map_size=(Wh, Hh),
                feature_map_stride=assigner.FEATURE_MAP_STRIDE, voxel_size=self.voxel_size,
                point_cloud_range=self.point_cloud_range,
                gaussian_overlap=assigner.GAUSSIAN_OVERLAP, min_radius=assigner.MIN_RADIUS)[0]
            hm_pred = torch.clamp(torch.sigmoid(q['heatmap']), 1e-4, 1 - 1e-4)
            hm_loss = losses.centernet_focal_loss(hm_pred.permute(0, 3, 1, 2), hms)
        total = cls_loss + reg_loss + hm_loss
        return total, {'tf_cls_loss': cls_loss, 'tf_reg_loss': reg_loss, 'tf_hm_loss': hm_loss}
