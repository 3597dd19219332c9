"""PointRCNN ROI refinement head with fixed shapes (counterpart of
`pdm_ssd_tpu/models/roi_heads/pointrcnn_head.py`).

ROI point pooling selects up to K backbone points inside each (enlarged)
ROI; the pooled points go into the ROI's frame and, with depth and score
channels, through a canonical PointNet that predicts one confidence and
seven box residuals per ROI. Both of the JAX package's architectures are
here, chosen by the config as there.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops import box_ops
from ..backbones_3d.pointnet2_backbone import SAModuleMSG
from ..layers import BatchNormLast, FCStack, SharedMLP, masked_max
from ..model_nms import take_rows
from .roi_head_template import RoIHeadTemplate


def _inside(points: torch.Tensor, boxes: torch.Tensor, margin: float) -> torch.Tensor:
    """points (B, N, 3), boxes (B, R, 7) -> (B, R, N) bool membership: z by
    `<=`, x and y in the box frame by `<` with `margin` added to the half size."""
    shift = points[:, None, :, :] - boxes[:, :, None, :3]       # (B, R, N, 3)
    cosa = torch.cos(-boxes[..., 6])[..., None]
    sina = torch.sin(-boxes[..., 6])[..., None]
    lx = shift[..., 0] * cosa - shift[..., 1] * sina
    ly = shift[..., 0] * sina + shift[..., 1] * cosa
    return ((shift[..., 2].abs() <= boxes[..., 5, None] / 2)
            & (lx.abs() < boxes[..., 3, None] / 2 + margin)
            & (ly.abs() < boxes[..., 4, None] / 2 + margin))


def pool_roi_points(points: torch.Tensor, rois: torch.Tensor, num_sampled: int,
                    extra: float = 0.0, roi_mask: torch.Tensor | None = None):
    """Up to K points inside each ROI, any K of them: the in-box points are
    ranked in point order and slot k keeps the last point whose rank is k
    modulo K. points (B, N, 3), rois (B, R, 7) -> idx (B, R, K) int32 and
    valid (B, R, K) bool; an invalid slot repeats slot 0 (index 0 in an
    empty ROI)."""
    B, N = points.shape[:2]
    K = num_sampled
    inside = _inside(points, box_ops.enlarge_box3d(rois, (extra, extra, extra)), 0.0)
    if roi_mask is not None:
        inside = inside & roi_mask[..., None]
    rank = torch.cumsum(inside.long(), dim=-1) - 1
    slot = torch.where(inside, rank % K, K)
    pos = torch.arange(N, device=points.device).expand_as(slot)
    idx = torch.full((B, rois.shape[1], K + 1), -1, dtype=torch.long, device=points.device)
    idx.scatter_reduce_(2, slot, pos, 'amax')
    idx = idx[..., :K]
    valid = idx >= 0
    idx = torch.where(valid, idx, idx[..., :1].clamp(min=0))
    return idx.to(torch.int32), valid


def pool_roi_points_ref(points: torch.Tensor, rois: torch.Tensor, num_sampled: int,
                        extra_width, roi_mask: torch.Tensor | None = None):
    """The first K in-box points of each enlarged ROI in point order (x and y
    with a margin of 1e-5); fewer hits are repeated cyclically; no hit sets
    the empty flag. Returns idx (B, R, K) int32 and empty (B, R) bool."""
    B, N = points.shape[:2]
    R, K = rois.shape[1], num_sampled
    inside = _inside(points, box_ops.enlarge_box3d(rois, tuple(extra_width)), 1e-5)
    if roi_mask is not None:
        inside = inside & roi_mask[..., None]
    w = inside.long()
    rank = torch.cumsum(w, dim=-1) - 1
    slot = torch.where(inside & (rank < K), rank, K)            # the first K ranks are unique
    idx0 = torch.zeros((B, R, K + 1), dtype=torch.long, device=points.device)
    idx0.scatter_(2, slot, torch.arange(N, device=points.device).expand_as(slot))
    cnt = w.sum(dim=-1).clamp(max=K)                            # (B, R)
    kmod = torch.arange(K, device=points.device) % cnt.clamp(min=1)[..., None]
    return torch.gather(idx0[..., :K], 2, kmod).to(torch.int32), cnt == 0


def _add_dense_stack(parent: nn.Module, name: str, in_channels: int, channels, use_bn: bool,
                     device=None) -> None:
    """Linear + (BatchNorm) + ReLU layers registered in `parent` as `<name>_i`
    and `<name>_bn_i`, the JAX package's names; biased where there is no
    BatchNorm."""
    c_in = in_channels
    for i, c in enumerate(channels):
        parent.add_module(f'{name}_{i}', nn.Linear(c_in, c, bias=not use_bn, device=device))
        if use_bn:
            parent.add_module(f'{name}_bn_{i}', BatchNormLast(c, eps=1e-5, momentum=0.1,
                                                              device=device))
        c_in = c


def _run_dense_stack(parent: nn.Module, name: str, x: torch.Tensor, n: int,
                     use_bn: bool) -> torch.Tensor:
    for i in range(n):
        x = getattr(parent, f'{name}_{i}')(x)
        if use_bn:
            x = getattr(parent, f'{name}_bn_{i}')(x)
        x = torch.relu(x)
    return x


class PointRCNNHead(RoIHeadTemplate):
    """Two architectures, chosen by the config:

    - with `SA_CONFIG`: exact ROI point pooling (first K, cyclic repeat),
      [canonical xyz, score, depth] -> `xyz_up` MLP, `merge_down` over
      [xyz features; point features], then a single-scale SA stack (FPS, ball
      query, shared MLP; a level with NPOINTS -1 groups all points) and the
      class and box stacks;
    - without it: any-K pooling, one shared MLP, a masked max, two FC stacks.

    `input_channels` is the width of the backbone's point features."""

    def __init__(self, model_cfg, num_class: int, input_channels: int, device=None):
        super().__init__(model_cfg, num_class)
        cfg = self.model_cfg
        up = list(cfg.get('XYZ_UP_LAYER', [128, 128]))
        self.canonical = 'SA_CONFIG' in cfg
        if not self.canonical:
            # canonical xyz, depth and score, then the point features
            self.up_mlp = SharedMLP(3 + 1 + 1 + input_channels, up, device=device)
            shared = list(cfg.get('SHARED_FC', [256, 256]))
            self.shared_fc = SharedMLP(up[-1], shared, device=device)
            self.cls_fc = FCStack(shared[-1], tuple(cfg.get('CLS_FC', [256])), 1, device=device)
            self.reg_fc = FCStack(shared[-1], tuple(cfg.get('REG_FC', [256])), 7, device=device)
            return
        self.use_bn = bool(cfg.get('USE_BN', False))
        self.n_up = len(up)
        _add_dense_stack(self, 'xyz_up', 5, up, self.use_bn, device)
        _add_dense_stack(self, 'merge_down', up[-1] + input_channels, [up[-1]], self.use_bn,
                           device)
        sa = cfg.SA_CONFIG
        self.sa_npoints = [int(n) for n in sa.NPOINTS]
        c_in = up[-1]
        for k, npoint in enumerate(self.sa_npoints):
            mlp = list(sa.MLPS[k])
            if npoint > 0:
                self.add_module(f'sa_{k}', SAModuleMSG(c_in, npoint, [sa.RADIUS[k]],
                                                       [sa.NSAMPLE[k]], [mlp], use_xyz=True,
                                                       device=device))
            else:
                self.add_module(f'sa_{k}_mlp_0', SharedMLP(3 + c_in, mlp, device=device))
            c_in = mlp[-1]
        self.cls_fc = FCStack(c_in, tuple(cfg.get('CLS_FC', [256, 256])), 1, device=device)
        self.reg_fc = FCStack(c_in, tuple(cfg.get('REG_FC', [256, 256])), 7, device=device)

    def forward(self, batch: dict, target_generator: torch.Generator | None = None) -> dict:
        """In training with ground truth in the batch, the head predicts on the
        subsampled, reordered ROIs of `assign_targets` (drawn from
        `target_generator`), whose targets it adds as 'roi_targets'."""
        batch = self.proposal_layer(batch)
        if self.training and 'gt_boxes' in batch:
            batch['roi_targets'] = self.assign_targets(batch, target_generator)
        rois = batch['rois']                                    # (B, R, 7)
        pts = batch['point_coords']                             # (B, Np, 3)
        feats = batch['point_features']                         # (B, Np, C)
        scores = batch.get('point_cls_scores')                  # (B, Np)
        if self.canonical:
            shared = self._canonical_forward(batch, rois, pts, feats, scores)
        else:
            shared = self._lite_forward(batch, rois, pts, feats, scores)
        batch['rcnn_cls_preds'] = self.cls_fc(shared)           # (B, R, 1)
        batch['rcnn_reg_preds'] = self.reg_fc(shared)           # (B, R, 7)
        return batch

    @staticmethod
    def _to_roi_frame(pooled_xyz: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        B, R, K, _ = pooled_xyz.shape
        local = pooled_xyz - rois[:, :, None, :3]
        return box_ops.rotate_points_along_z(
            local.reshape(B * R, K, 3), -rois[..., 6].reshape(B * R)).reshape(B, R, K, 3)

    def _lite_forward(self, batch, rois, pts, feats, scores):
        cfg = self.model_cfg
        B, R = rois.shape[:2]
        idx, valid = pool_roi_points(pts, rois, cfg.get('NUM_SAMPLED_POINTS', 64),
                                     extra=cfg.get('ROI_POINT_EXTRA', 0.0),
                                     roi_mask=batch.get('roi_mask'))
        flat = idx.reshape(B, -1).long()
        pooled_xyz = take_rows(pts, flat).reshape(B, R, -1, 3)
        parts = [self._to_roi_frame(pooled_xyz, rois),
                 torch.linalg.norm(pooled_xyz, dim=-1, keepdim=True) / 70.0]
        if scores is not None:
            parts.append(take_rows(scores, flat).reshape(B, R, -1, 1))
        parts.append(take_rows(feats, flat).reshape(B, R, -1, feats.shape[-1]))
        x = torch.where(valid[..., None], torch.cat(parts, dim=-1), 0.0)
        x = masked_max(self.up_mlp(x), valid, dim=2)            # (B, R, C')
        return self.shared_fc(x)

    def _canonical_forward(self, batch, rois, pts, feats, scores):
        pool = self.model_cfg.ROI_POINT_POOL
        K = int(pool.get('NUM_SAMPLED_POINTS', 512))
        extra = pool.get('POOL_EXTRA_WIDTH', [0.0, 0.0, 0.0])
        if not isinstance(extra, (list, tuple)):
            extra = [extra] * 3
        dnorm = float(pool.get('DEPTH_NORMALIZER', 70.0))
        B, R = rois.shape[:2]
        idx, empty = pool_roi_points_ref(pts, rois, K, extra, roi_mask=batch.get('roi_mask'))
        flat = idx.reshape(B, -1).long()
        pooled_xyz = take_rows(pts, flat).reshape(B, R, K, 3)
        pooled_feat = take_rows(feats, flat).reshape(B, R, K, feats.shape[-1])
        score = (take_rows(scores, flat).reshape(B, R, K, 1) if scores is not None
                 else torch.zeros_like(pooled_xyz[..., :1]))
        # the depth of the point in the global frame, before the canonical transform
        depth = torch.linalg.norm(pooled_xyz, dim=-1, keepdim=True) / dnorm - 0.5
        prefix = torch.cat([self._to_roi_frame(pooled_xyz, rois), score, depth], dim=-1)
        # an empty ROI's whole pooled block is zero
        live = ~empty[..., None, None]
        prefix = torch.where(live, prefix, 0.0)
        pooled_feat = torch.where(live, pooled_feat, 0.0)

        xf = _run_dense_stack(self, 'xyz_up', prefix, self.n_up, self.use_bn)
        merged = _run_dense_stack(self, 'merge_down', torch.cat([xf, pooled_feat], dim=-1), 1,
                                 self.use_bn)
        # no parameter lies behind the pooled points' coordinates (the score
        # column beside them has one): the SA stack's gathers of them need no
        # backward
        l_xyz = prefix[..., :3].detach().reshape(B * R, K, 3)
        l_feat = merged.reshape(B * R, K, -1)
        for k, npoint in enumerate(self.sa_npoints):
            if npoint > 0:
                l_xyz, l_feat = getattr(self, f'sa_{k}')(l_xyz, l_feat, 'fps')
            else:
                # one group of all points, xyz first
                grouped = torch.cat([l_xyz, l_feat], dim=-1)[:, None]   # (B', 1, N, 3 + C)
                l_feat = getattr(self, f'sa_{k}_mlp_0')(grouped).amax(dim=2)
                l_xyz = torch.zeros((B * R, 1, 3), dtype=l_xyz.dtype, device=l_xyz.device)
        return l_feat[:, 0].reshape(B, R, -1)
