"""CenterPoint-style heatmap head, the scene-heatmap branch of the hybrid
head (counterpart of `pdm_ssd_tpu/models/dense_heads/center_head.py`):
forward, target assignment and losses for one head group, and fixed-K
decode. Maps are NHWC at the boundaries."""
from __future__ import annotations

import torch
from torch import nn

from ...ops import centernet, losses
from ...utils.config import as_cfg
from ..layers import BatchNorm2d


class SeparateHead(nn.Module):
    """Per-branch conv stacks; the 'hm' output bias starts at -2.19."""

    def __init__(self, in_channels: int, head_dict: dict, init_bias: float = -2.19,
                 device=None):
        super().__init__()
        self.head_dict = head_dict
        for name, spec in head_dict.items():
            for k in range(spec['num_conv'] - 1):
                self.add_module(f'{name}_conv{k}', nn.Conv2d(
                    in_channels, in_channels, 3, padding=1, bias=False, device=device))
                self.add_module(f'{name}_bn{k}', BatchNorm2d(
                    in_channels, eps=1e-5, momentum=0.1, device=device))
            out = nn.Conv2d(in_channels, spec['out_channels'], 3, padding=1, device=device)
            out.bias_init = init_bias if name == 'hm' else 0.0
            self.add_module(f'{name}_out', out)

    def forward(self, x: torch.Tensor) -> dict:
        """x: (B, C, H, W) -> {name: (B, H, W, C_name)}."""
        out = {}
        for name, spec in self.head_dict.items():
            h = x
            for k in range(spec['num_conv'] - 1):
                h = getattr(self, f'{name}_conv{k}')(h)
                h = torch.relu(getattr(self, f'{name}_bn{k}')(h))
            out[name] = getattr(self, f'{name}_out')(h).permute(0, 2, 3, 1)
        return out


class CenterHead(nn.Module):
    def __init__(self, model_cfg, input_channels: int, num_class: int, grid_size,
                 point_cloud_range, voxel_size, class_names=None, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        self.cfg = cfg
        self.num_class = num_class
        self.class_names = class_names
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(voxel_size)
        self.shared_conv = nn.Conv2d(input_channels, cfg.SHARED_CONV_CHANNEL, 3, padding=1,
                                     bias=False, device=device)
        self.shared_bn = BatchNorm2d(cfg.SHARED_CONV_CHANNEL, eps=1e-5, momentum=0.1,
                                        device=device)
        groups = self.groups()
        if len(groups) != 1:
            raise NotImplementedError('one head group only (multi-head CenterHead, ROADMAP Queue 1 '
                                      'item 8, the rest of the PDM family)')
        head_dict = {k: dict(v) for k, v in cfg.SEPARATE_HEAD_CFG.HEAD_DICT.items()}
        if any(k in head_dict for k in ('vel', 'iou')):
            raise NotImplementedError("'vel'/'iou' branches are not ported yet "
                                      '(ROADMAP Queue 1 item 8, the rest of the PDM family)')
        if cfg.get('IOU_REG_LOSS', False):
            raise NotImplementedError('IOU_REG_LOSS is not ported yet (ROADMAP Queue 1 item 8, the '
                                      'rest of the PDM family)')
        head_dict['hm'] = dict(out_channels=len(groups[0]), num_conv=cfg.get('NUM_HM_CONV', 2))
        self.head = SeparateHead(cfg.SHARED_CONV_CHANNEL, head_dict, device=device)

    def groups(self):
        """List over heads of the global class ids (1-based) in that head."""
        groups_cfg = self.cfg.get('CLASS_NAMES_EACH_HEAD', None)
        if not groups_cfg or self.class_names is None:
            return [list(range(1, self.num_class + 1))]
        name_to_id = {n: i + 1 for i, n in enumerate(self.class_names)}
        return [[name_to_id[n] for n in grp if n in name_to_id] for grp in groups_cfg]

    def forward(self, batch: dict) -> dict:
        x = batch['spatial_features_2d'].permute(0, 3, 1, 2)   # NHWC -> NCHW
        shared = torch.relu(self.shared_bn(self.shared_conv(x)))
        batch['center_head_preds'] = [self.head(shared)]
        return batch

    def assign_targets(self, gt_boxes: torch.Tensor, gt_mask: torch.Tensor,
                       feature_map_size) -> list:
        """Gaussian heatmap targets of the head group. gt_boxes (B, M, 8) with
        the global class (1-based) last, gt_mask (B, M) bool,
        feature_map_size (H, W). Returns a one-element list of target dicts."""
        cfg = self.cfg.TARGET_ASSIGNER_CONFIG
        H, W = feature_map_size
        group = self.groups()[0]
        gids = torch.tensor(group, dtype=torch.int32, device=gt_boxes.device)
        cls_g = gt_boxes[..., -1].to(torch.int32)
        match = cls_g[..., None] == gids
        in_group = match.any(dim=-1)
        # the class becomes its 1-based position in the group
        local = torch.argmax(match.to(torch.int32), dim=-1) + 1
        gts = torch.cat([gt_boxes[..., :-1],
                         torch.where(in_group, local, 0).to(gt_boxes.dtype)[..., None]], dim=-1)
        heatmaps, ret_boxes, inds, masks, src = centernet.assign_center_targets(
            gts, gt_mask & in_group, num_classes=len(group), feature_map_size=(W, H),
            feature_map_stride=cfg.FEATURE_MAP_STRIDE, voxel_size=self.voxel_size,
            point_cloud_range=self.point_cloud_range,
            gaussian_overlap=cfg.GAUSSIAN_OVERLAP, min_radius=cfg.MIN_RADIUS)
        return [{'heatmaps': heatmaps, 'target_boxes': ret_boxes, 'inds': inds,
                 'masks': masks, 'target_boxes_src': src}]

    def get_loss(self, batch: dict, targets) -> tuple:
        """Heatmap focal loss plus masked L1 on the regression maps gathered at
        the objects' cells. Returns (loss, {'hm_loss', 'loc_loss'})."""
        lw = self.cfg.LOSS_CONFIG.LOSS_WEIGHTS
        order = self.cfg.SEPARATE_HEAD_CFG.HEAD_ORDER
        preds = batch['center_head_preds'][0]
        tgt = targets[0] if isinstance(targets, (list, tuple)) else targets
        hm = torch.sigmoid(preds['hm']).clamp(1e-4, 1 - 1e-4)
        hm_loss = losses.centernet_focal_loss(hm.permute(0, 3, 1, 2),
                                              tgt['heatmaps']) * lw['cls_weight']
        pred_boxes = torch.cat([preds[k] for k in order], dim=-1)
        B, H, W, D = pred_boxes.shape
        gathered = losses.gather_feat(pred_boxes.reshape(B, H * W, D), tgt['inds'])
        reg = losses.centernet_reg_loss(gathered, tgt['masks'], tgt['target_boxes'])
        code_weights = torch.tensor(lw['code_weights'], dtype=reg.dtype, device=reg.device)
        loc_loss = (reg * code_weights).sum() * lw['loc_weight']
        return hm_loss + loc_loss, {'hm_loss': hm_loss, 'loc_loss': loc_loss}

    def generate_predicted_boxes(self, batch: dict) -> dict:
        """Fixed-K decode; labels are 0-based global class ids."""
        pp = self.cfg.POST_PROCESSING
        preds = batch['center_head_preds'][0]

        def nchw(t):
            return t.permute(0, 3, 1, 2)

        dec = centernet.decode_bbox_from_heatmap(
            heatmap=nchw(torch.sigmoid(preds['hm'])),
            rot_cos=nchw(preds['rot'][..., 0:1]), rot_sin=nchw(preds['rot'][..., 1:2]),
            center=nchw(preds['center']), center_z=nchw(preds['center_z']),
            dim=nchw(torch.exp(torch.clamp(preds['dim'], -5.0, 5.0))),
            point_cloud_range=self.point_cloud_range, voxel_size=self.voxel_size,
            feature_map_stride=self.cfg.TARGET_ASSIGNER_CONFIG.FEATURE_MAP_STRIDE,
            K=pp.MAX_OBJ_PER_SAMPLE, score_thresh=pp.get('SCORE_THRESH'),
            post_center_limit_range=pp.POST_CENTER_LIMIT_RANGE)
        mapping = torch.tensor(self.groups()[0], device=dec['pred_labels'].device) - 1
        dec['pred_labels'] = mapping[dec['pred_labels']]
        return dec
