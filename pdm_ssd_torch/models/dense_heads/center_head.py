"""CenterPoint-style heatmap head, the scene-heatmap branch of the hybrid
head (counterpart of `pdm_ssd_tpu/models/dense_heads/center_head.py`):
forward, target assignment, losses and fixed-K decode for one or several
head groups, with the optional 'vel' and 'iou' branches. Maps are NHWC at
the boundaries."""
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
    """One `SeparateHead` per CLASS_NAMES_EACH_HEAD group (one group of all
    classes without it or without `class_names`), named `head` alone and
    `head_<i>` for several, as in the flax tree. HEAD_DICT may add a 'vel'
    branch (its two codes follow the box's in the targets and losses) and an
    'iou' branch (its loss, and the score rectification at decode with
    POST_PROCESSING.USE_IOU_TO_RECTIFY_SCORE); IOU_REG_LOSS adds the DIoU
    regression loss."""

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
        self.head_names = ['head'] if len(groups) == 1 else [f'head_{i}' for i in range(len(groups))]
        for name, group in zip(self.head_names, groups):
            head_dict = {k: dict(v) for k, v in cfg.SEPARATE_HEAD_CFG.HEAD_DICT.items()}
            head_dict['hm'] = dict(out_channels=len(group), num_conv=cfg.get('NUM_HM_CONV', 2))
            self.add_module(name, SeparateHead(cfg.SHARED_CONV_CHANNEL, head_dict, device=device))

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
        batch['center_head_preds'] = [getattr(self, name)(shared) for name in self.head_names]
        return batch

    def assign_targets(self, gt_boxes: torch.Tensor, gt_mask: torch.Tensor,
                       feature_map_size) -> list:
        """Gaussian heatmap targets of each head group. gt_boxes (B, M, 8 + E)
        with the global class (1-based) last, gt_mask (B, M) bool,
        feature_map_size (H, W). Returns one target dict per group, in which
        a box's class is its 1-based place in the group and boxes of other
        groups are masked out."""
        cfg = self.cfg.TARGET_ASSIGNER_CONFIG
        H, W = feature_map_size
        out = []
        for group in self.groups():
            gids = torch.tensor(group, dtype=torch.int32, device=gt_boxes.device)
            cls_g = gt_boxes[..., -1].to(torch.int32)
            match = cls_g[..., None] == gids
            in_group = match.any(dim=-1)
            local = torch.argmax(match.to(torch.int32), dim=-1) + 1
            gts = torch.cat([gt_boxes[..., :-1],
                             torch.where(in_group, local, 0).to(gt_boxes.dtype)[..., None]],
                            dim=-1)
            heatmaps, ret_boxes, inds, masks, src = centernet.assign_center_targets(
                gts, gt_mask & in_group, num_classes=len(group), feature_map_size=(W, H),
                feature_map_stride=cfg.FEATURE_MAP_STRIDE, voxel_size=self.voxel_size,
                point_cloud_range=self.point_cloud_range,
                gaussian_overlap=cfg.GAUSSIAN_OVERLAP, min_radius=cfg.MIN_RADIUS)
            out.append({'heatmaps': heatmaps, 'target_boxes': ret_boxes, 'inds': inds,
                        'masks': masks, 'target_boxes_src': src})
        return out

    def get_loss(self, batch: dict, targets) -> tuple:
        """Per head group: the heatmap focal loss and the masked L1 of the
        HEAD_ORDER maps gathered at the objects' cells; with an 'iou' branch
        its IoU loss, with IOU_REG_LOSS the DIoU loss, both on the boxes
        decoded at those cells. Returns (loss, tb); with several groups each
        entry carries the suffix `_head_<i>`."""
        lw = self.cfg.LOSS_CONFIG.LOSS_WEIGHTS
        order = self.cfg.SEPARATE_HEAD_CFG.HEAD_ORDER
        stride = self.cfg.TARGET_ASSIGNER_CONFIG.FEATURE_MAP_STRIDE
        preds_list = batch['center_head_preds']
        if isinstance(targets, dict):
            targets = [targets]
        total = torch.zeros((), dtype=torch.float32, device=preds_list[0]['hm'].device)
        tb = {}
        for idx, (preds, tgt) in enumerate(zip(preds_list, targets)):
            hm = torch.sigmoid(preds['hm']).clamp(1e-4, 1 - 1e-4)
            hm_loss = losses.centernet_focal_loss(hm.permute(0, 3, 1, 2),
                                                  tgt['heatmaps']) * lw['cls_weight']
            pred_boxes = torch.cat([preds[k] for k in order], dim=-1)
            B, H, W, D = pred_boxes.shape
            gathered = losses.gather_feat(pred_boxes.reshape(B, H * W, D), tgt['inds'])
            reg = losses.centernet_reg_loss(gathered, tgt['masks'], tgt['target_boxes'])
            code_weights = torch.tensor(lw['code_weights'], dtype=reg.dtype, device=reg.device)
            loc_loss = (reg * code_weights).sum() * lw['loc_weight']
            total = total + hm_loss + loc_loss
            sfx = f'_head_{idx}' if len(preds_list) > 1 else ''
            tb[f'hm_loss{sfx}'] = hm_loss
            tb[f'loc_loss{sfx}'] = loc_loss
            iou_reg = self.cfg.get('IOU_REG_LOSS', False)
            if 'iou' in preds or iou_reg:
                decoded = centernet.decode_boxes_at_inds(preds, tgt['inds'],
                                                         self.point_cloud_range,
                                                         self.voxel_size, stride, (W, H))
                if 'iou' in preds:
                    iou_g = losses.gather_feat(preds['iou'].reshape(B, H * W, 1),
                                               tgt['inds'])[..., 0]
                    iou_loss = losses.centerhead_iou_loss(iou_g, decoded, tgt['masks'],
                                                          tgt['target_boxes_src'])
                    total = total + iou_loss
                    tb[f'iou_loss{sfx}'] = iou_loss
                if iou_reg:
                    reg_loss = losses.centerhead_iou_reg_loss(
                        decoded, tgt['masks'], tgt['target_boxes_src']) * lw['loc_weight']
                    total = total + reg_loss
                    tb[f'iou_reg_loss{sfx}'] = reg_loss
        return total, tb

    def generate_predicted_boxes(self, batch: dict) -> dict:
        """Fixed-K decode of each head group, its labels mapped to 0-based
        global class ids, with USE_IOU_TO_RECTIFY_SCORE the scores
        rectified by the 'iou' branch (score^(1 - r) * iou^r, r the class's
        IOU_RECTIFIER); the groups' K slots side by side."""
        pp = self.cfg.POST_PROCESSING
        rectify = pp.get('USE_IOU_TO_RECTIFY_SCORE', False)

        def nchw(t):
            return t.permute(0, 3, 1, 2)

        outs = []
        for preds, group in zip(batch['center_head_preds'], self.groups()):
            dec = centernet.decode_bbox_from_heatmap(
                heatmap=nchw(torch.sigmoid(preds['hm'])),
                rot_cos=nchw(preds['rot'][..., 0:1]), rot_sin=nchw(preds['rot'][..., 1:2]),
                center=nchw(preds['center']), center_z=nchw(preds['center_z']),
                dim=nchw(torch.exp(torch.clamp(preds['dim'], -5.0, 5.0))),
                vel=nchw(preds['vel']) if 'vel' in preds else None,
                iou=nchw((preds['iou'] + 1) * 0.5) if 'iou' in preds else None,
                point_cloud_range=self.point_cloud_range, voxel_size=self.voxel_size,
                feature_map_stride=self.cfg.TARGET_ASSIGNER_CONFIG.FEATURE_MAP_STRIDE,
                K=pp.MAX_OBJ_PER_SAMPLE, score_thresh=pp.get('SCORE_THRESH'),
                post_center_limit_range=pp.POST_CENTER_LIMIT_RANGE)
            mapping = torch.tensor(group, device=dec['pred_labels'].device) - 1
            dec['pred_labels'] = mapping[dec['pred_labels']]
            if rectify and 'pred_iou' in dec:
                pred_iou = dec['pred_iou'].clamp(0.0, 1.0)
                rect = torch.tensor(pp.IOU_RECTIFIER, dtype=pred_iou.dtype,
                                    device=pred_iou.device)
                r = rect[dec['pred_labels'].clamp(max=len(rect) - 1)]
                dec['pred_scores'] = dec['pred_scores'] ** (1 - r) * pred_iou ** r
            outs.append(dec)
        keys = ('pred_boxes', 'pred_scores', 'pred_labels', 'pred_mask')
        return {k: torch.cat([o[k] for o in outs], dim=1) for k in keys}
