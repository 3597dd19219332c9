"""VoxelNeXt's sparse detection head (counterpart of
`pdm_ssd_tpu/models/dense_heads/voxelnext_head.py`).

Heatmaps, regression targets and decoding live on the occupied BEV slots of
the sparse ladder's output (`ops/sparse_maps.build_bev_maps`), never on a
dense canvas:

- sparse height compression: the ladder's active output rows are summed
  into their BEV slots (`index_add_`);
- `shared_conv` and each branch's hidden layers are 9-tap submanifold convs
  over the BEV slots (`ops/dispatch.sparse_conv`, the Hopper kernel on CUDA
  tensors), all through one plan of that map; each branch ends in a biased
  Linear (the 'hm' bias starts at -2.19), masked to the occupied slots;
- targets: per object the nearest occupied slot (the first on a tie) and
  Gaussians drawn over the slots, 'gt_center' and 'nearst' (sic, the
  reference's spelling);
- losses: the sparse CenterNet focal loss with the padding slots masked out,
  and the masked L1 of the regression at the objects' slots;
- decode: top-K over the (classes x slots) scores, `two_stage_topk`.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops import losses
from ...ops.centernet import gaussian_radius
from ...ops.selection import two_stage_topk
from ...ops.sparse_conv import sparse_conv_plan
from ...utils.config import as_cfg
from ..backbones_3d.sparse_backbone import SparseConvBNReLU


class SeparateHeadSparse(nn.Module):
    """Per branch, `num_conv - 1` 9-tap submanifold convs (`{name}_conv{k}`)
    and a biased Linear (`{name}_out`), in `head_dict`'s order."""

    def __init__(self, in_channels: int, head_dict: dict, init_bias: float = -2.19,
                 device=None):
        super().__init__()
        self.head_dict = head_dict
        for name, spec in head_dict.items():
            for k in range(int(spec['num_conv']) - 1):
                self.add_module(f'{name}_conv{k}', SparseConvBNReLU(in_channels, in_channels, 9,
                                                                    device=device))
            out = nn.Linear(in_channels, int(spec['out_channels']), device=device)
            out.bias_init = init_bias if name == 'hm' else 0.0
            self.add_module(f'{name}_out', out)

    def forward(self, x, submap, mask, plan) -> dict:
        """x (B, capb, C) over the BEV slots -> {name: (B, capb, C_name)}. The
        BEV map is its own transpose: the data gradient reads it too."""
        out = {}
        for name, spec in self.head_dict.items():
            h = x
            for k in range(int(spec['num_conv']) - 1):
                h = getattr(self, f'{name}_conv{k}')(h, submap, mask, plan, submap, plan)
            out[name] = torch.where(mask[..., None], getattr(self, f'{name}_out')(h), 0.0)
        return out


class VoxelNeXtHead(nn.Module):
    def __init__(self, model_cfg, input_channels: int, num_class: int, point_cloud_range,
                 voxel_size, class_names=None, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        self.cfg = cfg
        self.num_class = num_class
        self.class_names = class_names
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.voxel_size = tuple(float(v) for v in voxel_size[:2])
        shared = cfg.get('SHARED_CONV_CHANNEL', input_channels)
        self.shared_conv = SparseConvBNReLU(input_channels, shared, 9, device=device)
        self.head_order = list(cfg.SEPARATE_HEAD_CFG.HEAD_ORDER)
        for gi, group in enumerate(self.groups()):
            hd = {k: dict(v) for k, v in cfg.SEPARATE_HEAD_CFG.HEAD_DICT.items()}
            hd['hm'] = {'out_channels': len(group), 'num_conv': cfg.get('NUM_HM_CONV', 2)}
            self.add_module(f'head_{gi}', SeparateHeadSparse(shared, hd, device=device))

    def groups(self) -> list:
        """List over heads of the global class ids (1-based) in that head:
        CLASS_NAMES_EACH_HEAD by the model's class names, or one head of all
        classes where either is missing (as the port's `CenterHead` reads
        it; `build_network` names no classes, and `voxelnext.yaml`'s one
        head lists all three in order)."""
        groups_cfg = self.cfg.get('CLASS_NAMES_EACH_HEAD', None)
        if not groups_cfg or self.class_names is None:
            return [list(range(1, self.num_class + 1))]
        names = list(self.class_names)
        return [[names.index(n) + 1 for n in head if n in names] for head in groups_cfg]

    def forward(self, batch: dict) -> dict:
        x, _, mask_out = batch['encoded_sparse_out']
        bev_mask, submap = batch['sp_bev_mask'], batch['sp_bev_submap']
        B, _, C = x.shape
        capb = bev_mask.shape[1]
        # the output rows summed into their BEV slots; padding rows go to a
        # spare row per cloud, which is dropped
        idx = torch.where(mask_out, batch['sp_bev_from_out'].long(), capb)
        idx = idx + (torch.arange(B, device=x.device) * (capb + 1))[:, None]
        xb = x.new_zeros((B * (capb + 1), C)).index_add_(
            0, idx.reshape(-1), torch.where(mask_out[..., None], x, 0.0).reshape(-1, C))
        xb = xb.view(B, capb + 1, C)[:, :capb]
        plan = sparse_conv_plan(submap, capb)
        xb = self.shared_conv(xb, submap, bev_mask, plan, submap, plan)
        batch['voxelnext_preds'] = [getattr(self, f'head_{gi}')(xb, submap, bev_mask, plan)
                                    for gi in range(len(self.groups()))]
        batch['voxelnext_head_order'] = self.head_order
        return batch

    def assign_targets(self, gt_boxes: torch.Tensor, gt_mask: torch.Tensor,
                       bev_coords: torch.Tensor, bev_mask: torch.Tensor) -> list:
        """Per head group: 'heatmaps' (B, n_cls, capb), 'target_boxes' (B, M,
        8), 'inds' (B, M) int32 slot of each object, 'masks' (B, M) int32,
        'target_boxes_src' (B, M, 7), for the first NUM_MAX_OBJS objects. An
        object of a non-positive size gets zero targets."""
        acfg = self.cfg.TARGET_ASSIGNER_CONFIG
        stride = acfg.FEATURE_MAP_STRIDE
        n_max = acfg.get('NUM_MAX_OBJS', 500)
        ratio = self.cfg.get('GAUSSIAN_RATIO', 1.0)
        gtypes = self.cfg.get('GAUSSIAN_TYPE', ['nearst', 'gt_center'])
        vx, vy = self.voxel_size
        pcr = self.point_cloud_range
        dev = gt_boxes.device
        Mk = min(gt_boxes.shape[1], n_max)
        g = gt_boxes[:, :Mk]
        sy = bev_coords[..., 0].float()                                   # (B, capb)
        sx = bev_coords[..., 1].float()
        smask = bev_mask[:, None, :]
        cx = (g[..., 0] - pcr[0]) / vx / stride                          # (B, M)
        cy = (g[..., 1] - pcr[1]) / vy / stride
        dxf = g[..., 3] / vx / stride
        dyf = g[..., 4] / vy / stride
        dist = (sx[:, None, :] - cx[..., None]) ** 2 + (sy[:, None, :] - cy[..., None]) ** 2
        dist = torch.where(smask, dist, 1e18)
        inds = torch.argmin(dist, dim=-1)                                 # the first on a tie
        radius = torch.clamp(gaussian_radius(dxf, dyf, acfg.get('GAUSSIAN_OVERLAP', 0.1))
                             .to(torch.int32), min=acfg.get('MIN_RADIUS', 2)).float()
        sigma = (2 * radius * ratio + 1) / 6.0
        denom = (2 * sigma * sigma)[..., None]
        contrib = torch.zeros_like(dist)
        if 'gt_center' in gtypes:
            contrib = torch.maximum(contrib, torch.exp(-dist / denom))
        ny, nx = torch.gather(sy, 1, inds), torch.gather(sx, 1, inds)
        if 'nearst' in gtypes:
            dist_n = (sx[:, None, :] - nx[..., None]) ** 2 + (sy[:, None, :] - ny[..., None]) ** 2
            dist_n = torch.where(smask, dist_n, 1e18)
            contrib = torch.maximum(contrib, torch.exp(-dist_n / denom))
        code = 8 + max(g.shape[-1] - 8, 0)
        out = []
        cls_g = g[..., -1].to(torch.int32)
        for group in self.groups():
            match = cls_g[..., None] == torch.tensor(group, dtype=torch.int32, device=dev)
            local = torch.argmax(match.to(torch.int32), dim=-1)
            ok = gt_mask[:, :Mk] & match.any(dim=-1) & (dxf > 0) & (dyf > 0)
            c = torch.where(ok[..., None], contrib, 0.0)
            heat = torch.stack([torch.where((local == j)[..., None], c, 0.0).amax(dim=1)
                                for j in range(len(group))], dim=1)
            ret = torch.cat([(cx - nx)[..., None], (cy - ny)[..., None], g[..., 2:3],
                             torch.log(torch.clamp(g[..., 3:6], min=1e-6)),
                             torch.cos(g[..., 6:7]), torch.sin(g[..., 6:7])]
                            + ([g[..., 7:-1]] if code > 8 else []), dim=-1)
            out.append({'heatmaps': heat, 'target_boxes': torch.where(ok[..., None], ret, 0.0),
                        'inds': inds.to(torch.int32), 'masks': ok.to(torch.int32),
                        'target_boxes_src': g[..., :7]})
        return out

    def get_loss(self, batch: dict, targets) -> tuple:
        """The sparse CenterNet focal loss over the occupied slots and the
        code-weighted L1 at the objects' slots, per head group. Returns
        (loss, {'hm_loss', 'loc_loss'}; '_head_<i>' suffixed with more than
        one group)."""
        lw = self.cfg.LOSS_CONFIG.LOSS_WEIGHTS
        vm = batch['sp_bev_mask'][:, None, :]
        total = torch.zeros((), device=vm.device)
        tb = {}
        for i, (preds, tgt) in enumerate(zip(batch['voxelnext_preds'], targets)):
            hm = torch.clamp(torch.sigmoid(preds['hm']), 1e-4, 1 - 1e-4).transpose(1, 2)
            gt_hm = tgt['heatmaps']
            pos = (gt_hm >= 1.0) & vm
            posf = pos.to(hm.dtype)
            neg_w = torch.pow(1 - gt_hm, 4)
            pos_loss = torch.log(hm) * torch.pow(1 - hm, 2) * posf
            neg_loss = torch.log(1 - hm) * torch.pow(hm, 2) * neg_w * (~pos).to(hm.dtype) \
                * vm.to(hm.dtype)
            num_pos = posf.sum()
            hm_loss = torch.where(num_pos > 0, -(pos_loss.sum() + neg_loss.sum())
                                  / num_pos.clamp(min=1.0), -neg_loss.sum()) * lw['cls_weight']
            pred_boxes = torch.cat([preds[k] for k in self.head_order], dim=-1)
            reg = losses.centernet_reg_loss(losses.gather_feat(pred_boxes, tgt['inds']),
                                            tgt['masks'], tgt['target_boxes'])
            code_weights = torch.tensor(lw['code_weights'], dtype=reg.dtype, device=reg.device)
            loc_loss = (reg * code_weights).sum() * lw['loc_weight']
            total = total + hm_loss + loc_loss
            sfx = f'_head_{i}' if len(targets) > 1 else ''
            tb[f'hm_loss{sfx}'] = hm_loss
            tb[f'loc_loss{sfx}'] = loc_loss
        return total, tb

    def generate_predicted_boxes(self, batch: dict) -> dict:
        """Top MAX_OBJ_PER_SAMPLE of each group's (classes x slots) scores,
        decoded at their slots; valid above the head's SCORE_THRESH and inside
        POST_CENTER_LIMIT_RANGE. Labels are 0-based global class ids."""
        pp = self.cfg.POST_PROCESSING
        stride = self.cfg.TARGET_ASSIGNER_CONFIG.FEATURE_MAP_STRIDE
        vx, vy = self.voxel_size
        pcr = torch.tensor(self.point_cloud_range, dtype=torch.float32)
        bev_coords, bev_mask = batch['sp_bev_coords'], batch['sp_bev_mask']
        dev = bev_mask.device
        K = pp.MAX_OBJ_PER_SAMPLE
        outs = {'pred_boxes': [], 'pred_scores': [], 'pred_labels': [], 'pred_mask': []}
        for preds, group in zip(batch['voxelnext_preds'], self.groups()):
            B, capb, nc = preds['hm'].shape
            scores = torch.where(bev_mask[..., None], torch.sigmoid(preds['hm']), 0.0)
            top_s, top_i = two_stage_topk(scores.transpose(1, 2).reshape(B, nc * capb), K)
            slot = top_i % capb
            labels = (torch.tensor(group, device=dev) - 1)[top_i // capb]

            def at(t):
                return torch.gather(t, 1, slot[..., None].expand(-1, -1, t.shape[-1]))

            center, center_z, rot = at(preds['center']), at(preds['center_z']), at(preds['rot'])
            dim = torch.exp(torch.clamp(at(preds['dim']), -5.0, 5.0))
            sy = torch.gather(bev_coords[..., 0], 1, slot)
            sx = torch.gather(bev_coords[..., 1], 1, slot)
            xs = (sx + center[..., 0]) * stride * vx + pcr[0].item()
            ys = (sy + center[..., 1]) * stride * vy + pcr[1].item()
            ang = torch.atan2(rot[..., 1], rot[..., 0])
            boxes = torch.cat([xs[..., None], ys[..., None], center_z, dim, ang[..., None]], -1)
            valid = top_s > pp.get('SCORE_THRESH', 0.1)
            pcl = pp.get('POST_CENTER_LIMIT_RANGE', None)
            if pcl is not None:
                lim = torch.tensor(pcl, dtype=torch.float32, device=dev)
                valid &= (boxes[..., :3] >= lim[:3]).all(-1) & (boxes[..., :3] <= lim[3:6]).all(-1)
            outs['pred_boxes'].append(boxes)
            outs['pred_scores'].append(top_s)
            outs['pred_labels'].append(labels)
            outs['pred_mask'].append(valid)
        return {k: torch.cat(v, dim=1) for k, v in outs.items()}
