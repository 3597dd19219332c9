"""Focal sparse conv backbone (counterpart of
`pdm_ssd_tpu/models/backbones_3d/sparse_backbone_focal.py`,
`VoxelBackBone8xFocal`).

A focal layer predicts 27 importance logits per voxel (a submanifold conv),
picks foreground voxels, scales their features by the predicted kernel
masks and spawns zero-feature voxels at the kernel offsets whose mask clears
the threshold, so the active set grows as it goes down the ladder. As in the
JAX package, the maps of `ops/sparse_maps.build_focal_ladder_maps` hold
every site a mask could spawn (each focal stage's maximal dilation), and the
forward carries one activation bit per slot: the learned mask toggles bits
and never shapes. Inactive slots hold zeros.

Every conv, the importance conv included, is `ops/dispatch.sparse_conv`:
the Hopper kernel on CUDA tensors. The importance head is flax's
`nn.Dense(27, use_bias=False)` over the gathered taps, which is a sparse
conv with 27 output channels and the kernel as flax stores it. The split's
gathers, the bit algebra and the focal loss are plain PyTorch.

A batch prepared for training (`models.get_host_prepare(...,
training=True)`) carries the transposed maps of the four strided convs
(`fl_upmap*`, `sparse_maps.batch_invert_focal`); submanifold maps are their
own transpose and reuse their forward plan.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops import dispatch
from ...ops.box_ops import points_in_boxes
from ...ops.sparse_conv import sparse_conv_plan
from ...ops.sparse_maps import ladder_shapes
from ...utils.config import as_cfg
from .sparse_backbone import SparseConvBNReLU, SparseVoxelBackBone8x


def gather_pad(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of a (B, V, C) table at idx (B, ...) in [0, V]; index V reads a
    zero row. Returns (B, ..., C)."""
    B, V, C = table.shape
    padded = torch.cat([table, table.new_zeros((B, 1, C))], dim=1)
    flat = idx.reshape(B, -1).long()
    return torch.gather(padded, 1, flat[..., None].expand(-1, -1, C)).reshape(*idx.shape, C)


def gather_bits(bits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Bits (B, V) at idx (B, ...) in [0, V]; index V reads False."""
    padded = torch.cat([bits, bits.new_zeros((bits.shape[0], 1))], dim=1)
    flat = idx.reshape(bits.shape[0], -1).long()
    return torch.gather(padded, 1, flat).reshape(idx.shape)


def focal_split(x: torch.Tensor, act: torch.Tensor, imps: torch.Tensor, eorig: torch.Tensor,
                espawn: torch.Tensor, emask: torch.Tensor, topk: bool = True,
                threshold: float = 0.5, mask_multi: bool = False,
                skip_mask_kernel: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The foreground split and the spawn onto the dilated table, as the JAX
    package's `focal_split` reckons them. x (B, capC, C) features over the
    candidate table, act (B, capC) bits, imps (B, capC, 27) logits (26
    kernel offsets, then the voxel's own). Foreground: the top floor(thr *
    n_active) active voxels by their own mask (a stable rank, ties in slot
    order) with `topk`, else the active voxels above thr. A dilated slot
    gets a spawn from every foreground source whose offset mask is at least
    thr; its kernel mask is the mean over those spawns and, if it is a
    foreground voxel itself, 1. Returns (feats (B, capE, C), bits (B,
    capE)): foreground features scaled by that mean (unless
    `skip_mask_kernel`), background features unscaled, zeros elsewhere."""
    thr = threshold
    mv = torch.where(act, torch.sigmoid(imps[..., 26]), 0.0)
    if topk:
        k = torch.floor(thr * act.sum(dim=1)).to(torch.int64)
        order = torch.argsort(-torch.where(act, mv, -1.0), dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(order.shape[1], device=order.device).expand_as(order))
        fg = act & (rank < k[:, None])
    else:
        fg = act & (mv > thr)
    if mask_multi:
        x = x * mv[..., None]
    # the 26 spawn sources of every dilated slot at once
    B, capC = act.shape
    msig = torch.cat([torch.sigmoid(imps[..., :26]), imps.new_zeros((B, 1, 26))], dim=1)
    src = espawn.long()                                                  # (B, capE, 26)
    mval = torch.gather(msig.reshape(B, -1), 1,
                        (src * 26 + torch.arange(26, device=src.device)).reshape(B, -1)
                        ).reshape(src.shape)
    hit = gather_bits(fg, src) & (mval >= thr)
    ssum = torch.where(hit, mval, 0.0).sum(dim=-1)
    orig_fg = gather_bits(fg, eorig)
    orig_act = gather_bits(act, eorig)
    cnt = hit.sum(dim=-1) + orig_fg
    merged = (ssum + orig_fg.to(ssum.dtype)) / cnt.clamp(min=1).to(ssum.dtype)
    bits = ((cnt > 0) | (orig_act & ~orig_fg)) & emask
    feats = gather_pad(x, eorig)
    if not skip_mask_kernel:
        feats = feats * torch.where(orig_fg, merged, 1.0)[..., None]
    return torch.where(bits[..., None], feats, 0.0), bits


class SparseTapDense(nn.Module):
    """flax's `nn.Dense(features, use_bias=False)` over a map's gathered taps
    (`gather_taps`): a sparse conv whose `kernel` (K * Cin, features) is the
    Dense kernel as flax stores it, so the weights map one to one."""

    def __init__(self, in_features: int, features: int, taps: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((taps * in_features, features), device=device))

    def forward(self, feats, nbr, plan=None, bwd_nbr=None, bwd_plan=None):
        return dispatch.sparse_conv(feats, nbr, self.kernel, plan, bwd_nbr, bwd_plan)


class FocalSparseConv(nn.Module):
    """One focal layer: the importance logits over the candidate table C_s,
    the split and spawn onto the dilated table E_s, then a submanifold conv
    over E_s. Returns (feats_E, bits_E, the focal loss: 0 outside training)."""

    def __init__(self, in_features: int, features: int, voxel_stride: int, voxel_size,
                 point_cloud_range, topk: bool = True, threshold: float = 0.5,
                 mask_multi: bool = False, skip_mask_kernel: bool = False,
                 enlarge_channels: int = -1, device=None):
        super().__init__()
        self.voxel_stride = voxel_stride
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.origin = tuple(float(v) for v in point_cloud_range[:3])
        self.topk, self.threshold = topk, threshold
        self.mask_multi, self.skip_mask_kernel = mask_multi, skip_mask_kernel
        imp_in = in_features
        if enlarge_channels > 0:
            self.conv_enlarge = SparseConvBNReLU(in_features, enlarge_channels, 27, device=device)
            imp_in = enlarge_channels
        self.conv_imp = SparseTapDense(imp_in, 27, 27, device=device)
        self.conv = SparseConvBNReLU(in_features, features, 27, device=device)

    def focal_loss(self, mv, act, coords, gt_boxes, gt_mask) -> torch.Tensor:
        """The reference's focal loss on voxel-in-box targets, with its softmax
        over the probability pair [1 - m, m], at the voxel corners (no half
        voxel), as the JAX package takes them."""
        vsz = torch.tensor(self.voxel_size, dtype=torch.float32, device=mv.device)
        org = torch.tensor(self.origin, dtype=torch.float32, device=mv.device)
        xyz = coords.flip(-1).float() * self.voxel_stride * vsz + org
        tgt = (points_in_boxes(xyz, gt_boxes[..., :7], gt_mask) >= 0).to(mv.dtype)
        p = torch.softmax(torch.stack([1.0 - mv, mv], -1), dim=-1).clamp(1e-7, 1.0 - 1e-7)
        y = torch.stack([1.0 - tgt, tgt], -1)
        per = -y * torch.log(p) * (1.0 - p) ** 2.0
        m = act[..., None].to(mv.dtype)
        return (per * m).sum() / (m.sum() * 2.0).clamp(min=1.0)

    def forward(self, x, act, submap, plan, coords, ecoords, emask, eorig, espawn, esubmap,
                gt_boxes, gt_mask, bwd: bool):
        sub_bwd = (submap, plan) if bwd else ()
        xp = x
        if hasattr(self, 'conv_enlarge'):
            xp = self.conv_enlarge(xp, submap, act, plan, *sub_bwd)
        imps = self.conv_imp(xp, submap, plan, *sub_bwd)
        loss = x.new_zeros(())
        if self.training:
            mv = torch.where(act, torch.sigmoid(imps[..., 26]), 0.0)
            loss = self.focal_loss(mv, act, coords, gt_boxes, gt_mask)
        feats, bits = focal_split(x, act, imps, eorig, espawn, emask, topk=self.topk,
                                  threshold=self.threshold, mask_multi=self.mask_multi,
                                  skip_mask_kernel=self.skip_mask_kernel)
        eplan = sparse_conv_plan(esubmap, esubmap.shape[1])
        out = self.conv(feats, esubmap, bits, eplan, *((esubmap, eplan) if bwd else ()))
        return out, bits, loss


class VoxelBackBone8xFocal(nn.Module):
    """Config: NUM_FILTERS ([16, 32, 64, 64]), OUT_FEATURES (128), TOPK,
    THRESHOLD, MASK_MULTI, SKIP_MASK_KERNEL, ENLARGE_VOXEL_CHANNELS. Focal
    layers close stages 1 to 3; stage 4 and `conv_out` are plain. Consumes
    'voxel_features' and the focal ladder (`sparse_maps.FOCAL_KEYS`); adds
    what `SparseVoxelBackBone8x` adds ('spatial_features',
    'multi_scale_3d_features_sparse' over the dilated tables,
    'encoded_sparse_out', 'spatial_features_stride') and 'loss_box_of_pts',
    the sum of the three focal losses (0 outside training)."""

    scatter_to_bev = SparseVoxelBackBone8x.scatter_to_bev

    def __init__(self, model_cfg, input_channels: int, grid_size, voxel_size,
                 point_cloud_range, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        filters = list(cfg.get('NUM_FILTERS', [16, 32, 64, 64]))
        self.out_features = cfg.get('OUT_FEATURES', 128)
        self.shapes = ladder_shapes(grid_size)
        self.num_bev_features = self.out_features * self.shapes[4][0]
        fkw = dict(voxel_size=voxel_size, point_cloud_range=point_cloud_range,
                   topk=cfg.get('TOPK', True), threshold=cfg.get('THRESHOLD', 0.5),
                   mask_multi=cfg.get('MASK_MULTI', False),
                   skip_mask_kernel=cfg.get('SKIP_MASK_KERNEL', False),
                   enlarge_channels=cfg.get('ENLARGE_VOXEL_CHANNELS', -1), device=device)
        self.n_sub = {1: 0, 2: 2, 3: 2}      # submanifold layers after each down conv
        self.conv_input = SparseConvBNReLU(input_channels, filters[0], 27, device=device)
        self.conv1_subm0 = SparseConvBNReLU(filters[0], filters[0], 27, device=device)
        for s, ch in zip((1, 2, 3), filters[:3]):
            if s > 1:
                self.add_module(f'down{s}', SparseConvBNReLU(filters[s - 2], ch, 27,
                                                             device=device))
                for i in range(self.n_sub[s]):
                    self.add_module(f'conv{s}_subm{i}', SparseConvBNReLU(ch, ch, 27,
                                                                         device=device))
            self.add_module(f'focal{s}', FocalSparseConv(ch, ch, 2 ** (s - 1), **fkw))
        self.down4 = SparseConvBNReLU(filters[2], filters[3], 27, device=device)
        for i in range(2):
            self.add_module(f'conv4_subm{i}', SparseConvBNReLU(filters[3], filters[3], 27,
                                                               device=device))
        self.conv_out = SparseConvBNReLU(filters[3], self.out_features, 3, device=device)

    def forward(self, batch: dict) -> dict:
        if 'fl_submap1' not in batch:
            raise KeyError('the batch holds no focal maps: pass it through '
                           'models.get_host_prepare(model_cfg, dataset_cfg) first')
        feats = dispatch.gather_rows(batch['voxel_features'], batch['fl_perm1'])
        bwd = 'fl_upmap2' in batch
        gt_boxes, gt_mask = batch.get('gt_boxes'), batch.get('gt_mask')
        if gt_boxes is None:             # no ground truth: a focal loss over no box
            gt_boxes = feats.new_zeros((feats.shape[0], 1, 7))
            gt_mask = torch.zeros(gt_boxes.shape[:2], dtype=torch.bool, device=feats.device)

        def strided(name, x, key, out_mask, up_key):
            nbr = batch[key]
            up = ()
            if bwd:
                up = (batch[up_key], sparse_conv_plan(batch[up_key], out_mask.shape[1]))
            return getattr(self, name)(x, nbr, out_mask, sparse_conv_plan(nbr, x.shape[1]), *up)

        m1, sub = batch['fl_cmask1'], batch['fl_submap1']
        plan = sparse_conv_plan(sub, sub.shape[1])
        sub_bwd = (sub, plan) if bwd else ()
        x = self.conv_input(torch.where(m1[..., None], feats, 0.0), sub, m1, plan, *sub_bwd)
        x = self.conv1_subm0(x, sub, m1, plan, *sub_bwd)
        act = m1
        ms = {}
        total = x.new_zeros(())
        for s in (1, 2, 3):
            if s > 1:
                nxt = gather_bits(act, batch[f'fl_downmap{s}']).any(dim=-1) & batch[f'fl_cmask{s}']
                x = strided(f'down{s}', x, f'fl_downmap{s}', nxt, f'fl_upmap{s}')
                act = nxt
                sub = batch[f'fl_submap{s}']
                plan = sparse_conv_plan(sub, sub.shape[1])
                for i in range(self.n_sub[s]):
                    x = getattr(self, f'conv{s}_subm{i}')(x, sub, act, plan,
                                                          *((sub, plan) if bwd else ()))
            x, act, loss = getattr(self, f'focal{s}')(
                x, act, sub, plan, batch[f'fl_coords{s}'], batch[f'fl_ecoords{s}'],
                batch[f'fl_emask{s}'], batch[f'fl_eorig{s}'], batch[f'fl_espawn{s}'],
                batch[f'fl_esubmap{s}'], gt_boxes, gt_mask, bwd)
            total = total + loss
            ms[f'x_conv{s}'] = (x, batch[f'fl_ecoords{s}'], act, 2 ** (s - 1))
        a4 = gather_bits(act, batch['fl_downmap4']).any(dim=-1) & batch['fl_cmask4']
        x = strided('down4', x, 'fl_downmap4', a4, 'fl_upmap4')
        sub = batch['fl_submap4']
        plan = sparse_conv_plan(sub, sub.shape[1])
        for i in range(2):
            x = getattr(self, f'conv4_subm{i}')(x, sub, a4, plan, *((sub, plan) if bwd else ()))
        ms['x_conv4'] = (x, batch['fl_coords4'], a4, 8)
        ao = gather_bits(a4, batch['fl_outmap']).any(dim=-1) & batch['fl_cmask_out']
        x = strided('conv_out', x, 'fl_outmap', ao, 'fl_upmap_out')
        batch['spatial_features'] = self.scatter_to_bev(x, batch['fl_coords_out'], ao)
        batch['multi_scale_3d_features_sparse'] = ms
        batch['encoded_sparse_out'] = (x, batch['fl_coords_out'], ao)
        batch['loss_box_of_pts'] = total
        batch['spatial_features_stride'] = 8
        return batch
