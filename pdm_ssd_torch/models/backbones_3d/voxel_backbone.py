"""Dense voxel backbone (counterpart of `DenseVoxelBackBone8x` in
`pdm_ssd_tpu/models/backbones_3d/voxel_backbone.py`): the voxel features
densified into a (B, C, D, H, W) volume with one scatter, seven 3x3x3
Conv + BatchNorm + ReLU blocks with flax's 'SAME' padding (strides 1, 2, 1,
2, 1, 2, 1 in all three axes), then the depth folded into channels.

The convolutions run in NCDHW (cuDNN); the outputs are channels last as the
JAX package returns them: 'dense_voxel_features' (B, D, H, W, C) and each
entry of 'multi_scale_3d_features' are views of the NCDHW volumes.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ...utils.config import as_cfg
from ..layers import BatchNorm3d, checkpoint_block, conv_same, same_padding


class Conv3DBlock(nn.Module):
    """3x3x3 Conv (no bias, flax 'SAME') + BatchNorm(eps 1e-3) + ReLU
    (`Conv_0`, `BatchNorm_0`)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1, device=None):
        super().__init__()
        self.Conv_0 = nn.Conv3d(in_channels, features, 3, stride=stride, bias=False,
                                device=device)
        self.BatchNorm_0 = BatchNorm3d(features, eps=1e-3, momentum=0.01, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.BatchNorm_0(conv_same(self.Conv_0, x)))


# (name, index of NUM_FILTERS, stride) of the blocks, in order
BLOCKS = (('conv_input', 0, 1), ('conv2', 1, 2), ('conv2b', 1, 1), ('conv3', 2, 2),
          ('conv3b', 2, 1), ('conv4', 3, 2), ('conv4b', 3, 1))


def occupancy_down(occ: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W) bool -> the 2x2x2 max pool with flax's 'SAME' padding
    (an odd size padded by one cell after; 0 pads as well as flax's -inf
    here, since no window is padding only)."""
    pad = [p for n in reversed(occ.shape[1:]) for p in same_padding(n, 2, 2)]
    return F.max_pool3d(F.pad(occ[:, None].float(), pad), 2, 2)[:, 0] > 0.5


class DenseVoxelBackBone8x(nn.Module):
    """Config: NUM_FILTERS (4 stages, default [16, 32, 64, 64]) and REMAT
    (default on: each block's activations are recomputed in the backward,
    `layers.checkpoint_block`, the analog of flax's `nn.remat`). Takes
    'voxel_features' (B, V, C), 'voxel_coords' (B, V, 3) zyx and
    'voxel_mask'; sets 'multi_scale_3d_features' ({'x_conv<k>': (features,
    occupancy, stride)}), 'dense_voxel_features', 'spatial_features' (B, H',
    W', D' * C') and 'spatial_features_stride' 8."""

    def __init__(self, model_cfg, input_channels: int, grid_size, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        self.filters = list(cfg.get('NUM_FILTERS', [16, 32, 64, 64]))
        self.remat = cfg.get('REMAT', True)
        self.grid_size = tuple(int(g) for g in grid_size)       # (W, H, D)
        c_in = input_channels
        for name, k, stride in BLOCKS:
            self.add_module(name, Conv3DBlock(c_in, self.filters[k], stride, device=device))
            c_in = self.filters[k]
        d = self.grid_size[2]
        for _ in range(3):                  # three stride-2 'SAME' convs: ceil division
            d = -(-d // 2)
        self.num_bev_features = self.filters[-1] * max(d, 1)

    def densify(self, batch: dict) -> tuple:
        """The (B, C, D, H, W) volume and the (B, D, H, W) occupancy. Invalid
        voxels add zeros to cell 0; valid ones hold distinct cells."""
        feats, coords = batch['voxel_features'], batch['voxel_coords']
        B, V, C = feats.shape
        W, H, D = self.grid_size
        iz, iy, ix = (coords[..., i].long() for i in range(3))
        ok = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H) & (iz >= 0) & (iz < D)
        if batch.get('voxel_mask') is not None:
            ok = ok & batch['voxel_mask']
        ncells = D * H * W
        flat = torch.where(ok, (iz * H + iy) * W + ix, 0)
        vol = torch.zeros((B, C, ncells), dtype=feats.dtype, device=feats.device)
        vol.scatter_add_(2, flat[:, None, :].expand(B, C, V),
                         torch.where(ok[..., None], feats, 0.0).transpose(1, 2))
        occ = torch.zeros((B, ncells + 1), dtype=torch.bool, device=feats.device)
        occ.scatter_(1, torch.where(ok, flat, ncells), True)
        return vol.view(B, C, D, H, W), occ[:, :ncells].reshape(B, D, H, W)

    def forward(self, batch: dict) -> dict:
        x, occ = self.densify(batch)
        remat = self.remat and torch.is_grad_enabled()
        ms = {}
        for name, _, _ in BLOCKS:
            block = getattr(self, name)
            x = checkpoint_block(block, x) if remat else block(x)
            if name == 'conv_input' or name.endswith('b'):
                level = len(ms) + 1
                if level > 1:
                    occ = occupancy_down(occ)
                ms[f'x_conv{level}'] = (x.permute(0, 2, 3, 4, 1), occ, 2 ** (level - 1))
        batch['multi_scale_3d_features'] = ms
        B, C, D, H, W = x.shape
        batch['dense_voxel_features'] = x.permute(0, 2, 3, 4, 1)
        batch['spatial_features'] = x.permute(0, 3, 4, 2, 1).reshape(B, H, W, D * C)
        batch['spatial_features_stride'] = 8
        return batch
