"""Dense voxel backbones (counterparts of `DenseVoxelBackBone8x` and
`DenseUNetV2` in `pdm_ssd_tpu/models/backbones_3d/voxel_backbone.py`): the
voxel features densified into a (B, C, D, H, W) volume with one scatter,
seven 3x3x3 Conv + BatchNorm + ReLU blocks with flax's 'SAME' padding
(strides 1, 2, 1, 2, 1, 2, 1 in all three axes), then the depth folded into
channels. The UNet adds a decoder back to full resolution and reads its
features at the input voxels.

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


def conv_transpose_same(deconv: nn.ConvTranspose3d, x: torch.Tensor) -> torch.Tensor:
    """flax's `ConvTranspose` with padding 'SAME' (a correlation over the
    input dilated by the stride; the kernel not flipped): torch's transposed
    convolution with the kernel flipped (`utils/weights` stores it so) and
    no padding, cut to stride times the input's size."""
    out = F.conv_transpose3d(x, deconv.weight, deconv.bias, deconv.stride)
    D, H, W = (n * s for n, s in zip(x.shape[2:], deconv.stride))
    return out[:, :, :D, :H, :W]


class DenseUNetV2(DenseVoxelBackBone8x):
    """The dense ladder as encoder plus a decoder of three steps ('up3',
    'up2', 'up1') back to the input resolution. A step is a stride-2 3x3x3
    transposed conv ('<step>_deconv') + BatchNorm ('_bn') + ReLU, cut to the
    skip's size, plus the skip projected by a bias-free Linear ('_skip'),
    then a `Conv3DBlock` ('_fuse'). Config: NUM_FILTERS,
    REMAT (the encoder's blocks and the decoder's fuse blocks). Takes what
    the ladder takes; sets 'spatial_features' (the encoder's top, depth
    folded into channels) and 'spatial_features_stride' 8, and at the input
    voxels 'point_features' (B, V, NUM_FILTERS[0]) from the decoder's full
    resolution map (zero at invalid voxels), 'point_coords' (B, V, 3), the
    voxel centres, and 'point_mask' (B, V)."""

    def __init__(self, model_cfg, input_channels: int, grid_size, voxel_size, point_cloud_range,
                 device=None):
        super().__init__(model_cfg, input_channels, grid_size, device=device)
        f = self.filters
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.pc_range = tuple(float(v) for v in point_cloud_range)
        self.num_point_features = f[0]
        for name, c_in, ch in (('up3', f[3], f[2]), ('up2', f[2], f[1]), ('up1', f[1], f[0])):
            self.add_module(f'{name}_deconv', nn.ConvTranspose3d(c_in, ch, 3, stride=2, bias=False,
                                                                 device=device))
            self.add_module(f'{name}_bn', BatchNorm3d(ch, eps=1e-3, momentum=0.01, device=device))
            self.add_module(f'{name}_skip', nn.Linear(ch, ch, bias=False, device=device))
            self.add_module(f'{name}_fuse', Conv3DBlock(ch, ch, device=device))

    def up(self, name: str, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        """A decoder step's input to its fuse block: the deconvolved map cut
        to the skip's size, plus the projected skip."""
        x = torch.relu(getattr(self, f'{name}_bn')(
            conv_transpose_same(getattr(self, f'{name}_deconv'), x)))
        D, H, W = skip.shape[2:]
        proj = F.linear(skip.permute(0, 2, 3, 4, 1), getattr(self, f'{name}_skip').weight)
        return x[:, :, :D, :H, :W] + proj.permute(0, 4, 1, 2, 3)

    def forward(self, batch: dict) -> dict:
        x, _ = self.densify(batch)
        remat = self.remat and torch.is_grad_enabled()

        def block(module, x):
            return checkpoint_block(module, x) if remat else module(x)

        enc = {}
        for name, _, _ in BLOCKS:
            x = block(getattr(self, name), x)
            if name == 'conv_input' or name.endswith('b'):
                enc[len(enc) + 1] = x
        B, C, D, H, W = x.shape
        batch['spatial_features'] = x.permute(0, 3, 4, 2, 1).reshape(B, H, W, D * C)
        batch['spatial_features_stride'] = 8
        for name, skip in (('up3', enc[3]), ('up2', enc[2]), ('up1', enc[1])):
            x = block(getattr(self, f'{name}_fuse'), self.up(name, x, skip))

        coords = batch['voxel_coords']
        Wg, Hg, Dg = self.grid_size
        iz, iy, ix = (coords[..., i].long() for i in range(3))
        ok = (ix >= 0) & (ix < Wg) & (iy >= 0) & (iy < Hg) & (iz >= 0) & (iz < Dg)
        if batch.get('voxel_mask') is not None:
            ok = ok & batch['voxel_mask']
        ncells = Dg * Hg * Wg
        flat = torch.where(ok, (iz * Hg + iy) * Wg + ix, 0)
        C0 = x.shape[1]
        pf = torch.gather(x.reshape(x.shape[0], C0, ncells), 2,
                          flat[:, None, :].expand(-1, C0, -1)).transpose(1, 2)
        vsz, org = self.voxel_size, self.pc_range
        centers = torch.stack([(ix.float() + 0.5) * vsz[0] + org[0],
                               (iy.float() + 0.5) * vsz[1] + org[1],
                               (iz.float() + 0.5) * vsz[2] + org[2]], dim=-1)
        batch['point_features'] = torch.where(ok[..., None], pf, 0.0)
        batch['point_coords'] = centers
        batch['point_mask'] = ok
        return batch
