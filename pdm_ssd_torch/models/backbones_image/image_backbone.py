"""The convolutional image backbone of BEVFusion's camera slot (counterpart
of `pdm_ssd_tpu/models/backbones_image/image_backbone.py`), which a config
takes when its IMAGE_BACKBONE is not `SwinTransformer`: a 7x7 stride-2 stem
(`stem`, `stem_bn`, epsilon 1e-5), three stages of two residual blocks
(`stage<i>_b0` at stride 2, `stage<i>_b1`; the BEV backbones'
`BasicResBlock`), then the last stage's 1x1 lateral upsampled 2x (nearest)
onto the middle stage's and a 3x3 conv: images (B, N, H, W, 3) -> (B, N,
H / 8, W / 8, OUT_CHANNEL)."""
from __future__ import annotations

import torch
from torch import nn

from ...utils.config import as_cfg
from ..backbones_2d.base_bev_backbone import BasicResBlock
from ..layers import BatchNorm2d


class ConvImageBackbone(nn.Module):
    """Config: NUM_FILTERS (the three stages' widths), OUT_CHANNEL."""

    def __init__(self, model_cfg, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        filters = [int(f) for f in cfg.get('NUM_FILTERS', [64, 128, 256])]
        self.out_channels = int(cfg.get('OUT_CHANNEL', 256))
        self.n_stages = len(filters)
        self.stem = nn.Conv2d(3, filters[0], 7, stride=2, padding=3, bias=False, device=device)
        self.stem_bn = BatchNorm2d(filters[0], eps=1e-5, momentum=0.1, device=device)
        c_in = filters[0]
        for i, ch in enumerate(filters):
            self.add_module(f'stage{i}_b0', BasicResBlock(c_in, ch, 2, device=device))
            self.add_module(f'stage{i}_b1', BasicResBlock(ch, ch, device=device))
            c_in = ch
        out = self.out_channels
        self.lat_top = nn.Conv2d(filters[-1], out, 1, device=device)
        self.lat_mid = nn.Conv2d(filters[-2], out, 1, device=device)
        self.fpn_out = nn.Conv2d(out, out, 3, padding=1, device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, N, H, W, _ = images.shape
        x = images.reshape(B * N, H, W, 3).permute(0, 3, 1, 2)
        x = torch.relu(self.stem_bn(self.stem(x)))
        feats = []
        for i in range(self.n_stages):
            x = getattr(self, f'stage{i}_b1')(getattr(self, f'stage{i}_b0')(x))
            feats.append(x)
        top, lat = self.lat_top(feats[-1]), self.lat_mid(feats[-2])
        up = top.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        top = self.fpn_out(lat + up[:, :, :lat.shape[2], :lat.shape[3]])
        return top.permute(0, 2, 3, 1).reshape(B, N, *top.shape[2:], top.shape[1])
