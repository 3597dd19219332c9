"""2D BEV conv backbones (counterpart of
`pdm_ssd_tpu/models/backbones_2d/base_bev_backbone.py`): `BaseBEVBackbone`
and its residual variant `BaseBEVResBackbone`.

Take and return NHWC maps like the JAX package and run the convolutions in
NCHW. BatchNorm eps is 1e-3 here (flax momentum 0.99 = torch 0.01). An
upsample stride s >= 1 is a transposed conv (`up<i>_deconv`); s < 1 a
strided conv of 1 / s (`up<i>_conv`, flax 'SAME'); one stride more than the
levels adds `up_final_deconv` after the concatenation.
"""
from __future__ import annotations

import torch
from torch import nn

from ...utils.config import as_cfg
from ..layers import BatchNorm2d, conv_same


def _bn(c, device):
    return BatchNorm2d(c, eps=1e-3, momentum=0.01, device=device)


class _UpsampleMixin:
    """The up branches and the final deconv shared by both backbones."""

    def _build_ups(self, cfg, device):
        self.up_strides = list(cfg.get('UPSAMPLE_STRIDES', []))
        self.up_filters = list(cfg.get('NUM_UPSAMPLE_FILTERS', []))
        self.num_bev_features = sum(self.up_filters) if self.up_filters else cfg.NUM_FILTERS[-1]

    def _add_up(self, i: int, c_in: int, device) -> None:
        s, c = self.up_strides[i], self.up_filters[i]
        if s >= 1:
            self.add_module(f'up{i}_deconv', nn.ConvTranspose2d(c_in, c, s, stride=s, bias=False,
                                                                device=device))
        else:
            k = int(round(1 / s))
            self.add_module(f'up{i}_conv', nn.Conv2d(c_in, c, k, stride=k, bias=False,
                                                     device=device))
        self.add_module(f'up{i}_bn', _bn(c, device))

    def _add_final(self, n_levels: int, device) -> None:
        self.final = len(self.up_strides) > n_levels
        if self.final:      # from the levels' branches to the width of all strides
            s, c = self.up_strides[-1], sum(self.up_filters)
            self.up_final_deconv = nn.ConvTranspose2d(sum(self.up_filters[:n_levels]), c, s,
                                                      stride=s, bias=False, device=device)
            self.up_final_bn = _bn(c, device)

    def _up(self, i: int, x: torch.Tensor) -> torch.Tensor:
        u = (getattr(self, f'up{i}_deconv')(x) if self.up_strides[i] >= 1
             else conv_same(getattr(self, f'up{i}_conv'), x))
        return torch.relu(getattr(self, f'up{i}_bn')(u))

    def _merge(self, ups: list, x: torch.Tensor) -> torch.Tensor:
        if len(ups) > 1:
            x = torch.cat(ups, dim=1)
        elif len(ups) == 1:
            x = ups[0]
        if self.final:
            x = torch.relu(self.up_final_bn(self.up_final_deconv(x)))
        return x


class BaseBEVBackbone(_UpsampleMixin, nn.Module):
    def __init__(self, model_cfg, input_channels: int, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        self.layer_nums = list(cfg.get('LAYER_NUMS', []))
        strides = cfg.get('LAYER_STRIDES', [])
        filters = cfg.get('NUM_FILTERS', [])
        self._build_ups(cfg, device)
        c_in = input_channels
        for i, n in enumerate(self.layer_nums):
            self.add_module(f'down{i}_conv0', nn.Conv2d(c_in, filters[i], 3, stride=strides[i],
                                                        padding=1, bias=False, device=device))
            self.add_module(f'down{i}_bn0', _bn(filters[i], device))
            for k in range(n):
                self.add_module(f'down{i}_conv{k + 1}', nn.Conv2d(
                    filters[i], filters[i], 3, padding=1, bias=False, device=device))
                self.add_module(f'down{i}_bn{k + 1}', _bn(filters[i], device))
            c_in = filters[i]
            if i < len(self.up_strides):
                self._add_up(i, c_in, device)
        self._add_final(len(self.layer_nums), device)

    def forward(self, batch: dict) -> dict:
        x = batch['spatial_features'].permute(0, 3, 1, 2)     # NHWC -> NCHW
        ups = []
        for i, n in enumerate(self.layer_nums):
            for k in range(n + 1):
                x = getattr(self, f'down{i}_conv{k}')(x)
                x = torch.relu(getattr(self, f'down{i}_bn{k}')(x))
            if i < len(self.up_strides):
                ups.append(self._up(i, x))
        batch['spatial_features_2d'] = self._merge(ups, x).permute(0, 2, 3, 1)  # -> NHWC
        return batch


class BasicResBlock(nn.Module):
    """Conv-BN-ReLU-Conv-BN plus the identity, or a 1x1 Conv + BN of it
    (`down_conv`, `down_bn`) where the stride or the width changes, then
    ReLU; NCHW."""

    def __init__(self, in_channels: int, features: int, stride: int = 1, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, features, 3, stride=stride, padding=1, bias=False,
                               device=device)
        self.bn1 = _bn(features, device)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False, device=device)
        self.bn2 = _bn(features, device)
        self.down = stride != 1 or in_channels != features
        if self.down:
            self.down_conv = nn.Conv2d(in_channels, features, 1, stride=stride, bias=False,
                                       device=device)
            self.down_bn = _bn(features, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        identity = self.down_bn(self.down_conv(x)) if self.down else x
        return torch.relu(h + identity)


class BaseBEVResBackbone(_UpsampleMixin, nn.Module):
    """`BaseBEVBackbone`'s schema with residual blocks: level i is
    `stage<i>_block0` (at the level's stride) and LAYER_NUMS[i] more
    blocks. Like the JAX module it has no final deconv."""

    def __init__(self, model_cfg, input_channels: int, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        self.layer_nums = list(cfg.get('LAYER_NUMS', []))
        strides = cfg.get('LAYER_STRIDES', [])
        filters = cfg.get('NUM_FILTERS', [])
        self._build_ups(cfg, device)
        self.final = False
        c_in = input_channels
        for i, n in enumerate(self.layer_nums):
            self.add_module(f'stage{i}_block0', BasicResBlock(c_in, filters[i], strides[i],
                                                              device=device))
            for k in range(n):
                self.add_module(f'stage{i}_block{k + 1}', BasicResBlock(
                    filters[i], filters[i], device=device))
            c_in = filters[i]
            if i < len(self.up_strides):
                self._add_up(i, c_in, device)

    def forward(self, batch: dict) -> dict:
        x = batch['spatial_features'].permute(0, 3, 1, 2)
        ups = []
        for i, n in enumerate(self.layer_nums):
            for k in range(n + 1):
                x = getattr(self, f'stage{i}_block{k}')(x)
            if i < len(self.up_strides):
                ups.append(self._up(i, x))
        batch['spatial_features_2d'] = self._merge(ups, x).permute(0, 2, 3, 1)
        return batch
