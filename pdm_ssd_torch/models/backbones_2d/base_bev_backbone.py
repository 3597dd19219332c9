"""2D BEV conv backbone (counterpart of `BaseBEVBackbone` in
`pdm_ssd_tpu/models/backbones_2d/base_bev_backbone.py`).

Takes and returns NHWC maps like the JAX package and runs the convolutions
in NCHW. BatchNorm eps is 1e-3 here (flax momentum 0.99 = torch 0.01).
"""
from __future__ import annotations

import torch
from torch import nn

from ...utils.config import as_cfg
from ..layers import BatchNorm2d


def _bn(c, device):
    return BatchNorm2d(c, eps=1e-3, momentum=0.01, device=device)


class BaseBEVBackbone(nn.Module):
    def __init__(self, model_cfg, input_channels: int, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        self.layer_nums = list(cfg.get('LAYER_NUMS', []))
        strides = cfg.get('LAYER_STRIDES', [])
        filters = cfg.get('NUM_FILTERS', [])
        self.up_strides = list(cfg.get('UPSAMPLE_STRIDES', []))
        up_filters = cfg.get('NUM_UPSAMPLE_FILTERS', [])
        if len(self.up_strides) > len(self.layer_nums) or any(s < 1 for s in self.up_strides):
            raise NotImplementedError('only UPSAMPLE_STRIDES >= 1, one per level, are ported')
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
                s = self.up_strides[i]
                self.add_module(f'up{i}_deconv', nn.ConvTranspose2d(
                    c_in, up_filters[i], s, stride=s, bias=False, device=device))
                self.add_module(f'up{i}_bn', _bn(up_filters[i], device))
        self.num_bev_features = sum(up_filters) if len(up_filters) > 0 else filters[-1]

    def forward(self, batch: dict) -> dict:
        x = batch['spatial_features'].permute(0, 3, 1, 2)     # NHWC -> NCHW
        ups = []
        for i, n in enumerate(self.layer_nums):
            for k in range(n + 1):
                x = getattr(self, f'down{i}_conv{k}')(x)
                x = torch.relu(getattr(self, f'down{i}_bn{k}')(x))
            if i < len(self.up_strides):
                u = getattr(self, f'up{i}_deconv')(x)
                ups.append(torch.relu(getattr(self, f'up{i}_bn')(u)))
        if len(ups) > 1:
            x = torch.cat(ups, dim=1)
        elif len(ups) == 1:
            x = ups[0]
        batch['spatial_features_2d'] = x.permute(0, 2, 3, 1)  # NCHW -> NHWC
        return batch
