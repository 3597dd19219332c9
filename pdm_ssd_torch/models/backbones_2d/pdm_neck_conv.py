"""PDM neck in grid form (counterpart of
`pdm_ssd_tpu/models/backbones_2d/pdm_neck_conv.py`): point dilation as a
convolution. A 1x1 projection gives each cell solid-harmonic coefficients
(`sh_proj`); a WINDOW x WINDOW convolution (`dilate`) spreads them over the
dilation window, starting from the analytic solid-harmonic x Gaussian
kernel; then BatchNorm and ReLU. Output 'spatial_features' (B, h, w,
NUM_Z_BINS * NUM_BEV_FEATURES), NHWC; the convolutions run in NCHW.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...utils.config import as_cfg
from ..layers import BatchNorm2d, conv2d_same

N_SH = 9


def sh_gaussian_kernel_init(window: int, n_sh: int, num_z: int, sigma: float,
                            z_extent: float = 1.0) -> np.ndarray:
    """(window, window, n_sh, num_z) analytic kernel K[dy, dx, s, z] =
    gauss(o) * Y_s(o) at the integer cell offsets o = (dx, dy, z_k), in the
    JAX package's order of float32 operations."""
    r = window // 2
    K = np.zeros((window, window, n_sh, num_z), np.float32)
    zs = (np.arange(num_z) - (num_z - 1) / 2.0) * (2.0 * z_extent / max(num_z, 1))
    for iy in range(window):
        for ix in range(window):
            for iz in range(num_z):
                o = np.array([ix - r, iy - r, zs[iz]], np.float32) / max(sigma, 1e-6)
                g = float(np.exp(-0.5 * np.sum(o * o)))
                x_, y_, z_ = float(o[0]), float(o[1]), float(o[2])
                r2 = x_ * x_ + y_ * y_ + z_ * z_
                y = np.array([1.0, x_, y_, z_, x_ * y_, y_ * z_,
                              3 * z_ * z_ - r2, x_ * z_, x_ * x_ - y_ * y_], np.float32)
                K[iy, ix, :, iz] = g * y
    return K


def dilate_weight(window: int, num_bev: int, num_z: int, sigma: float) -> np.ndarray:
    """The initial `dilate` weight in torch's layout (Dz*C', 9*C', win, win):
    block-diagonal in the channels, input s*C'+c to output z*C'+c carrying
    K[:, :, s, z]."""
    K = sh_gaussian_kernel_init(window, N_SH, num_z, sigma)
    full = np.zeros((num_z * num_bev, N_SH * num_bev, window, window), np.float32)
    c = np.arange(num_bev)
    for s in range(N_SH):
        for z in range(num_z):
            full[z * num_bev + c, s * num_bev + c] = K[:, :, s, z]
    return full


class PDMNeckConv(nn.Module):
    """Config: WINDOW (5), NUM_BEV_FEATURES C', NUM_Z_BINS, GAUSSIAN_SIGMA."""

    def __init__(self, model_cfg, in_channels: int, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        self.cfg = cfg
        cp, dz = cfg.NUM_BEV_FEATURES, cfg.NUM_Z_BINS
        window = cfg.get('WINDOW', 5)
        sigma = cfg.get('GAUSSIAN_SIGMA', 1.2)
        self.sh_proj = nn.Conv2d(in_channels, N_SH * cp, 1, bias=False, device=device)
        self.dilate = nn.Conv2d(N_SH * cp, dz * cp, window, bias=False, device=device)
        self.dilate.weight_init = lambda shape: dilate_weight(window, cp, dz, sigma)
        self.bn = BatchNorm2d(dz * cp, eps=1e-3, momentum=0.01, device=device)

    @property
    def num_bev_features(self) -> int:
        return self.cfg.NUM_BEV_FEATURES * self.cfg.NUM_Z_BINS

    def forward(self, batch: dict) -> dict:
        x = batch['spatial_features'].permute(0, 3, 1, 2)          # NHWC -> NCHW
        out = conv2d_same(self.dilate, self.sh_proj(x))
        out = torch.relu(self.bn(out))
        batch['spatial_features'] = out.permute(0, 2, 3, 1)          # NCHW -> NHWC
        return batch
