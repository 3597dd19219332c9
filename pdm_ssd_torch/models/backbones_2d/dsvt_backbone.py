"""DSVT-style window-attention BEV backbone (counterpart of
`pdm_ssd_tpu/models/backbones_2d/dsvt_backbone.py`): the dense recast of
DSVT's set attention, in which a window is a static reshape of the BEV
lattice, the DSVT rotation alternates the order of the cells inside a window
(x-major, then y-major), and the empty cells are masked out of attention as
keys by occupancy.

Takes 'spatial_features' (B, H, W, C) and writes 'spatial_features_2d', NHWC
like the JAX package. Each stage pads H and W to window multiples, projects
to its width (`s<i>_proj`), runs its blocks (`s<i>_block<j>`: LayerNorm,
attention, residual, LayerNorm, FFN, residual), zeroes the unoccupied cells
and, at a stride above 1, max-pools the features and the occupancy with
flax's 'SAME' padding.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ...utils.config import as_cfg
from ..layers import LayerNorm, MultiHeadAttention, same_padding


class WindowSelfAttention(nn.Module):
    """One DSVT block: multi-head self-attention within each window, then the
    FFN, each behind a LayerNorm and a residual (`ln1`, `attn`, `ln2`,
    `ff1`, `ff2`)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, device=None):
        super().__init__()
        self.ln1 = LayerNorm(d_model, device=device)
        self.attn = MultiHeadAttention(d_model, d_model, nhead, device=device)
        self.ln2 = LayerNorm(d_model, device=device)
        self.ff1 = nn.Linear(d_model, dim_feedforward, device=device)
        self.ff2 = nn.Linear(dim_feedforward, d_model, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x (windows, S, C); mask (windows, S) True at the occupied cells,
        the keys each query may attend."""
        h = self.ln1(x)
        x = x + self.attn(h, mask=mask[:, None, None, :])
        h = self.ff2(torch.relu(self.ff1(self.ln2(x))))
        return x + h


def _max_pool_same(x: torch.Tensor, s: int) -> torch.Tensor:
    """flax's `max_pool(x, (s, s), strides=(s, s), padding='SAME')` of an NHWC
    map: the padding cells hold -inf."""
    (t, b), (l, r) = (same_padding(n, s, s) for n in x.shape[1:3])
    x = F.pad(x.permute(0, 3, 1, 2), (l, r, t, b), value=float('-inf'))
    return F.max_pool2d(x, s, s).permute(0, 2, 3, 1)


class DSVTBackbone(nn.Module):
    """Config: WINDOW_SHAPE [wx, wy], D_MODEL (per stage), NHEAD,
    DIM_FEEDFORWARD, BLOCKS_PER_STAGE, STAGE_STRIDES, with the JAX package's
    defaults."""

    def __init__(self, model_cfg, input_channels: int, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        self.wx, self.wy = cfg.get('WINDOW_SHAPE', [8, 8])
        d_models = list(cfg.D_MODEL)
        nheads = list(cfg.get('NHEAD', [4] * len(d_models)))
        dffs = list(cfg.get('DIM_FEEDFORWARD', [2 * d for d in d_models]))
        self.blocks = list(cfg.get('BLOCKS_PER_STAGE', [2] * len(d_models)))
        self.strides = list(cfg.get('STAGE_STRIDES', [1] + [2] * (len(d_models) - 1)))
        self.num_bev_features = d_models[-1]
        c_in = input_channels
        for si, dm in enumerate(d_models):
            self.add_module(f's{si}_proj', nn.Linear(c_in, dm, device=device))
            for bi in range(self.blocks[si]):
                self.add_module(f's{si}_block{bi}',
                                WindowSelfAttention(dm, nheads[si], dffs[si], device=device))
            c_in = dm

    def window(self, x: torch.Tensor, x_major: bool) -> torch.Tensor:
        """(B, H, W, ...) -> (B * windows, wy * wx, ...): the cells of each
        window y then x inside it (`x_major`), or x then y."""
        B, H, W = x.shape[:3]
        rest = x.shape[3:]
        xw = x.reshape(B, H // self.wy, self.wy, W // self.wx, self.wx, *rest)
        order = (0, 1, 3, 2, 4) if x_major else (0, 1, 3, 4, 2)
        xw = xw.permute(*order, *range(5, xw.dim()))
        return xw.reshape(-1, self.wy * self.wx, *rest)

    def unwindow(self, xw: torch.Tensor, shape, x_major: bool) -> torch.Tensor:
        B, H, W, C = shape
        if x_major:
            xw = xw.reshape(B, H // self.wy, W // self.wx, self.wy, self.wx, C)
            return xw.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)
        xw = xw.reshape(B, H // self.wy, W // self.wx, self.wx, self.wy, C)
        return xw.permute(0, 1, 4, 2, 3, 5).reshape(B, H, W, C)

    def forward(self, batch: dict) -> dict:
        x = batch['spatial_features']                                   # (B, H, W, C)
        occ = (x.abs() > 0).any(dim=-1)                                 # (B, H, W)
        for si, stride in enumerate(self.strides):
            H, W = x.shape[1:3]
            ph, pw = (-H) % self.wy, (-W) % self.wx
            if ph or pw:
                x = F.pad(x, (0, 0, 0, pw, 0, ph))
                occ = F.pad(occ, (0, pw, 0, ph))
            x = getattr(self, f's{si}_proj')(x)
            for bi in range(self.blocks[si]):
                x_major = bi % 2 == 0
                xw = getattr(self, f's{si}_block{bi}')(self.window(x, x_major),
                                                       self.window(occ, x_major))
                x = self.unwindow(xw, x.shape, x_major)
            x = torch.where(occ[..., None], x, 0.0)
            if stride > 1:
                x = _max_pool_same(x, stride)
                occ = _max_pool_same(occ[..., None].to(x.dtype), stride)[..., 0] > 0.5
        batch['spatial_features_2d'] = x
        return batch
