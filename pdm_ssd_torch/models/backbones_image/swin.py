"""Swin Transformer image backbone (counterpart of
`pdm_ssd_tpu/models/backbones_image/swin.py`), channels-last like the JAX
package.

A patch embedding (a `patch x patch` conv at that stride, flax 'SAME'
padding, then LayerNorm), stages of window-attention blocks, every second
block on windows shifted by half a window (a cyclic roll, with -100 added to
the scores of token pairs from different regions of the rolled map, built
from the window-id map as the JAX package builds it), and a patch merging
between stages (each 2 x 2 patch's four tokens concatenated in row-major
order, LayerNorm, a linear reduction to twice the width). Each stage pads
its map with zeros to window multiples before its blocks and crops it after;
the padded tokens take part in attention unmasked, as in the JAX package.

Drop path (stochastic depth, DROP_PATH_RATE rising linearly over the blocks)
keeps or drops each image's residual branch with a Bernoulli draw from the
`torch.Generator` passed to `forward`; without one it is the identity, as
the JAX package's is without a 'dropout' rng (its train step passes none).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ...utils.config import as_cfg
from ..layers import DeviceCache, LayerNorm, conv_same, same_padding


def relative_position_index(window: int) -> np.ndarray:
    """(S, S) row of the relative-position bias table each token pair reads,
    S = window^2."""
    w = window
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing='ij'), -1).reshape(-1, 2)
    rel = coords[:, None] - coords[None, :] + (w - 1)
    return rel[..., 0] * (2 * w - 1) + rel[..., 1]


def shift_mask(H: int, W: int, window: int, shift: int) -> np.ndarray:
    """(nW, S, S) additive mask of the shifted windows of an (H, W) map: -100
    between tokens of different regions of the rolled map (the window-id
    map of the JAX package, `swin.py:89-103`), 0 within one."""
    w = window
    ids = np.zeros((H, W), np.int32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            ids[hs, ws] = cnt
            cnt += 1
    ids = np.roll(ids, (-shift, -shift), axis=(0, 1))
    idw = ids.reshape(H // w, w, W // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    return ((idw[:, :, None] != idw[:, None, :]) * -100.0).astype(np.float32)


class WindowAttention(nn.Module):
    """Multi-head self-attention within each window (`qkv`, `proj`), with the
    relative-position bias `rel_bias` ((2 w - 1)^2, heads), a parameter of
    the module (normal 0.02). The scores are the products divided by
    sqrt(head width), as the JAX package orders them."""

    flax_params = {'rel_bias': 0.02}

    def __init__(self, dim: int, window: int, num_heads: int, device=None):
        super().__init__()
        self.dim, self.window, self.num_heads = dim, window, num_heads
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.rel_bias = nn.Parameter(torch.empty(((2 * window - 1) ** 2, num_heads),
                                                 device=device))
        self.proj = nn.Linear(dim, dim, device=device)
        self._index = relative_position_index(window).reshape(-1)
        self._cache = DeviceCache()

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """x (B, nW, S, C) windows; mask (nW, S, S) additive or None (the same
        for every image, as the JAX package's tiled mask is)."""
        B, nW, S, C = x.shape
        h = self.num_heads
        d = self.dim // h
        qkv = self.qkv(x).reshape(B, nW, S, 3, h, d)
        q, k, v = (qkv[:, :, :, i].transpose(2, 3) for i in range(3))     # (B, nW, h, S, d)
        attn = (q @ k.transpose(-2, -1)) / float(np.sqrt(d))
        idx = self._cache.get('index', x.device, lambda: self._index)
        bias = self.rel_bias[idx].reshape(S, S, h).permute(2, 0, 1)
        attn = attn + bias
        if mask is not None:
            attn = attn + mask[:, None]
        attn = torch.softmax(attn, dim=-1)
        out = (attn @ v).transpose(2, 3).reshape(B, nW, S, self.dim)
        return self.proj(out)


def drop_path(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Keep each image's (x's first axis) branch with probability 1 - rate,
    rescaled by 1 / (1 - rate); x itself without a generator or at rate 0."""
    if generator is None or rate <= 0:
        return x
    keep = 1.0 - rate
    draw = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=generator,
                      device=generator.device)
    return x * (draw < keep).to(x.dtype).to(x.device) / keep


class SwinBlock(nn.Module):
    """`ln1`, (shifted) window attention `attn`, residual, `ln2`, `mlp1`,
    exact (erf) GELU, `mlp2`, residual; drop path on both branches."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 drop_path_rate: float = 0.0, device=None):
        super().__init__()
        self.window, self.shift, self.drop_path_rate = window, shift, drop_path_rate
        self.ln1 = LayerNorm(dim, device=device)
        self.attn = WindowAttention(dim, window, num_heads, device=device)
        self.ln2 = LayerNorm(dim, device=device)
        self.mlp1 = nn.Linear(dim, 4 * dim, device=device)
        self.mlp2 = nn.Linear(4 * dim, dim, device=device)
        self._cache = DeviceCache()

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """x (B, H, W, C), H and W window multiples."""
        B, H, W, C = x.shape
        w, s = self.window, self.shift
        gen = generator if self.training else None
        shortcut = x
        x = self.ln1(x)
        if s:
            x = torch.roll(x, (-s, -s), dims=(1, 2))
        xw = x.reshape(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
        xw = xw.reshape(B, (H // w) * (W // w), w * w, C)
        mask = (self._cache.get(('mask', H, W), x.device, lambda: shift_mask(H, W, w, s))
                if s else None)
        xw = self.attn(xw, mask)
        x = xw.reshape(B, H // w, W // w, w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)
        if s:
            x = torch.roll(x, (s, s), dims=(1, 2))
        x = shortcut + drop_path(x, self.drop_path_rate, gen)
        h = self.mlp2(F.gelu(self.mlp1(self.ln2(x)), approximate='none'))
        return x + drop_path(h, self.drop_path_rate, gen)


class SwinTransformer(nn.Module):
    """Config: EMBED_DIM, DEPTHS and NUM_HEADS per stage, WINDOW_SIZE,
    PATCH_SIZE, DROP_PATH_RATE; RETURN_PYRAMID with OUT_INDICES (the stages'
    maps for a standalone neck, each behind LayerNorm `out_norm<i>` with
    OUT_NORM), or else the folded two-level FPN (`lat_top`, `lat_mid`,
    `fpn_out`) to OUT_CHANNEL at the last stage's resolution. Images (B, N,
    H, W, 3) in; a list of (B, N, h_i, w_i, C_i), or (B, N, h, w,
    OUT_CHANNEL), out."""

    def __init__(self, model_cfg, device=None):
        super().__init__()
        cfg = as_cfg(model_cfg)
        self.cfg = cfg
        embed = int(cfg.get('EMBED_DIM', 96))
        self.depths = list(cfg.get('DEPTHS', [2, 2, 2]))
        heads = list(cfg.get('NUM_HEADS', [3, 6, 12]))
        self.window = int(cfg.get('WINDOW_SIZE', 4))
        patch = int(cfg.get('PATCH_SIZE', 2))
        dpr = np.linspace(0, float(cfg.get('DROP_PATH_RATE', 0.0)), max(sum(self.depths), 1))
        self.patch_embed = nn.Conv2d(3, embed, patch, stride=patch, device=device)
        self.patch_ln = LayerNorm(embed, device=device)
        dim, blk = embed, 0
        self.widths = []
        for si, (depth, nh) in enumerate(zip(self.depths, heads)):
            for bi in range(depth):
                shift = (self.window // 2) if bi % 2 else 0
                self.add_module(f's{si}_b{bi}', SwinBlock(dim, nh, self.window, shift,
                                                          float(dpr[blk]), device=device))
                blk += 1
            self.widths.append(dim)
            if si < len(self.depths) - 1:
                self.add_module(f'merge_ln{si}', LayerNorm(4 * dim, device=device))
                self.add_module(f'merge{si}', nn.Linear(4 * dim, 2 * dim, device=device))
                dim *= 2
        self.pyramid = bool(cfg.get('RETURN_PYRAMID', False))
        if self.pyramid:
            self.out_indices = [int(i) for i in cfg.get('OUT_INDICES', range(len(self.depths)))]
            if cfg.get('OUT_NORM', False):
                for i in self.out_indices:
                    self.add_module(f'out_norm{i}', LayerNorm(self.widths[i], device=device))
        else:
            out = self.out_channels
            self.lat_top = nn.Linear(self.widths[-1], out, device=device)
            self.lat_mid = nn.Linear(self.widths[-2], out, device=device)
            self.fpn_out = nn.Conv2d(out, out, 3, padding=1, device=device)

    @property
    def out_channels(self) -> int:
        return int(self.cfg.get('OUT_CHANNEL', 256))

    def forward(self, images: torch.Tensor, generator: torch.Generator | None = None):
        B, N, H, W, _ = images.shape
        x = conv_same(self.patch_embed, images.reshape(B * N, H, W, 3).permute(0, 3, 1, 2))
        x = self.patch_ln(x.permute(0, 2, 3, 1))
        feats = []
        for si, depth in enumerate(self.depths):
            h_, w_ = x.shape[1:3]
            ph, pw = (-h_) % self.window, (-w_) % self.window
            if ph or pw:
                x = F.pad(x, (0, 0, 0, pw, 0, ph))
            for bi in range(depth):
                x = getattr(self, f's{si}_b{bi}')(x, generator)
            x = x[:, :h_, :w_]
            feats.append(x)
            if si < len(self.depths) - 1:
                n, h_, w_, c = x.shape
                x = x[:, :h_ - h_ % 2, :w_ - w_ % 2]
                x = x.reshape(n, h_ // 2, 2, w_ // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
                x = x.reshape(n, h_ // 2, w_ // 2, 4 * c)
                x = getattr(self, f'merge{si}')(getattr(self, f'merge_ln{si}')(x))
        if self.pyramid:
            outs = []
            for i in self.out_indices:
                f = feats[i]
                if hasattr(self, f'out_norm{i}'):
                    f = getattr(self, f'out_norm{i}')(f)
                outs.append(f.reshape(B, N, *f.shape[1:]))
            return outs
        # the finer stage's lateral average-pooled down (flax 'SAME', the
        # padding counted) and added to the last stage's, then a 3x3 conv
        top = self.lat_top(feats[-1]).permute(0, 3, 1, 2)
        lat = self.lat_mid(feats[-2]).permute(0, 3, 1, 2)
        pads = [same_padding(n, 2, 2) for n in lat.shape[2:]]
        lat = F.avg_pool2d(F.pad(lat, (*pads[1], *pads[0])), 2, 2)
        top = self.fpn_out(top + lat[:, :, :top.shape[2], :top.shape[3]])
        return top.permute(0, 2, 3, 1).reshape(B, N, *top.shape[2:], top.shape[1])
