"""Shared building blocks (counterpart of `pdm_ssd_tpu/models/layers.py`).

Channels-last like the JAX package. Submodule names follow flax's automatic
names (`Dense_0`, `BatchNorm_0`, ...) so that `utils/weights.from_flax` maps
the parameter tree one to one. flax BatchNorm momentum 0.9 is torch 0.1.

In training mode the BatchNorm layers here update the running variance with
the biased batch variance, as flax does; torch's own update uses the
unbiased one (larger by n / (n - 1) for n values per channel).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F


class _BiasedVarianceUpdate:
    """Mixin for torch BatchNorm classes: in training mode it normalises as
    torch does, lets torch write its running-variance update into a scratch
    copy, and rescales the batch term of that update from the unbiased to
    the biased variance (no second pass over the activations)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        keep = 1.0 - self.momentum
        old = self.running_var * keep
        scratch = self.running_var.clone()      # autograd keeps this one
        y = F.batch_norm(x, self.running_mean, scratch, self.weight, self.bias, True,
                         self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.copy_(old + (scratch - old) * ((n - 1) / n))
            self.num_batches_tracked.add_(1)
        return y


class BatchNorm2d(_BiasedVarianceUpdate, nn.BatchNorm2d):
    """BatchNorm over the channels of an NCHW map."""


class BatchNormLast(_BiasedVarianceUpdate, nn.BatchNorm1d):
    """BatchNorm over the last axis of a (..., C) tensor."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.reshape(-1, x.shape[-1])).reshape(x.shape)


class SharedMLP(nn.Module):
    """Stack of Linear(bias=False) + BatchNorm(eps 1e-5) + ReLU over the last axis."""

    def __init__(self, in_channels: int, channels: Sequence[int], device=None):
        super().__init__()
        self.n = len(channels)
        c_in = in_channels
        for j, c in enumerate(channels):
            self.add_module(f'Dense_{j}', nn.Linear(c_in, c, bias=False, device=device))
            self.add_module(f'BatchNorm_{j}', BatchNormLast(c, eps=1e-5, momentum=0.1,
                                                            device=device))
            c_in = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j in range(self.n):
            x = getattr(self, f'Dense_{j}')(x)
            x = torch.relu(getattr(self, f'BatchNorm_{j}')(x))
        return x


class FCStack(nn.Module):
    """Hidden Linear(bias=False) + BatchNorm(eps 1e-5) + ReLU blocks, then a
    final biased Linear (`make_fc_layers` analog)."""

    def __init__(self, in_channels: int, hidden: Sequence[int], out_channels: int,
                 final_bias_init: float = 0.0, device=None):
        super().__init__()
        self.n = len(hidden)
        c_in = in_channels
        for j, c in enumerate(hidden):
            self.add_module(f'Dense_{j}', nn.Linear(c_in, c, bias=False, device=device))
            self.add_module(f'BatchNorm_{j}', BatchNormLast(c, eps=1e-5, momentum=0.1,
                                                            device=device))
            c_in = c
        final = nn.Linear(c_in, out_channels, device=device)
        final.bias_init = final_bias_init
        self.add_module(f'Dense_{self.n}', final)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j in range(self.n):
            x = getattr(self, f'Dense_{j}')(x)
            x = torch.relu(getattr(self, f'BatchNorm_{j}')(x))
        return getattr(self, f'Dense_{self.n}')(x)


def same_padding(size: int, kernel: int, stride: int) -> tuple:
    """flax's 'SAME' padding of one axis, (before, after): the output has
    ceil(size / stride) cells and the odd cell of the padding goes after, so
    a stride-2 window over an even size starts at cell 0, not at -1 as
    torch's symmetric `padding=1` would start it."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`conv` applied to the NCHW map x with flax's 'SAME' padding (the
    module's own `padding` is not used)."""
    (top, bottom), (left, right) = (same_padding(n, k, s) for n, k, s in
                                    zip(x.shape[-2:], conv.kernel_size, conv.stride))
    if top == bottom and left == right:
        return F.conv2d(x, conv.weight, conv.bias, conv.stride, (top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), conv.weight, conv.bias, conv.stride)


class ConvBNReLU(nn.Module):
    """k x k Conv + BatchNorm(eps 1e-3) + ReLU on NCHW maps, with flax's
    'SAME' padding (`Conv_0`, `BatchNorm_0`)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 1,
                 use_bias: bool = False, device=None):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, features, kernel, stride=stride, bias=use_bias,
                                device=device)
        self.BatchNorm_0 = BatchNorm2d(features, eps=1e-3, momentum=0.01, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.BatchNorm_0(conv2d_same(self.Conv_0, x)))


def masked_max(x: torch.Tensor, mask: torch.Tensor | None, dim: int) -> torch.Tensor:
    """Max over `dim` of x (..., C) that ignores the slots where `mask`
    (x's shape without the channels) is false; a group with no valid slot
    gives zeros."""
    if mask is None:
        return x.amax(dim=dim)
    out = torch.where(mask[..., None], x, torch.finfo(x.dtype).min).amax(dim=dim)
    return torch.where(mask.any(dim=dim)[..., None], out, 0.0)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter and buffer from `generator`, in module order:
    weights uniform in +-1/sqrt(fan_in), or from the module's own
    `weight_init` (a function of the weight's shape, which draws nothing),
    biases at the module's `bias_init` (0 by default), BatchNorm at
    identity. The values do not depend on the model's device."""
    for mod in model.modules():
        if getattr(mod, 'weight_init', None) is not None:
            mod.weight.copy_(torch.as_tensor(mod.weight_init(tuple(mod.weight.shape))))
            if mod.bias is not None:
                mod.bias.fill_(getattr(mod, 'bias_init', 0.0))
        elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.fill_(0.0)
            mod.running_mean.fill_(0.0)
            mod.running_var.fill_(1.0)
            mod.num_batches_tracked.fill_(0)
        elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            bound = 1.0 / w[0].numel() ** 0.5     # torch's fan_in for all three
            vals = (torch.rand(w.shape, generator=generator) * 2 - 1) * bound
            w.copy_(vals)
            if mod.bias is not None:
                mod.bias.fill_(getattr(mod, 'bias_init', 0.0))
        elif isinstance(getattr(mod, 'kernel', None), nn.Parameter):
            # a sparse conv's (taps * in, out) kernel: fan_in is its first axis
            w = mod.kernel
            w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1) / w.shape[0] ** 0.5)
    return model
