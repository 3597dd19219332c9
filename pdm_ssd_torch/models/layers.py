"""Shared building blocks (counterpart of `pdm_ssd_tpu/models/layers.py`).

Channels-last like the JAX package. Submodule names follow flax's automatic
names (`Dense_0`, `BatchNorm_0`, ...) so that `utils/weights.from_flax` maps
the parameter tree one to one. flax BatchNorm momentum 0.9 is torch 0.1.

In training mode the BatchNorm layers here take their batch statistics as
flax's BatchNorm does (the variance as E[x^2] - E[x]^2) and move the running
variance towards that biased variance; torch's own update uses the unbiased
one (larger by n / (n - 1) for n values per channel).
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..parallel import ddp


class _FlaxBatchStatistics:
    """Mixin for torch BatchNorm classes: in training mode, flax's BatchNorm
    forward. The batch variance is E[x^2] - E[x]^2 (at least 0), as flax
    takes it by default (`use_fast_variance`), where torch takes E[(x -
    E[x])^2]: where a channel's mean lies far above its deviation (a mostly
    empty map) the two differ beyond float32 rounding, and the gradients
    through BatchNorm with them. The running statistics move towards the
    batch mean and that biased variance, in flax's order of operations.

    While `stats_frozen` is set (the recomputation of a checkpointed block,
    `checkpoint_block`) it normalises the same way and updates nothing, so a
    step updates the running statistics once, as flax's `nn.remat` does.
    `stat_updates` is how many times one training call moves them: a layer
    that stands for k calls of flax's on one input moves them k times with
    the one batch's statistics, as those k calls would.

    Under data parallelism the statistics are the global batch's, as on the
    JAX package's mesh: Σx, Σx² and the count are summed over the ranks
    through autograd (`parallel.sync_sum`). Every rank recomputes a
    checkpointed block the same way, so the collectives stay matched."""

    stats_frozen = False
    stat_updates = 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        dims = [d for d in range(x.dim()) if d != 1]
        C = x.shape[1]
        shape = [1, C] + [1] * (x.dim() - 2)
        sums = ddp.sync_sum(torch.cat([x.sum(dims), (x * x).sum(dims),
                                       x.new_full((1,), x.numel() // C)]))
        mean, msq = sums[:C] / sums[-1], sums[C:2 * C] / sums[-1]
        var = torch.clamp(msq - mean * mean, min=0.0)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)
        if not self.stats_frozen:
            with torch.no_grad():
                for _ in range(self.stat_updates):
                    self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                    self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
                    self.num_batches_tracked.add_(1)
        return y


class BatchNorm2d(_FlaxBatchStatistics, nn.BatchNorm2d):
    """BatchNorm over the channels of an NCHW map."""


class BatchNorm3d(_FlaxBatchStatistics, nn.BatchNorm3d):
    """BatchNorm over the channels of an NCDHW volume."""


class BatchNormLast(_FlaxBatchStatistics, nn.BatchNorm1d):
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


def conv_same(conv: nn.Conv2d | nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """`conv` (2D or 3D) applied to the NCHW map or NCDHW volume x with
    flax's 'SAME' padding (the module's own `padding` is not used)."""
    nd = len(conv.kernel_size)
    pads = [same_padding(n, k, s) for n, k, s in zip(x.shape[-nd:], conv.kernel_size,
                                                     conv.stride)]
    fn = F.conv2d if nd == 2 else F.conv3d
    if all(a == b for a, b in pads):
        return fn(x, conv.weight, conv.bias, conv.stride, tuple(a for a, _ in pads))
    flat = [p for pair in reversed(pads) for p in pair]     # F.pad lists the last axis first
    return fn(F.pad(x, flat), conv.weight, conv.bias, conv.stride)


class DeviceCache:
    """Constant tensors made from numpy once per device (not module state:
    `to_empty` would clear a buffer), outside inference mode, so that a
    tensor first made under `predict` may take part in a training step."""

    def __init__(self):
        self._made = {}

    def get(self, key, device, make):
        key = (key, str(device))
        if key not in self._made:
            with torch.inference_mode(False):
                self._made[key] = torch.as_tensor(make(), device=device)
        return self._made[key]


class _FrozenStats:
    """Context in which the BatchNorm layers of a module update nothing."""

    def __init__(self, module: nn.Module):
        self.norms = [m for m in module.modules() if isinstance(m, _FlaxBatchStatistics)]

    def __enter__(self):
        for m in self.norms:
            m.stats_frozen = True

    def __exit__(self, *exc):
        for m in self.norms:
            m.stats_frozen = False


def checkpoint_block(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """`block(x)` with its activations recomputed in the backward pass
    (`torch.utils.checkpoint`), the analog of flax's `nn.remat`. The
    recomputation runs the block's BatchNorm layers with their statistics
    frozen, so one step updates them once."""
    return checkpoint_call(block, block, x)


def checkpoint_call(module: nn.Module, fn, *args):
    """`fn(*args)` with its activations recomputed in the backward pass, the
    BatchNorm layers of `module` (those `fn` runs) frozen in the
    recomputation, as `checkpoint_block` freezes a block's."""
    from torch.utils.checkpoint import checkpoint
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), _FrozenStats(module)))


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
        return torch.relu(self.BatchNorm_0(conv_same(self.Conv_0, x)))


class LayerNorm(nn.LayerNorm):
    """flax's LayerNorm over the last axis: epsilon 1e-6 and the variance as
    E[x^2] - E[x]^2 (at least 0), the scale folded into the reciprocal
    deviation before the product, as flax orders it (`scale`, `bias` are
    `weight`, `bias` here)."""

    def __init__(self, features: int, eps: float = 1e-6, device=None):
        super().__init__(features, eps=eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class HeadsLinear(nn.Linear):
    """A Linear whose flax counterpart is a `DenseGeneral` of several axes:
    `flax_kernel` and `flax_bias` are the flax shapes of its kernel and bias
    (`utils/weights` reshapes between them and the torch weight's)."""

    def __init__(self, in_features: int, out_features: int, flax_kernel: tuple,
                 flax_bias: tuple, device=None):
        super().__init__(in_features, out_features, device=device)
        self.flax_kernel, self.flax_bias = tuple(flax_kernel), tuple(flax_bias)


class MultiHeadAttention(nn.Module):
    """flax's `MultiHeadDotProductAttention` (`query`, `key`, `value`, `out`)
    as plain tensor ops: the query scaled by 1 / sqrt(head_dim) before the
    product, masked scores filled with the float32 minimum (not -inf, so a
    query whose keys are all masked weighs them uniformly instead of giving
    NaN), softmax in the scores' type."""

    def __init__(self, in_features: int, qkv_features: int, num_heads: int,
                 out_features: int | None = None, device=None):
        super().__init__()
        if qkv_features % num_heads:
            raise ValueError(f'qkv_features {qkv_features} is not a multiple of {num_heads} heads')
        self.num_heads, self.head_dim = num_heads, qkv_features // num_heads
        out_features = out_features or in_features
        for name in ('query', 'key', 'value'):
            self.add_module(name, HeadsLinear(in_features, qkv_features,
                                              (in_features, num_heads, self.head_dim),
                                              (num_heads, self.head_dim), device=device))
        self.out = HeadsLinear(qkv_features, out_features,
                               (num_heads, self.head_dim, out_features), (out_features,),
                               device=device)

    def forward(self, inputs_q: torch.Tensor, inputs_k: torch.Tensor | None = None,
                inputs_v: torch.Tensor | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        """inputs (..., L, C); keys default to the queries and values to the
        keys, as in flax; mask broadcast to (..., heads, Lq, Lk), True where
        a query may attend a key."""
        inputs_k = inputs_q if inputs_k is None else inputs_k
        inputs_v = inputs_k if inputs_v is None else inputs_v

        def heads(layer, x):
            return layer(x).unflatten(-1, (self.num_heads, self.head_dim)).transpose(-3, -2)

        q = heads(self.query, inputs_q)                                 # (..., h, Lq, d)
        k, v = heads(self.key, inputs_k), heads(self.value, inputs_v)
        q = q / torch.sqrt(torch.tensor(float(self.head_dim), dtype=q.dtype))
        scores = q @ k.transpose(-2, -1)                                # (..., h, Lq, Lk)
        if mask is not None:
            scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        weights = torch.softmax(scores, dim=-1)
        x = (weights @ v).transpose(-3, -2).flatten(-2)                 # (..., Lq, h * d)
        return self.out(x)


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
    biases at the module's `bias_init` (0 by default), BatchNorm and
    LayerNorm at identity, an embedding's rows uniform in +-1/sqrt(width),
    a parameter a module holds itself (named in its `flax_params`, with its
    deviation) normal.
    The values do not depend on the model's device."""
    for mod in model.modules():
        for name, std in getattr(mod, 'flax_params', {}).items():
            p = getattr(mod, name)
            p.copy_(torch.randn(p.shape, generator=generator) * std)
        if getattr(mod, 'weight_init', None) is not None:
            mod.weight.copy_(torch.as_tensor(mod.weight_init(tuple(mod.weight.shape))))
            if mod.bias is not None:
                mod.bias.fill_(getattr(mod, 'bias_init', 0.0))
        elif isinstance(mod, (nn.modules.batchnorm._BatchNorm, nn.LayerNorm)):
            mod.weight.fill_(1.0)
            mod.bias.fill_(0.0)
            if isinstance(mod, nn.modules.batchnorm._BatchNorm):
                mod.running_mean.fill_(0.0)
                mod.running_var.fill_(1.0)
                mod.num_batches_tracked.fill_(0)
        elif isinstance(mod, nn.Embedding):
            w = mod.weight
            w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1) / w.shape[1] ** 0.5)
        elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
                              nn.ConvTranspose3d)):
            w = mod.weight
            bound = 1.0 / w[0].numel() ** 0.5     # torch's fan_in for all five
            vals = (torch.rand(w.shape, generator=generator) * 2 - 1) * bound
            w.copy_(vals)
            if mod.bias is not None:
                mod.bias.fill_(getattr(mod, 'bias_init', 0.0))
        elif isinstance(getattr(mod, 'kernel', None), nn.Parameter):
            # a sparse conv's (taps * in, out) kernel: fan_in is its first axis
            w = mod.kernel
            w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1) / w.shape[0] ** 0.5)
    return model
