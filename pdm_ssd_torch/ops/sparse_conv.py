"""Gather-matmul sparse convolution: the one arithmetic op of the sparse
voxel ladder.

    out[b, v, :] = sum_k feats[b, nbr[b, v, k], :] @ W[k]

`feats` (B, Vin, Cin) is a stage's slot table, `nbr` (B, Vout, K) a kernel map
of `ops/sparse_maps.py` whose entries outside [0, Vin) (the maps hold
`Vin` there) are absent taps and contribute nothing, `W` (K*Cin, Cout) the weights
with the taps outer, as flax stores them. `sparse_conv_plain` is the plain
PyTorch version (the JAX package's `gather_taps` + `dot_general`: a gather
through the flat table with one zero row per cloud, then one matmul);
`sparse_conv_cuda` wraps the Hopper kernel of `csrc/sparse_conv.cu`, which
skips absent taps instead of reading a zero row and computes the product in
its own body. `ops/dispatch.sparse_conv` picks by the tensor's device. The
wrapper counts its launches in `sparse_conv_cuda.launches`.

Neither differentiates: the ladder's backward (a gather through the
transposed map) is not ported yet, and the wrapper refuses an input that
requires a gradient while gradients are enabled.
"""
from __future__ import annotations

import torch

from . import kernels
from .group import _need, _need_contiguous

# rows of the gathered (rows, K * Cin) block that the plain version holds at once
PLAIN_CHUNK_ROWS = 32768


def _flat_table(feats: torch.Tensor, nbr: torch.Tensor):
    """The batch's tables as one (B * (Vin + 1), C) table with a zero row at
    slot `Vin` of each cloud, and nbr as (B * Vout, K) int64 rows of it; an
    entry outside [0, Vin) names the zero row."""
    B, Vin, C = feats.shape
    table = torch.cat([feats, feats.new_zeros((B, 1, C))], dim=1).reshape(B * (Vin + 1), C)
    idx = nbr.long()
    idx = torch.where((idx < 0) | (idx > Vin), Vin, idx)
    boff = (torch.arange(B, device=nbr.device) * (Vin + 1))[:, None, None]
    return table, (idx + boff).reshape(B * nbr.shape[1], nbr.shape[2])


def gather_taps(feats: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """feats (B, Vin, C), nbr (B, Vout, K) with `Vin` meaning absent ->
    (B, Vout, K*C), zeros where a tap is absent."""
    table, idx = _flat_table(feats, nbr)
    return table[idx.reshape(-1)].reshape(nbr.shape[0], nbr.shape[1], -1)


def sparse_conv_plain(feats: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Plain version of `sparse_conv_cuda`, any device and float type. The
    rows are walked in chunks so the gathered block never exists whole."""
    K, C = nbr.shape[2], feats.shape[2]
    if weight.shape[0] != K * C:
        raise ValueError(f'weight {tuple(weight.shape)} does not fit K={K}, Cin={C}')
    table, idx = _flat_table(feats, nbr)
    out = feats.new_empty((idx.shape[0], weight.shape[1]))
    for r0 in range(0, idx.shape[0], PLAIN_CHUNK_ROWS):
        rows = idx[r0:r0 + PLAIN_CHUNK_ROWS]
        out[r0:r0 + PLAIN_CHUNK_ROWS] = table[rows.reshape(-1)].reshape(rows.shape[0], K * C) @ weight
    return out.reshape(nbr.shape[0], nbr.shape[1], -1)


def sparse_conv_cuda(feats: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """One launch of `sparse_conv_kernel` for the whole batch. feats (B, Vin,
    Cin) float32, nbr (B, Vout, K) int32, weight (K*Cin, Cout) float32, all
    contiguous CUDA tensors. Returns (B, Vout, Cout) float32. Does not
    synchronize. Raises where a gradient would be recorded: it has no backward."""
    if torch.is_grad_enabled() and (feats.requires_grad or weight.requires_grad):
        raise NotImplementedError('sparse_conv has no backward kernel yet (ROADMAP Queue 2 '
                                  'item 8): call it with gradients disabled')
    _need(feats, 'feats', torch.float32, 3)
    _need(nbr, 'nbr', torch.int32, 3)
    _need(weight, 'weight', torch.float32, 2)
    for t, name in ((feats, 'feats'), (nbr, 'nbr'), (weight, 'weight')):
        _need_contiguous(t, name)
        if t.device != feats.device:
            raise ValueError(f'{name} is on {t.device}, feats on {feats.device}')
    B, Vin, Cin = feats.shape
    Vout, K = nbr.shape[1], nbr.shape[2]
    Cout = weight.shape[1]
    lib = kernels.load()
    if nbr.shape[0] != B or weight.shape[0] != K * Cin or min(B, Vin, Vout, K, Cin, Cout) < 1:
        raise ValueError(f'feats {tuple(feats.shape)}, nbr {tuple(nbr.shape)} and weight '
                         f'{tuple(weight.shape)} disagree')
    if K > lib.sparse_conv_max_taps() or Cout > lib.sparse_conv_max_cout():
        raise ValueError(f'the kernel takes up to {lib.sparse_conv_max_taps()} taps and '
                         f'{lib.sparse_conv_max_cout()} output channels, got K={K}, Cout={Cout}')
    out = torch.empty((B, Vout, Cout), dtype=torch.float32, device=feats.device)
    index = feats.device.index
    with kernels.on_device(index):
        err = lib.sparse_conv_launch(feats.data_ptr(), nbr.data_ptr(), weight.data_ptr(),
                                     out.data_ptr(), B, Vin, Vout, K, Cin, Cout,
                                     kernels.stream(index))
    if err != 0:
        raise RuntimeError(f'sparse_conv_launch failed with CUDA error {err}')
    sparse_conv_cuda.launches += 1
    return out


sparse_conv_cuda.launches = 0
