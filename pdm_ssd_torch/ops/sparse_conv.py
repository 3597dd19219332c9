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
computes only the taps each tile of rows has. `ops/dispatch.sparse_conv`
picks by the tensor's device. The wrapper counts its launches in
`sparse_conv_cuda.launches`.

`sparse_conv_plan(nbr, Vin)` is the kernel's launch plan for one map: each
cloud's output rows sorted by their tap mask, and each tile's OR of its rows'
masks, built with torch ops of fixed shape on the map's device and no host
sync. Layers that share a map share its plan; the plain version ignores it.

Neither differentiates: the ladder's backward (a gather through the
transposed map) is not ported yet, and the wrapper refuses an input that
requires a gradient while gradients are enabled.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import kernels
from .group import _need, _need_contiguous

# rows of the gathered (rows, K * Cin) block that the plain version holds at once
PLAIN_CHUNK_ROWS = 32768
# output rows of one tile of the kernel (`kTileRows` of csrc/sparse_conv.cu)
TILE_ROWS = 64


class SparseConvPlan(NamedTuple):
    order: torch.Tensor       # (B, Vout) int32: each cloud's rows sorted by tap mask
    tile_mask: torch.Tensor   # (B, ceil(Vout / TILE_ROWS)) int32: OR of a tile's row masks
    vin: int                  # the table's rows: an entry outside [0, vin) is absent


@functools.lru_cache(maxsize=None)
def _tap_bits(K: int, device: torch.device) -> torch.Tensor:
    """(K,) int32 powers of two on `device`, made once per device and K."""
    return torch.tensor([1 << k for k in range(K)], dtype=torch.int32, device=device)


def _present(nbr: torch.Tensor, Vin: int) -> torch.Tensor:
    return (nbr >= 0) & (nbr < Vin)


def tap_masks(nbr: torch.Tensor, Vin: int) -> torch.Tensor:
    """(B, Vout) int32: bit k set where 0 <= nbr[b, v, k] < Vin."""
    return (_present(nbr, Vin) * _tap_bits(nbr.shape[2], nbr.device)).sum(-1, dtype=torch.int32)


def sparse_conv_plan(nbr: torch.Tensor, Vin: int) -> SparseConvPlan:
    """The kernel's plan for map `nbr` (B, Vout, K) over a table of `Vin`
    rows: each cloud's rows in ascending order of their tap mask (a stable
    sort, so equal masks keep slot order), and per tile of TILE_ROWS sorted
    rows the OR of their masks (padding rows past Vout have none). About a
    dozen launches of fixed shape, mostly over the (B, Vout, K) bools of the
    taps present, and no host sync."""
    B, V, K = nbr.shape
    if K > 31:
        raise ValueError(f'a tap mask holds at most 31 taps, got K={K}')
    present = _present(nbr, Vin)
    bits = _tap_bits(K, nbr.device)
    order = torch.argsort((present * bits).sum(-1, dtype=torch.int32), dim=1, stable=True)
    tiles = -(-V // TILE_ROWS)
    ranked = present.gather(1, order[..., None].expand(-1, -1, K))
    if tiles * TILE_ROWS > V:
        ranked = torch.cat([ranked, ranked.new_zeros((B, tiles * TILE_ROWS - V, K))], dim=1)
    has_tap = ranked.view(B, tiles, TILE_ROWS, K).any(2)                 # (B, tiles, K)
    return SparseConvPlan(order.to(torch.int32), (has_tap * bits).sum(-1, dtype=torch.int32),
                          int(Vin))


def plan_work(plan: SparseConvPlan, nbr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(taps the kernel computes, taps present), 0-dim int64 tensors on the
    map's device: a tile computes TILE_ROWS rows of every tap in its mask."""
    shifts = torch.arange(nbr.shape[2], dtype=torch.int32, device=nbr.device)
    per_tile = ((plan.tile_mask[..., None] >> shifts) & 1).sum(dtype=torch.int64)
    return per_tile * TILE_ROWS, _present(nbr, plan.vin).sum(dtype=torch.int64)


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


def sparse_conv_cuda(feats: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
                     plan: SparseConvPlan | None = None) -> torch.Tensor:
    """One launch of `sparse_conv_kernel` for the whole batch. feats (B, Vin,
    Cin) float32, nbr (B, Vout, K) int32, weight (K*Cin, Cout) float32, all
    contiguous CUDA tensors; `plan` is `sparse_conv_plan(nbr, Vin)`, built
    here when not given. Returns (B, Vout, Cout) float32. Does not
    synchronize. Raises where a gradient would be recorded: it has no backward."""
    if torch.is_grad_enabled() and (feats.requires_grad or weight.requires_grad):
        raise NotImplementedError('sparse_conv has no backward kernel yet (ROADMAP Queue 2 '
                                  'item 9.1): call it with gradients disabled')
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
    if plan is None:
        plan = sparse_conv_plan(nbr, Vin)
    tiles = -(-Vout // TILE_ROWS)
    if (plan.vin != Vin or tuple(plan.order.shape) != (B, Vout)
            or tuple(plan.tile_mask.shape) != (B, tiles)):
        raise ValueError(f'the plan (order {tuple(plan.order.shape)}, tile_mask '
                         f'{tuple(plan.tile_mask.shape)}, Vin {plan.vin}) is not one of this '
                         f'map (B={B}, Vout={Vout}, Vin={Vin})')
    for t, name in ((plan.order, 'plan.order'), (plan.tile_mask, 'plan.tile_mask')):
        _need(t, name, torch.int32, 2)
        _need_contiguous(t, name)
        if t.device != feats.device:
            raise ValueError(f'{name} is on {t.device}, feats on {feats.device}')
    out = torch.empty((B, Vout, Cout), dtype=torch.float32, device=feats.device)
    index = feats.device.index
    with kernels.on_device(index):
        err = lib.sparse_conv_launch(feats.data_ptr(), nbr.data_ptr(), weight.data_ptr(),
                                     plan.order.data_ptr(), plan.tile_mask.data_ptr(),
                                     out.data_ptr(), B, Vin, Vout, K, Cin, Cout, TILE_ROWS,
                                     kernels.stream(index))
    if err != 0:
        raise RuntimeError(f'sparse_conv_launch failed with CUDA error {err}')
    sparse_conv_cuda.launches += 1
    return out


sparse_conv_cuda.launches = 0
