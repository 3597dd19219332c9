"""Gather-matmul sparse convolution: the one arithmetic op of the sparse
voxel ladder, and its backward.

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

The backward (`SparseConvFunction`, the counterpart of the JAX package's
`sparse_conv_mm` custom VJP) is two products:
- the data gradient `d_feats = gather(dy, bwd_nbr) @ flip(W)`: the same
  function as the forward, through the transposed map `bwd_nbr` (B, Vin, K)
  (`sparse_maps.invert_down_map` for a strided conv, the map itself for a
  submanifold one, whose offsets are symmetric) with W's taps reversed and
  each tap transposed (`flip_weight`); on the card the forward kernel through
  a plan of that map;
- the weight gradient `dW[k] = sum_v gather(feats, nbr)[v, k]^T dy[v]`,
  written through the forward map: `sparse_conv_wgrad_plain`, and on the
  card `sparse_conv_wgrad_cuda` (`csrc/sparse_conv_wgrad.cu`), which walks
  the tiles of output rows in slot order that hold a tap, three taps a row
  of blocks (`wgrad_plan`), and sums its partials in a fixed order
  (`sparse_conv_wgrad_cuda.launches`).
The raw wrappers record no gradient: gradients flow through the Function.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import kernels
from .group import _need, _need_contiguous

# rows of the gathered (rows, K * Cin) block that the plain version holds at once
PLAIN_CHUNK_ROWS = 32768
# output rows of one tile of the kernel (`kTileRows` of csrc/sparse_conv.cu)
TILE_ROWS = 64
# the multiprocessors of an H100: the weight gradient's first launch is one
# wave of its blocks on them
WGRAD_SMS = 132
# taps of a row of the weight gradient's blocks, and most tiles a block walks
# (csrc/sparse_conv_wgrad.cu refuses a launch that breaks either)
WGRAD_ROW_TAPS = 3
WGRAD_MAX_TILES = 1024


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


def flip_weight(weight: torch.Tensor, K: int) -> torch.Tensor:
    """The data gradient's weight: W (K*Cin, Cout) -> (K*Cout, Cin), the taps
    reversed and each tap's (Cin, Cout) block transposed."""
    Cin, Cout = weight.shape[0] // K, weight.shape[1]
    return weight.reshape(K, Cin, Cout).flip(0).transpose(1, 2).reshape(K * Cout, Cin)


def sparse_conv_dgrad_plain(dy: torch.Tensor, bwd_nbr: torch.Tensor,
                            weight: torch.Tensor) -> torch.Tensor:
    """d_feats (B, Vin, Cin) of dy (B, Vout, Cout) through the transposed map
    bwd_nbr (B, Vin, K), whose entries outside [0, Vout) are absent."""
    return sparse_conv_plain(dy, bwd_nbr, flip_weight(weight, bwd_nbr.shape[2]))


def sparse_conv_wgrad_plain(feats: torch.Tensor, nbr: torch.Tensor,
                            dy: torch.Tensor) -> torch.Tensor:
    """Plain version of `sparse_conv_wgrad_cuda`: dW (K*Cin, Cout), a gather
    and one matmul per chunk of rows, any device and float type."""
    B, Vout, K = nbr.shape
    Cin, Cout = feats.shape[2], dy.shape[2]
    table, idx = _flat_table(feats, nbr)
    d = dy.reshape(B * Vout, Cout)
    dw = feats.new_zeros((K * Cin, Cout))
    for r0 in range(0, idx.shape[0], PLAIN_CHUNK_ROWS):
        rows = idx[r0:r0 + PLAIN_CHUNK_ROWS]
        g = table[rows.reshape(-1)].reshape(rows.shape[0], K * Cin)
        dw += g.t() @ d[r0:r0 + PLAIN_CHUNK_ROWS]
    return dw


def _check_plan(plan: SparseConvPlan, B: int, Vin: int, Vout: int, device) -> None:
    tiles = -(-Vout // TILE_ROWS)
    if (plan.vin != Vin or tuple(plan.order.shape) != (B, Vout)
            or tuple(plan.tile_mask.shape) != (B, tiles)):
        raise ValueError(f'the plan (order {tuple(plan.order.shape)}, tile_mask '
                         f'{tuple(plan.tile_mask.shape)}, Vin {plan.vin}) is not one of this '
                         f'map (B={B}, Vout={Vout}, Vin={Vin})')
    for t, name in ((plan.order, 'plan.order'), (plan.tile_mask, 'plan.tile_mask')):
        _need(t, name, torch.int32, 2)
        _need_contiguous(t, name)
        if t.device != device:
            raise ValueError(f'{name} is on {t.device}, the inputs on {device}')


def sparse_conv_cuda(feats: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
                     plan: SparseConvPlan | None = None) -> torch.Tensor:
    """One launch of `sparse_conv_kernel` for the whole batch. feats (B, Vin,
    Cin) float32, nbr (B, Vout, K) int32, weight (K*Cin, Cout) float32, all
    contiguous CUDA tensors; `plan` is `sparse_conv_plan(nbr, Vin)`, built
    here when not given. Returns (B, Vout, Cout) float32. Does not
    synchronize, and records no gradient (`SparseConvFunction` does)."""
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
    _check_plan(plan, B, Vin, Vout, feats.device)
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


def wgrad_row_taps(K: int) -> tuple[int, ...]:
    """The taps of each row of the weight gradient's blocks, WGRAD_ROW_TAPS a
    row (-1 past K), flat: a 27-tap kernel (dz, dy, dx) has 9 rows, row y
    holding one tap of every plane dz, dy or dx = const, so the taps of a
    thin layer of sites (LiDAR's ground: the plane dz = 0 holds most present
    taps) spread over all rows; a 9-tap kernel (dy, dx) has 3 rows, one tap
    of each dy and each dx; any other K rows of 3 consecutive taps."""
    rows = -(-K // WGRAD_ROW_TAPS)
    if K == 27:
        return tuple(i * 9 + (y // 3 - i) % 3 * 3 + (y % 3 - i) % 3
                     for y in range(rows) for i in range(3))
    if K == 9:
        return tuple(i * 3 + (y - i) % 3 for y in range(rows) for i in range(3))
    return tuple(k if k < K else -1 for k in range(3 * rows))


class WgradPlan(NamedTuple):
    row_taps: tuple[int, ...]   # `wgrad_row_taps(K)`: row y of blocks sums taps [3y, 3y + 3)
    tiles: int      # tiles of TILE_ROWS rows over the batch: B * ceil(Vout / TILE_ROWS)
    chunks: int     # block x of a row walks tiles x, x + chunks, x + 2 * chunks, ...
    scratch: int    # floats of the partials, K * chunks * Cin * Cout

    @property
    def rows(self) -> int:
        return len(self.row_taps) // WGRAD_ROW_TAPS


def wgrad_plan(B: int, Vout: int, K: int, Cin: int, Cout: int, per_sm: int) -> WgradPlan:
    """The weight gradient's launch: `rows` x `chunks` blocks, one wave on an
    H100 of `per_sm` blocks a multiprocessor (the library's
    `sparse_conv_wgrad_blocks_per_sm`, 1 or 2 by the widths), each summing
    its row's taps over its tiles in ascending order (those with one of its
    taps), then the partials summed over the chunks in order; no block walks
    more than WGRAD_MAX_TILES tiles. A function of the shapes alone, so the
    order of every sum is the same on every run. Where the tiles are fewer
    than WGRAD_MAX_TILES times that wave's chunks, the scratch is at most
    3 * WGRAD_SMS * per_sm * Cin * Cout floats (per_sm times 12.98 MB at
    the widest shipped layers, 64 -> 128 and 128 -> 64)."""
    taps = wgrad_row_taps(K)
    rows = len(taps) // WGRAD_ROW_TAPS
    tiles = B * -(-Vout // TILE_ROWS)
    chunks = max(1, -(-tiles // WGRAD_MAX_TILES), min(tiles, WGRAD_SMS * per_sm // rows))
    return WgradPlan(taps, tiles, chunks, K * chunks * Cin * Cout)


def sparse_conv_wgrad_cuda(feats: torch.Tensor, nbr: torch.Tensor, dy: torch.Tensor,
                           plan: SparseConvPlan | None = None) -> torch.Tensor:
    """The weight gradient of `sparse_conv_cuda(feats, nbr, W, plan)` for the
    output gradient dy (B, Vout, Cout) float32: dW (K*Cin, Cout) float32, one
    launch of `sparse_conv_wgrad_kernel` as `wgrad_plan` lays it out, one
    before it that ORs each tile's tap masks and one after it, the
    fixed-order sum over chunks. Contiguous CUDA tensors. `plan`, the
    forward's, is checked against the map when given and not read further:
    the kernel walks tiles in slot order. Records the partials' bytes in
    `sparse_conv_wgrad_cuda.last_scratch_bytes`. Does not synchronize."""
    _need(feats, 'feats', torch.float32, 3)
    _need(nbr, 'nbr', torch.int32, 3)
    _need(dy, 'dy', torch.float32, 3)
    for t, name in ((feats, 'feats'), (nbr, 'nbr'), (dy, 'dy')):
        _need_contiguous(t, name)
        if t.device != feats.device:
            raise ValueError(f'{name} is on {t.device}, feats on {feats.device}')
    B, Vin, Cin = feats.shape
    Vout, K = nbr.shape[1], nbr.shape[2]
    Cout = dy.shape[2]
    lib = kernels.load()
    if nbr.shape[0] != B or tuple(dy.shape[:2]) != (B, Vout) or min(B, Vin, Vout, K, Cin,
                                                                    Cout) < 1:
        raise ValueError(f'feats {tuple(feats.shape)}, nbr {tuple(nbr.shape)} and dy '
                         f'{tuple(dy.shape)} disagree')
    most = lib.sparse_conv_wgrad_max_channels()
    if K > lib.sparse_conv_max_taps() or Cin > most or Cout > most:
        raise ValueError(f'the weight gradient takes up to {lib.sparse_conv_max_taps()} taps and '
                         f'{most} channels each way, got K={K}, Cin={Cin}, Cout={Cout}')
    if plan is not None:
        _check_plan(plan, B, Vin, Vout, feats.device)
    wp = wgrad_plan(B, Vout, K, Cin, Cout, lib.sparse_conv_wgrad_blocks_per_sm(Cin, Cout))
    row_taps = (ctypes.c_int * len(wp.row_taps))(*wp.row_taps)
    tile_taps = torch.empty((wp.tiles,), dtype=torch.int32, device=feats.device)
    partial = torch.empty((wp.scratch,), dtype=torch.float32, device=feats.device)
    dw = torch.empty((K * Cin, Cout), dtype=torch.float32, device=feats.device)
    index = feats.device.index
    with kernels.on_device(index):
        err = lib.sparse_conv_wgrad_launch(feats.data_ptr(), nbr.data_ptr(), dy.data_ptr(),
                                           row_taps, tile_taps.data_ptr(), partial.data_ptr(),
                                           dw.data_ptr(), B, Vin, Vout, K, Cin, Cout, TILE_ROWS,
                                           wp.chunks, kernels.stream(index))
    if err != 0:
        raise RuntimeError(f'sparse_conv_wgrad_launch failed with CUDA error {err}')
    sparse_conv_wgrad_cuda.launches += 1
    sparse_conv_wgrad_cuda.last_scratch_bytes = partial.numel() * partial.element_size()
    return dw


sparse_conv_wgrad_cuda.launches = 0
sparse_conv_wgrad_cuda.last_scratch_bytes = 0


def sparse_conv_grads(dy: torch.Tensor, feats: torch.Tensor, nbr: torch.Tensor,
                      weight: torch.Tensor, plan: SparseConvPlan | None,
                      bwd_nbr: torch.Tensor | None, bwd_plan: SparseConvPlan | None,
                      need_feats: bool = True, need_weight: bool = True) -> tuple:
    """(d_feats or None, d_weight or None) of the layer `feats, nbr, weight`
    for the output gradient dy. CPU tensors take the plain versions; CUDA
    tensors launch the kernels (the forward kernel through `bwd_plan` for the
    data gradient, `sparse_conv_wgrad_cuda` through `plan`) or raise."""
    cuda = dy.device.type == 'cuda'
    dy = dy.contiguous()
    d_feats = d_weight = None
    if need_weight:
        d_weight = (sparse_conv_wgrad_cuda(feats, nbr, dy, plan) if cuda
                    else sparse_conv_wgrad_plain(feats, nbr, dy))
    if need_feats:
        if bwd_nbr is None:
            raise ValueError('the sparse conv\'s data gradient reads the transposed map: prepare '
                             'the batch with models.get_host_prepare(..., training=True)')
        w = flip_weight(weight, nbr.shape[2]).contiguous()
        d_feats = (sparse_conv_cuda(dy, bwd_nbr, w, bwd_plan) if cuda
                   else sparse_conv_plain(dy, bwd_nbr, w))
    return d_feats, d_weight


class SparseConvFunction(torch.autograd.Function):
    """`out = sparse_conv(feats, nbr, weight)` with the gather-transpose
    backward of `sparse_conv_grads`. Only the layer's input table and the
    integer maps are kept for the backward. The data gradient is skipped
    where autograd does not ask for it (the ladder's first layer, whose input
    has no parameters behind it)."""

    @staticmethod
    def forward(ctx, feats, nbr, weight, plan, bwd_nbr, bwd_plan):
        ctx.save_for_backward(feats, nbr, weight, bwd_nbr)
        ctx.plans = (plan, bwd_plan)
        if feats.device.type == 'cuda':
            return sparse_conv_cuda(feats, nbr, weight, plan)
        return sparse_conv_plain(feats, nbr, weight)

    @staticmethod
    def backward(ctx, dy):
        feats, nbr, weight, bwd_nbr = ctx.saved_tensors
        plan, bwd_plan = ctx.plans
        d_feats, d_weight = sparse_conv_grads(dy, feats, nbr, weight, plan, bwd_nbr, bwd_plan,
                                              ctx.needs_input_grad[0], ctx.needs_input_grad[2])
        return d_feats, None, d_weight, None, None, None
