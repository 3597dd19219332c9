"""Wrapper of the Hopper ball-query kernels (`csrc/ball_query.cu`), their
launch plan and the grid the grid path walks.

Replaces `pdm_ssd_tpu/ops/pallas/retired/grid_query.py:grid_ball_query_pallas`
with the exact first-K contract of its plain version,
`ops/pointnet2.ball_query`, which both paths equal bit for bit. The wrapper
takes CUDA tensors only: `ops/dispatch.py` routes CPU tensors to the plain
version. One launch serves all radii of a set-abstraction level.
`ball_query_cuda.launches` counts the kernel launches of either path;
`launches_grid` and `launches_walk` count them by path.

The grid path tests only the points of the 3x3x3 cells around a center.
`build_grid` makes the grid with torch ops on the device, as the JAX package
builds its bucket table in XLA outside the Pallas call: cell keys of edge
`cell` (a little over the level's largest radius), sorted stably, so each
cell's points form one run in point order; it needs no coordinate range and
no host sync. `ball_query_grid_plain` is a plain torch emulation of the
kernel's walk over that grid (window runs found by search, merged in point
order), for the CPU tests. The walk path tests every point of the cloud in
point order and serves small clouds (the ROI stack's), where a grid costs
more than it saves. `ball_query_plan` picks the path.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import kernels
from .pointnet2 import _pair_d2

# clouds of at least this many points take the grid path (PointRCNN's
# backbone levels have 16384, 4096 and 1024; its ROI stack 512 and 128)
GRID_MIN_POINTS = 1024
# the cell edge over the level's largest radius: a point in the ball passes
# the float32 test with |p - c| < r (1 + 2^-22) per axis, and the cell
# product x * (1 / cell) runs in float64, so any margin well above 2^-22
# keeps every hit in the 3x3x3 window
CELL_MARGIN = 2.0 ** -12
CELL_BITS = 21                       # bits of a cell coordinate in a key
CELL_OFFSET = 1 << (CELL_BITS - 1)   # cell coordinates are clamped to [-2^20, 2^20 - 2]
CELL_MAX = (1 << CELL_BITS) - 2      # the largest offset coordinate: every key stays below
KEY_SENTINEL = torch.iinfo(torch.int64).max   # a masked point's key


class BallQueryPlan(NamedTuple):
    path: str       # 'grid' or 'walk'
    cell: float     # the grid's cell edge (0.0 on the walk path)


class BallGrid(NamedTuple):
    keys: torch.Tensor          # (B, N) int64 sorted cell keys
    points: torch.Tensor        # (B, N, 4) float32 in key order: x, y, z, index as int32 bits


# a window that holds more than N // DENSE_SHARE points makes the kernel walk
# the cloud in point order, 32 points a step, instead of merging the window's
# runs one candidate a step (`ball_query_grid_kernel`; the emulation's test
# count follows it)
DENSE_SHARE = 16


def ball_query_plan(N: int, radii: Sequence[float], path: str | None = None) -> BallQueryPlan:
    """The path of one level's query over clouds of N points: the grid from
    GRID_MIN_POINTS points on, else the walk. `path` forces one (to time or
    test both). A radius that is not a positive finite number leaves no grid
    to build and takes the walk."""
    if path not in (None, 'grid', 'walk'):
        raise ValueError(f'unknown ball-query path {path!r}')
    r = max(float(x) for x in radii)
    gridable = np.isfinite(r) and r > 0
    if path == 'grid' and not gridable:
        raise ValueError(f'no grid for the radii {list(radii)}')
    if path == 'grid' or (path is None and gridable and N >= GRID_MIN_POINTS):
        return BallQueryPlan('grid', r * (1.0 + CELL_MARGIN))
    return BallQueryPlan('walk', 0.0)


def cell_coords(xyz: torch.Tensor, cell: float) -> torch.Tensor:
    """(..., 3) float64 cell coordinates floor(x * (1 / cell)) in float64,
    clamped and offset into [0, CELL_MAX], as the kernel computes a
    center's. Clamping keeps neighbours within one cell of each other, so no
    window loses a point by it; a NaN coordinate stays NaN (its tests fail)."""
    c = xyz.to(torch.float64, copy=True).mul_(1.0 / cell).floor_()
    return c.clamp_(-CELL_OFFSET, CELL_MAX - CELL_OFFSET).add_(CELL_OFFSET)


@functools.lru_cache(maxsize=None)
def _key_weights(device: torch.device) -> torch.Tensor:
    return torch.tensor([1 << (2 * CELL_BITS), 1 << CELL_BITS, 1], dtype=torch.int64,
                        device=device)


def cell_keys(cells: torch.Tensor) -> torch.Tensor:
    """(..., 3) cell coordinates in [0, CELL_MAX] -> (...) int64 keys, z
    fastest, all below KEY_SENTINEL."""
    return (cells.long() * _key_weights(cells.device)).sum(-1)


def build_grid(xyz: torch.Tensor, cell: float, mask: torch.Tensor | None = None) -> BallGrid:
    """The grid of clouds xyz (B, N, 3), any device; a masked point (mask
    False) is in no cell."""
    keys = cell_keys(cell_coords(xyz, cell))
    if mask is not None:
        keys = torch.where(mask, keys, KEY_SENTINEL)
    keys, order = torch.sort(keys, dim=1, stable=True)
    idx = order.to(torch.int32)[..., None].view(torch.float32)
    points = torch.cat([torch.gather(xyz.float(), 1, order[..., None].expand(-1, -1, 3)), idx],
                       dim=-1)
    return BallGrid(keys, points)


# window cell l of the kernel's lane l: (l // 9, l // 3 % 3, l % 3) - 1
WINDOW = torch.tensor([(l // 9 - 1, l // 3 % 3 - 1, l % 3 - 1) for l in range(27)])


def ball_query_grid_plain(radii: Sequence[float], nsamples: Sequence[int], xyz: torch.Tensor,
                          new_xyz: torch.Tensor, mask: torch.Tensor | None = None,
                          cell: float | None = None, count_tests: bool = False):
    """Plain torch emulation of the grid path: the grid of `build_grid`, each
    center's 27 window runs found by search in the sorted keys, their points
    merged in point order and tested, the first K hits kept. A list over radii
    of (B, M, K) int32, equal to `ops/pointnet2.ball_query`; with
    `count_tests` also the (B, M) int64 distance tests the kernel makes
    before it stops (at the K-th hit of the last radius to fill, else at the
    window's end; over the cloud in point order where the window holds more
    than N // DENSE_SHARE points). It holds every center's whole window at
    once."""
    if cell is None:
        cell = ball_query_plan(xyz.shape[1], radii, path='grid').cell
    grid = build_grid(xyz, cell, mask)
    B, N = grid.keys.shape
    M = new_xyz.shape[1]
    centers = torch.nan_to_num(cell_coords(new_xyz, cell)).long()
    near = centers[:, :, None, :] + WINDOW.to(xyz.device)                    # (B, M, 27, 3)
    inside = ((near >= 0) & (near <= CELL_MAX)).all(-1)
    wkeys = cell_keys(near.clamp(0, CELL_MAX)).reshape(B, -1)
    lo = torch.searchsorted(grid.keys, wkeys).view(B, M, 27)
    hi = torch.searchsorted(grid.keys, wkeys + 1).view(B, M, 27)
    count = torch.where(inside, hi - lo, 0)
    ends = count.cumsum(-1)
    L = max(int(ends[..., -1].max()), 1) if ends.numel() else 1
    t = torch.arange(L, device=xyz.device)
    run = torch.searchsorted(ends.reshape(B * M, 27), t.expand(B * M, L).contiguous(),
                             right=True).view(B, M, L).clamp(max=26)
    pos = lo.gather(2, run) + t - (ends - count).gather(2, run)
    real = t < ends[..., -1:]
    point_idx = grid.points[..., 3].contiguous().view(torch.int32).long()        # (B, N)
    cand = torch.where(real, point_idx.gather(1, pos.clamp(0, N - 1).view(B, -1)).view(B, M, L),
                       N)
    cand, _ = cand.sort(-1)                                        # the merge: point order
    real = cand < N
    safe = cand.clamp(max=N - 1)
    cand_xyz = torch.gather(xyz.float(), 1, safe.view(B, -1, 1).expand(-1, -1, 3)).view(B, M, L, 3)
    d2 = _pair_d2(new_xyz.float().reshape(B * M, 1, 3), cand_xyz.reshape(B * M, L, 3)).view(B, M, L)
    outs = []
    total = real.sum(-1)
    dense = total > N // DENSE_SHARE
    tests = torch.zeros_like(total)
    steps = torch.arange(1, L + 1, device=xyz.device)
    for radius, nsample in zip(radii, nsamples):
        K = int(nsample)
        r2 = float(np.float32(float(radius) * float(radius)))
        within = real & (d2 < r2)
        w = within.long()
        rank = torch.cumsum(w, dim=-1) - w
        slot = torch.where(within & (rank < K), rank, K)
        sel = torch.zeros((B, M, K + 1), dtype=torch.long, device=xyz.device)
        sel.scatter_(2, slot, torch.where(within, cand, 0))
        hits = w.sum(-1, keepdim=True)
        sel = sel[..., :K]
        outs.append(torch.where(torch.arange(K, device=xyz.device) < hits, sel,
                                sel[..., :1]).to(torch.int32))
        kth = within & (rank == K - 1)
        merged = torch.where(kth, steps, 0).amax(-1)
        walked = torch.where(kth, cand + 1, 0).amax(-1)          # the K-th hit's point + 1
        full = hits[..., 0] >= K
        tests = torch.maximum(tests, torch.where(dense, torch.where(full, walked, N),
                                                 torch.where(full, merged, total)))
    return (outs, tests) if count_tests else outs


def _check(tensors) -> None:
    for name, t, dtype, ndim, ref in tensors:
        if t.device.type != 'cuda' or t.device != ref.device:
            raise ValueError(f'{name}: the kernel needs CUDA tensors on one device, got '
                             f'{t.device}')
        if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f'{name}: the kernel needs a contiguous {dtype} tensor of {ndim} '
                             f'dimensions, got {t.dtype} {tuple(t.shape)}')


def ball_query_cuda(radii: Sequence[float], nsamples: Sequence[int], xyz: torch.Tensor,
                    new_xyz: torch.Tensor, mask: torch.Tensor | None = None,
                    plan: BallQueryPlan | None = None, grid: BallGrid | None = None) -> list:
    """xyz (B, N, 3) and new_xyz (B, M, 3) float32, mask (B, N) bool or None,
    all contiguous CUDA tensors -> a list over radii of (B, M, K) int32.
    `plan` (default `ball_query_plan` of the shape) names the path; on the
    grid path `grid` is `build_grid(xyz, plan.cell, mask)`, built here when
    not given.

    Launches on the current stream and does not synchronize."""
    tensors = [('xyz', xyz, torch.float32, 3, xyz), ('new_xyz', new_xyz, torch.float32, 3, xyz)]
    if mask is not None:
        tensors.append(('mask', mask, torch.bool, 2, xyz))
    _check(tensors)
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    if (xyz.shape[2] != 3 or tuple(new_xyz.shape) != (B, M, 3)
            or (mask is not None and tuple(mask.shape) != (B, N))):
        raise ValueError(f'shapes disagree: xyz {tuple(xyz.shape)} new_xyz {tuple(new_xyz.shape)}'
                         + ('' if mask is None else f' mask {tuple(mask.shape)}'))
    lib = kernels.load()
    nb = len(radii)
    if nb != len(nsamples) or not 1 <= nb <= lib.ball_query_max_branches():
        raise ValueError(f'the kernel takes 1 to {lib.ball_query_max_branches()} radii with one '
                         f'K each, got {list(radii)} and {list(nsamples)}')
    if min(nsamples) < 1 or min(B, N, M) < 1:
        raise ValueError('empty input or K < 1')
    if plan is None:
        plan = ball_query_plan(N, radii)
    if plan.path == 'grid':
        if plan.cell < max(float(r) for r in radii):
            raise ValueError(f'a grid of cell {plan.cell} cannot hold balls of radius '
                             f'{max(radii)}')
        if lib.ball_query_cell_bits() != CELL_BITS:
            raise RuntimeError('csrc/ball_query.cu packs cell keys with another width')
        if grid is None:
            grid = build_grid(xyz, plan.cell, mask)
        _check([('grid.keys', grid.keys, torch.int64, 2, xyz),
                ('grid.points', grid.points, torch.float32, 3, xyz)])
        if tuple(grid.keys.shape) != (B, N) or tuple(grid.points.shape) != (B, N, 4):
            raise ValueError('the grid is not one of these clouds')
    elif plan.path != 'walk':
        raise ValueError(f'unknown ball-query path {plan.path!r}')
    outs = [torch.empty((B, M, int(K)), dtype=torch.int32, device=xyz.device) for K in nsamples]
    # the plain version compares float32 distances with the float32 rounding
    # of the Python double r*r
    r2 = (ctypes.c_float * nb)(*[float(np.float32(float(r) * float(r))) for r in radii])
    ks = (ctypes.c_int * nb)(*[int(K) for K in nsamples])
    ptrs = (ctypes.c_void_p * nb)(*[o.data_ptr() for o in outs])
    index = xyz.device.index
    with kernels.on_device(index):
        if plan.path == 'grid':
            err = lib.ball_query_grid_launch(grid.keys.data_ptr(), grid.points.data_ptr(),
                                             xyz.data_ptr(),
                                             None if mask is None else mask.data_ptr(),
                                             new_xyz.data_ptr(), B, N, M, 1.0 / plan.cell, nb,
                                             r2, ks, ptrs, kernels.stream(index))
        else:
            err = lib.ball_query_launch(xyz.data_ptr(), new_xyz.data_ptr(),
                                        None if mask is None else mask.data_ptr(), B, N, M, nb,
                                        r2, ks, ptrs, kernels.stream(index))
    if err != 0:
        raise RuntimeError(f'ball_query {plan.path} launch failed with CUDA error {err}')
    ball_query_cuda.launches += 1
    if plan.path == 'grid':
        ball_query_cuda.launches_grid += 1
    else:
        ball_query_cuda.launches_walk += 1
    return outs


ball_query_cuda.launches = 0
ball_query_cuda.launches_grid = 0
ball_query_cuda.launches_walk = 0
