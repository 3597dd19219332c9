"""Grouping of the fused set abstraction: in-ball selection over a 3x3 cell
window, row gather, and the row scatter-add that is the gather's backward.

Each function has a plain PyTorch version (`*_plain`, any device, used by
the CPU tests and as the yardstick on the card) and a wrapper of its Hopper
kernel in `csrc/group.cu` (`*_cuda`, CUDA tensors only). `ops/dispatch.py`
picks by the tensor's device. The kernels replace the TPU's grouping kernels
of `pdm_ssd_tpu/ops/pallas/retired/`: `grid_query_group_pallas`
(`grid_query.py`), `gather_rows` in both layouts and `scatter_add_rows`
(`onehot_gather.py`); on the JAX production path the same work is done by
`pdm_ssd_tpu/ops/sa_fused.py` (`window_group`, `gather_rows_mm`).

All three are bound by bytes on an H100, not by arithmetic: the selection
reads 9 table rows and the points they name per center, the gather and the
scatter move each output or input row once. `csrc/group.cu` says what each
kernel's design does about it. Each wrapper counts its launches in
`<wrapper>.launches`; the row gather counts those of its bfloat16 entry point
apart, in `gather_rows_cuda.launches_bf16`.

The relative xyz that the selection returns is not differentiated: the
coordinates are raw input on every model of the port and no parameter lies
upstream of them.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import kernels


def flat_gather(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, ...) in [0, N) -> (B, ..., C)."""
    B, N, C = features.shape
    boff = (torch.arange(B, device=idx.device) * N).reshape((B,) + (1,) * (idx.dim() - 1))
    return features.reshape(B * N, C)[(idx + boff).reshape(-1)].reshape(*idx.shape, C)


# ---- in-ball selection -------------------------------------------------------

def window_candidates(table: torch.Tensor, center_cells: torch.Tensor,
                      grid_w: int) -> torch.Tensor:
    """Point indices of each center's 3x3 cell window: (B, M, 9*cap), -1 where
    empty. `center_cells` (B, M) holds each center's cell; a center in the
    dump cell (the table's last row) reads that empty row nine times."""
    B, n_rows, cap = table.shape
    n_cells = n_rows - 1
    cc = center_cells.long()
    M = cc.shape[1]
    rows = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            rows.append(torch.where(cc == n_cells, cc,
                                    (cc + dy * grid_w + dx).clamp(0, n_cells)))
    rows = torch.stack(rows, dim=-1)                              # (B, M, 9)
    boff = (torch.arange(B, device=table.device) * n_rows)[:, None, None]
    cand = table.reshape(B * n_rows, cap)[(rows + boff).reshape(-1)]
    return cand.reshape(B, M, 9 * cap)


def window_group(cand: torch.Tensor, xyz: torch.Tensor, new_xyz: torch.Tensor,
                 radii: Sequence[float], nsamples: Sequence[int]):
    """Per-radius selection over the candidate window.

    Returns a list over radii of (rel_xyz (B, M, K, 3), idx (B, M, K) int64,
    hit (B, M) bool). Ranks are an exclusive `cumsum` over the candidate
    axis, and the selection is a scatter by rank."""
    cand = cand.long()
    valid = cand >= 0
    cand0 = cand.clamp(min=0)
    rel = flat_gather(xyz, cand0) - new_xyz[:, :, None, :]        # (B, M, 9c, 3)
    rx, ry, rz = rel[..., 0], rel[..., 1], rel[..., 2]
    d2 = rx * rx + ry * ry + rz * rz
    B, M, NC = cand.shape
    cand_pos = torch.arange(NC, device=cand.device).expand(B, M, NC)
    outs = []
    for radius, K in zip(radii, nsamples):
        within = (d2 < radius * radius) & valid
        w = within.long()
        rank = torch.cumsum(w, dim=-1) - w                        # exclusive
        hits = w.sum(dim=-1, keepdim=True)                        # (B, M, 1)
        slot = torch.where(within & (rank < K), rank, K)
        sel = torch.zeros((B, M, K + 1), dtype=torch.long, device=cand.device)
        sel.scatter_(2, slot, cand_pos)
        sel = sel[..., :K]
        k_iota = torch.arange(K, device=cand.device)
        sel = torch.where(k_iota < hits, sel, sel[..., :1])       # first-hit backfill
        hit = hits[..., 0] > 0
        g_idx = torch.where(hit[..., None], cand0.gather(2, sel), 0)
        g_rel = rel.gather(2, sel[..., None].expand(-1, -1, -1, 3))
        g_rel = torch.where(hit[..., None, None], g_rel, 0.0)
        outs.append((g_rel, g_idx, hit))
    return outs


def window_select_plain(table: torch.Tensor, center_cells: torch.Tensor, grid_w: int,
                        xyz: torch.Tensor, new_xyz: torch.Tensor,
                        radii: Sequence[float], nsamples: Sequence[int]):
    """Plain version of `window_select_cuda`: the same arguments, the same
    list over radii of (rel_xyz, idx, hit), with int64 indices."""
    return window_group(window_candidates(table, center_cells, grid_w), xyz, new_xyz,
                        radii, nsamples)


# parts (32 slots of one cell each) of the window that a warp of
# `window_select_cuda` loads in one pass: kMaxLoads in `csrc/group.cu`
SELECT_PASS_PARTS = 9


def window_select_walk_plain(table: torch.Tensor, center_cells: torch.Tensor, grid_w: int,
                             xyz: torch.Tensor, new_xyz: torch.Tensor,
                             radii: Sequence[float], nsamples: Sequence[int]):
    """Plain emulation of the kernel's walk: each pass of `SELECT_PASS_PARTS`
    parts of the window (32 slots of one cell each) compacted to its occupied
    slots in candidate order, walked 32 at a time, stopping once every radius
    has its K hits. Returns (the list over radii of (rel_xyz, idx, hit) that
    the candidates walked select, the occupied slots of each center's window
    (B, M), the walk's steps per center (B, M)). The selection equals
    `window_select_plain` where the walk stops no earlier than it may."""
    cap = table.shape[2]
    cand = window_candidates(table, center_cells, grid_w).long()
    B, M, L = cand.shape
    dev = cand.device
    valid = cand >= 0
    d2 = (flat_gather(xyz, cand.clamp(min=0)) - new_xyz[:, :, None, :]).square()
    d2 = (d2[..., 0] + d2[..., 1]) + d2[..., 2]
    within = torch.stack([valid & (d2 < r * r) for r in radii], -1)         # (B, M, L, nb)
    need = torch.tensor([int(k) for k in nsamples], device=dev)
    hits = torch.zeros((B, M, len(radii)), dtype=torch.long, device=dev)
    steps = torch.zeros((B, M), dtype=torch.long, device=dev)
    walked = torch.zeros_like(valid)
    pos = torch.arange(L, device=dev)
    pass_of = (pos // cap * -(-cap // 32) + pos % cap // 32) // SELECT_PASS_PARTS
    for p in range(int(pass_of.max()) + 1):
        lo, hi = int((pass_of < p).sum()), int((pass_of <= p).sum())
        v = valid[..., lo:hi]
        place = torch.cumsum(v.long(), -1) - v.long()                      # in the compact list
        n = v.sum(-1)
        step_of = torch.where(v, place // 32, -1)
        for s in range(-(-v.shape[-1] // 32)):
            on = (32 * s < n) & ~(hits >= need).all(-1)
            mine = (step_of == s) & on[..., None]
            steps += on.long()
            walked[..., lo:hi] |= mine
            hits += (within[..., lo:hi, :] & mine[..., None]).sum(2)
    outs = window_group(torch.where(walked, cand, -1), xyz, new_xyz, radii, nsamples)
    return outs, valid.sum(-1), steps


def _need(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.device.type != 'cuda':
        raise ValueError(f'{name}: the kernel needs a CUDA tensor, got {t.device}')
    if t.dtype != dtype:
        raise ValueError(f'{name}: the kernel needs {dtype}, got {t.dtype}')
    if t.dim() != ndim:
        raise ValueError(f'{name}: the kernel needs {ndim} dimensions, got {tuple(t.shape)}')


def _need_contiguous(t: torch.Tensor, name: str) -> None:
    if not t.is_contiguous():
        raise ValueError(f'{name}: the kernel needs a contiguous tensor')


def window_select_cuda(table: torch.Tensor, center_cells: torch.Tensor, grid_w: int,
                       xyz: torch.Tensor, new_xyz: torch.Tensor,
                       radii: Sequence[float], nsamples: Sequence[int]):
    """One launch of `window_select_kernel` for all radii of one SA level.

    table (B, n_cells + 1, cap) int32, center_cells (B, M) int32,
    xyz (B, N, 3) and new_xyz (B, M, 3) float32, all contiguous CUDA tensors.
    Returns a list over radii of (rel_xyz (B, M, K, 3) float32,
    idx (B, M, K) int32, hit (B, M) bool). Does not synchronize."""
    _need(table, 'table', torch.int32, 3)
    _need(center_cells, 'center_cells', torch.int32, 2)
    _need(xyz, 'xyz', torch.float32, 3)
    _need(new_xyz, 'new_xyz', torch.float32, 3)
    for t, name in ((table, 'table'), (center_cells, 'center_cells'), (xyz, 'xyz'),
                    (new_xyz, 'new_xyz')):
        _need_contiguous(t, name)
        if t.device != xyz.device:
            raise ValueError(f'{name} is on {t.device}, xyz on {xyz.device}')
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    n_cells, cap = table.shape[1] - 1, table.shape[2]
    if (xyz.shape[2] != 3 or tuple(new_xyz.shape) != (B, M, 3) or table.shape[0] != B
            or tuple(center_cells.shape) != (B, M)):
        raise ValueError(f'shapes disagree: table {tuple(table.shape)} cells '
                         f'{tuple(center_cells.shape)} xyz {tuple(xyz.shape)} '
                         f'new_xyz {tuple(new_xyz.shape)}')
    lib = kernels.load()
    nb = len(radii)
    if nb != len(nsamples) or not 1 <= nb <= lib.window_select_max_branches():
        raise ValueError(f'the kernel takes 1 to {lib.window_select_max_branches()} radii '
                         f'with one K each, got {list(radii)} and {list(nsamples)}')
    if min(nsamples) < 1 or min(B, N, M, n_cells, cap, grid_w) < 1:
        raise ValueError('empty input or K < 1')
    dev = xyz.device
    outs = [(torch.empty((B, M, K, 3), dtype=torch.float32, device=dev),
             torch.empty((B, M, K), dtype=torch.int32, device=dev),
             torch.empty((B, M), dtype=torch.bool, device=dev)) for K in nsamples]
    # the plain version compares a float32 tensor with the Python double r*r,
    # which PyTorch rounds to float32 first
    r2 = (ctypes.c_float * nb)(*[float(np.float32(float(r) * float(r))) for r in radii])
    ks = (ctypes.c_int * nb)(*[int(K) for K in nsamples])
    ptrs = [(ctypes.c_void_p * nb)(*[o[j].data_ptr() for o in outs]) for j in (1, 0, 2)]
    with kernels.on_device(dev.index):
        err = lib.window_select_launch(table.data_ptr(), center_cells.data_ptr(),
                                       xyz.data_ptr(), new_xyz.data_ptr(), B, N, M, n_cells,
                                       int(grid_w), cap, nb, r2, ks, *ptrs,
                                       kernels.stream(dev.index))
    if err != 0:
        raise RuntimeError(f'window_select_launch failed with CUDA error {err}')
    window_select_cuda.launches += 1
    return outs


window_select_cuda.launches = 0


# ---- row gather and its backward ---------------------------------------------

def gather_rows_plain(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, R) -> (B, R, C); an index outside [0, N)
    gives a zero row."""
    N = features.shape[1]
    idx = idx.long()
    ok = (idx >= 0) & (idx < N)
    rows = flat_gather(features, torch.where(ok, idx, 0))
    return torch.where(ok[..., None], rows, 0.0)


def scatter_add_rows_plain(vals: torch.Tensor, idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """vals (B, R, C), idx (B, R) -> (B, n_rows, C): out[b, idx[b, r]] += vals[b, r];
    an index outside [0, n_rows) is dropped."""
    B, R, C = vals.shape
    idx = idx.long()
    ok = (idx >= 0) & (idx < n_rows)
    boff = (torch.arange(B, device=vals.device) * n_rows)[:, None]
    flat = torch.where(ok, idx + boff, B * n_rows)                # last row: the dropped
    out = torch.zeros((B * n_rows + 1, C), dtype=vals.dtype, device=vals.device)
    out.index_add_(0, flat.reshape(-1), vals.reshape(B * R, C))
    return out[:B * n_rows].view(B, n_rows, C)


# threads of a gather block, blocks per SM the grid aims at (the stride loops
# take the rest), and the warps per SM below which the row path shortens its
# tiles to keep enough loads in flight
ROW_THREADS = 256
BLOCKS_PER_SM = 8
WARPS_PER_SM = 32
_INDEX_LIMIT = 2 ** 31


class GatherPlan(NamedTuple):
    lanes: int            # lanes per row on the row path; 0: the narrow path
    passes: int           # row path: passes a warp makes over a tile of
                          # passes * 32 / lanes rows; narrow path: 1
    unit: int             # bytes of each load and store on the row path; 16 (the
                          # stores) on the narrow path
    rows_per_thread: int  # narrow path: consecutive rows a thread takes; else 1
    wide_index: bool      # 64-bit offsets
    blocks: int           # blocks along the grid's x axis


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _align(*values: int) -> int:
    """Largest of 16, 8, 4, 2, 1 that divides every value."""
    return math.gcd(16, *values)


def gather_plan(B: int, N: int, R: int, C: int, elem_bytes: int, ld: int, start: int,
                sm_count: int) -> GatherPlan:
    """The launch of `gather_rows_cuda` for (B, N, C) rows of `elem_bytes`
    at row stride `ld` elements, whose first channel lies `start` bytes past
    a 16-byte boundary, gathered R times per cloud into a contiguous
    (B, R, C) output (16-byte aligned). Mirrors `csrc/group.cu`."""
    row = C * elem_bytes
    wide = B * (N * ld + R * C) * elem_bytes >= _INDEX_LIMIT
    target = sm_count * BLOCKS_PER_SM
    unit = _align(start, ld * elem_bytes, row)
    if row < 16 or (row == 16 and unit < 16):
        rows = 16 // math.gcd(row, 16)
        threads = -(-B * R // rows)
        return GatherPlan(0, 1, 16, rows, wide,
                          max(1, min(target, -(-threads // ROW_THREADS))))
    lanes = min(32, _pow2_at_least(row // unit))
    per_pass = 32 // lanes
    passes = lanes
    while passes > 1 and B * R < sm_count * WARPS_PER_SM * per_pass * passes:
        passes //= 2
    tiles = -(-R // (per_pass * passes))                 # a warp's tiles per cloud
    blocks = min(-(-tiles // (ROW_THREADS // 32)), -(-target // min(B, 65535)))
    return GatherPlan(lanes, passes, unit, 1, wide, max(1, blocks))


@functools.lru_cache(maxsize=1024)
def _gather_plan_on(index: int, B: int, N: int, R: int, C: int, elem_bytes: int, ld: int,
                    start: int) -> GatherPlan:
    return gather_plan(B, N, R, C, elem_bytes, ld, start, _sm_count(index))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gather_rows_reads_in_place(features: torch.Tensor) -> bool:
    """Whether `gather_rows_cuda` can read features (B, N, C) as they lie:
    dense rows at one row stride. One cloud's batch stride is never read (a
    slice of a frame stack has another, and torch calls it contiguous)."""
    ld = features.stride(1)
    return (features.stride(2) == 1 and ld >= features.shape[2]
            and (features.shape[0] == 1 or features.stride(0) == features.shape[1] * ld))


def gather_rows_cuda(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One launch of `gather_rows_kernel` or `gather_narrow_kernel`, as
    `gather_plan` says. features (B, N, C) float32 or bfloat16 on CUDA:
    contiguous, or a channel slice `payload[..., c0:c1]` of a contiguous
    payload (rows stay where they are; the kernel gets the row stride).
    idx (B, R) int32 contiguous. Returns (B, R, C) of features' type."""
    dtype = features.dtype
    if dtype is not torch.float32 and dtype is not torch.bfloat16:
        raise ValueError(f'features: the kernel moves float32 or bfloat16 rows, got {dtype}')
    # one test for the common case (host time per call is part of the cost),
    # the checks that name the fault where it fails
    if not (features.is_cuda and idx.is_cuda and idx.dtype is torch.int32
            and features.dim() == 3 and idx.dim() == 2 and idx.is_contiguous()):
        _need(features, 'features', dtype, 3)
        _need(idx, 'idx', torch.int32, 2)
        _need_contiguous(idx, 'idx')
    B, N, C = features.shape
    R = idx.shape[1]
    ld = features.stride(1)
    if not gather_rows_reads_in_place(features):
        raise ValueError('features: the kernel needs dense rows at one row stride, got '
                         f'strides {features.stride()} for shape {tuple(features.shape)}')
    dev = features.device
    if idx.shape[0] != B or idx.device != dev or min(B, N, C, R) < 1:
        raise ValueError(f'features {tuple(features.shape)} and idx {tuple(idx.shape)} disagree')
    f32 = dtype is torch.float32
    ptr = features.data_ptr()
    plan = _gather_plan_on(dev.index, B, N, R, C, 4 if f32 else 2, ld, ptr % 16)
    out = torch.empty((B, R, C), dtype=dtype, device=dev)
    lib = kernels.load()
    launch = lib.gather_rows_launch if f32 else lib.gather_rows_bf16_launch
    with kernels.on_device(dev.index):
        err = launch(ptr, idx.data_ptr(), out.data_ptr(), B, N, R, C, ld, plan.lanes,
                     plan.passes, plan.unit, int(plan.wide_index), plan.blocks,
                     kernels.stream(dev.index))
    if err != 0:
        raise RuntimeError(f'gather_rows_launch {plan} failed with CUDA error {err}')
    if f32:
        gather_rows_cuda.launches += 1
    else:
        gather_rows_cuda.launches_bf16 += 1
    return out


# one count per entry point: `launches` of the float32 kernel, `launches_bf16`
# of the bfloat16 one
gather_rows_cuda.launches = 0
gather_rows_cuda.launches_bf16 = 0


# threads of a scatter-add block, the most rows of a warp's tile, the rows a
# lane group walks at most, and the warps per SM below which the plan
# shortens the walks to keep loads in flight
SCATTER_THREADS = 256
SCATTER_MAX_TILE = 256
SCATTER_SPAN = 32
SCATTER_WARPS_PER_SM = 4


class ScatterPlan(NamedTuple):
    unit: int          # bytes of each load and atomic: 16, 8 or 4
    lanes: int         # lanes per row (a power of two)
    span: int          # consecutive rows a lane group walks, summing runs
    tile_rows: int     # rows of a warp's tile: span * 32 / lanes
    wide_index: bool   # 64-bit offsets
    blocks: int        # blocks along the grid's x axis


def scatter_plan(B: int, R: int, C: int, n_rows: int, sm_count: int,
                 start: int = 0) -> ScatterPlan:
    """The launch of `scatter_add_rows_cuda` for (B, R, C) float32 rows whose
    first lies `start` bytes past a 16-byte boundary, added into
    (B, n_rows, C). Mirrors `csrc/group.cu`."""
    row = 4 * C
    unit = _align(start, row)
    lanes = min(32, _pow2_at_least(row // unit))
    groups = 32 // lanes
    span = min(SCATTER_SPAN, SCATTER_MAX_TILE // groups)
    while span > 4 and -(-B * R // (span * groups)) < sm_count * SCATTER_WARPS_PER_SM:
        span //= 2
    tile = span * groups
    wide = B * (R + n_rows) * row >= _INDEX_LIMIT
    tiles = -(-R // tile)                                 # a warp's tiles per cloud
    blocks = min(-(-tiles // (SCATTER_THREADS // 32)),
                 -(-sm_count * BLOCKS_PER_SM // min(B, 65535)))
    return ScatterPlan(unit, lanes, span, tile, wide, max(1, blocks))


@functools.lru_cache(maxsize=1024)
def _scatter_plan_on(index: int, B: int, R: int, C: int, n_rows: int,
                     start: int) -> ScatterPlan:
    return scatter_plan(B, R, C, n_rows, _sm_count(index), start)


def _run_ends(idx: torch.Tensor, span: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows where a run of equal indices begins, and rows where a lane group
    sends a sum: the last row of a run or of the group's `span` rows."""
    R = idx.shape[1]
    change = idx[:, 1:] != idx[:, :-1]
    head = torch.ones_like(idx, dtype=torch.bool)
    head[:, 1:] = change
    end = torch.ones_like(head)
    end[:, :-1] = change
    end |= (torch.arange(R, device=idx.device) % span == span - 1)
    return head, end


def scatter_runs(idx: torch.Tensor, n_rows: int, span: int) -> tuple[int, int, int]:
    """(rows, runs, sums sent) of the kernel over idx (B, R) with lane groups
    of `span` rows, counting only indices in [0, n_rows): rows added, runs of
    equal consecutive indices, and the sums a group sends (each one atomic
    per unit of the row)."""
    ok = (idx >= 0) & (idx < n_rows)
    head, end = _run_ends(idx, span)
    return int(ok.sum()), int((head & ok).sum()), int((end & ok).sum())


def scatter_add_runs_plain(vals: torch.Tensor, idx: torch.Tensor, n_rows: int,
                           span: int) -> torch.Tensor:
    """Plain emulation of the kernel's arithmetic: each lane group's `span`
    consecutive rows summed run by run in row order in the type of `vals`,
    each sum then added to its output row (in row order here; in any order
    on the card). An index outside [0, n_rows) is dropped."""
    B, R, C = vals.shape
    idx = idx.long()
    pad = -R % span
    v = torch.nn.functional.pad(vals, (0, 0, 0, pad)).view(B, -1, span, C)
    real = torch.nn.functional.pad(torch.ones((B, R), dtype=torch.bool, device=idx.device),
                                   (0, pad)).view(B, -1, span)
    _, end = _run_ends(idx, span)
    end = torch.nn.functional.pad(end, (0, pad)).view(B, -1, span)
    at = torch.nn.functional.pad(idx, (0, pad), value=-1).view(B, -1, span)
    out = torch.zeros((B, n_rows + 1, C), dtype=vals.dtype, device=vals.device)
    acc = torch.zeros_like(v[:, :, 0])
    bi = torch.arange(B, device=vals.device)[:, None].expand(-1, at.shape[1])
    for j in range(span):
        acc = acc + torch.where(real[:, :, j, None], v[:, :, j], 0.0)
        send = end[:, :, j] & real[:, :, j]
        row = torch.where(send & (at[:, :, j] >= 0) & (at[:, :, j] < n_rows), at[:, :, j],
                          n_rows)                             # the last row: dropped
        out.index_put_((bi[send], row[send]), acc[send], accumulate=True)
        acc = torch.where(send[..., None], 0.0, acc)
    return out[:, :n_rows]


def scatter_add_rows_cuda(vals: torch.Tensor, idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """One launch of `scatter_add_runs_kernel` into a zeroed buffer, as
    `scatter_plan` says. vals (B, R, C) float32 and idx (B, R) int32,
    contiguous CUDA tensors. Returns (B, n_rows, C) float32. The sums of
    runs are added by atomics, so their order changes from run to run."""
    _need(vals, 'vals', torch.float32, 3)
    _need(idx, 'idx', torch.int32, 2)
    _need_contiguous(vals, 'vals')
    _need_contiguous(idx, 'idx')
    B, R, C = vals.shape
    if tuple(idx.shape) != (B, R) or idx.device != vals.device or min(B, R, C, n_rows) < 1:
        raise ValueError(f'vals {tuple(vals.shape)}, idx {tuple(idx.shape)} and '
                         f'n_rows {n_rows} disagree')
    index = vals.device.index
    plan = _scatter_plan_on(index, B, R, C, int(n_rows), vals.data_ptr() % 16)
    out = torch.zeros((B, n_rows, C), dtype=torch.float32, device=vals.device)
    with kernels.on_device(index):
        err = kernels.load().scatter_add_rows_launch(
            vals.data_ptr(), idx.data_ptr(), out.data_ptr(), B, R, C, int(n_rows), plan.unit,
            plan.lanes, plan.span, int(plan.wide_index), plan.blocks, kernels.stream(index))
    if err != 0:
        raise RuntimeError(f'scatter_add_rows_launch {plan} failed with CUDA error {err}')
    scatter_add_rows_cuda.launches += 1
    return out


scatter_add_rows_cuda.launches = 0
