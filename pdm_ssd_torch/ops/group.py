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
`<wrapper>.launches`.

The relative xyz that the selection returns is not differentiated: the
coordinates are raw input on every model of the port and no parameter lies
upstream of them.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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
    with torch.cuda.device(dev):
        err = lib.window_select_launch(table.data_ptr(), center_cells.data_ptr(),
                                       xyz.data_ptr(), new_xyz.data_ptr(), B, N, M, n_cells,
                                       int(grid_w), cap, nb, r2, ks, *ptrs, _stream(xyz))
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


def gather_rows_cuda(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One launch of `gather_rows_kernel`. features (B, N, C) float32 on CUDA:
    contiguous, or a channel slice `payload[..., c0:c1]` of a contiguous
    payload (rows stay where they are; the kernel gets the row stride).
    idx (B, R) int32 contiguous. Returns (B, R, C) float32."""
    _need(features, 'features', torch.float32, 3)
    _need(idx, 'idx', torch.int32, 2)
    _need_contiguous(idx, 'idx')
    B, N, C = features.shape
    R = idx.shape[1]
    ld = features.stride(1)
    if features.stride(2) != 1 or features.stride(0) != N * ld or ld < C:
        raise ValueError('features: the kernel needs dense rows at one row stride, got '
                         f'strides {features.stride()} for shape {tuple(features.shape)}')
    if idx.shape[0] != B or idx.device != features.device or min(B, N, C, R) < 1:
        raise ValueError(f'features {tuple(features.shape)} and idx {tuple(idx.shape)} disagree')
    out = torch.empty((B, R, C), dtype=torch.float32, device=features.device)
    with torch.cuda.device(features.device):
        err = kernels.load().gather_rows_launch(features.data_ptr(), idx.data_ptr(),
                                                out.data_ptr(), B, N, R, C, ld,
                                                _stream(features))
    if err != 0:
        raise RuntimeError(f'gather_rows_launch failed with CUDA error {err}')
    gather_rows_cuda.launches += 1
    return out


gather_rows_cuda.launches = 0


def scatter_add_rows_cuda(vals: torch.Tensor, idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """One launch of `scatter_add_rows_kernel` into a zeroed buffer.
    vals (B, R, C) float32 and idx (B, R) int32, contiguous CUDA tensors.
    Returns (B, n_rows, C) float32. The additions are atomic, so their order
    changes from run to run."""
    _need(vals, 'vals', torch.float32, 3)
    _need(idx, 'idx', torch.int32, 2)
    _need_contiguous(vals, 'vals')
    _need_contiguous(idx, 'idx')
    B, R, C = vals.shape
    if tuple(idx.shape) != (B, R) or idx.device != vals.device or min(B, R, C, n_rows) < 1:
        raise ValueError(f'vals {tuple(vals.shape)}, idx {tuple(idx.shape)} and '
                         f'n_rows {n_rows} disagree')
    out = torch.zeros((B, n_rows, C), dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        err = kernels.load().scatter_add_rows_launch(vals.data_ptr(), idx.data_ptr(),
                                                     out.data_ptr(), B, R, C, int(n_rows),
                                                     _stream(vals))
    if err != 0:
        raise RuntimeError(f'scatter_add_rows_launch failed with CUDA error {err}')
    scatter_add_rows_cuda.launches += 1
    return out


scatter_add_rows_cuda.launches = 0
