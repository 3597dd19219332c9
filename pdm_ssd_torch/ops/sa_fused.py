"""Fused set-abstraction grouping in plain PyTorch (counterpart of
`pdm_ssd_tpu/ops/sa_fused.py`).

The contract is the JAX package's:

- points are bucketed into BEV cells whose size is the largest radius; the
  grid has a one-cell empty border, and out-of-range points go to a dump cell
  that is never read;
- each cell has `cap` slots, ranked by original point index within the cell;
  points beyond the cap are dropped;
- the candidates of a center are its 3x3 cell window, `dy` outer, `dx` inner,
  slots inner;
- a candidate is in the ball when `d2 < r*r` (strict);
- the first K hits in candidate order are taken, and slots past the hit count
  repeat the first hit;
- an empty ball gives zero rows, index 0 and `hit=False`.

The port's table holds point indices, and every payload is row-gathered
after selection by those indices (the JAX package's path for wide
payloads). The table is built here in PyTorch (a sort, a running maximum and
an index scatter), as the JAX package builds its table outside its kernels.
Selection, gather and the gather's backward go through `ops/dispatch.py`:
the Hopper kernels of `csrc/group.cu` on CUDA tensors, their plain versions
in `ops/group.py` on CPU tensors. Coordinates stay float32 (the JAX package
extracts them in bf16).
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import dispatch


def cell_ids(xy: torch.Tensor, cell_size: float, grid_wh: tuple, pc_min) -> torch.Tensor:
    """BEV cell id with a one-cell empty border: in-range points land in
    [1, W-2] x [1, H-2]; out-of-range points go to the dump cell W*H."""
    W, H = grid_wh
    ix = torch.floor((xy[..., 0] - pc_min[0]) / cell_size).long()
    iy = torch.floor((xy[..., 1] - pc_min[1]) / cell_size).long()
    ok = (ix >= 1) & (ix <= W - 2) & (iy >= 1) & (iy <= H - 2)
    return torch.where(ok, iy * W + ix, torch.full_like(ix, W * H))


def grid_dims(pc_range, cell_size: float) -> tuple:
    """(W, H) including the one-cell border on each side."""
    W = int((pc_range[2] - pc_range[0]) / cell_size) + 3
    H = int((pc_range[3] - pc_range[1]) / cell_size) + 3
    return W, H


def build_slot_table(xyz: torch.Tensor, cell_size: float, grid_wh: tuple, cap: int,
                     pc_min) -> torch.Tensor:
    """(B, N, 3) -> (B, n_cells + 1, cap) int32 point index per slot, -1 where
    empty. Slots are ranked by original point index within each cell."""
    B, N, _ = xyz.shape
    W, H = grid_wh
    n_cells = W * H
    dev = xyz.device
    cell = cell_ids(xyz, cell_size, grid_wh, pc_min)              # (B, N)
    pos = torch.arange(N, device=dev)
    key_sorted, order = torch.sort(cell * N + pos, dim=1)         # keys are unique
    cell_sorted = key_sorted // N
    is_start = torch.ones_like(cell_sorted, dtype=torch.bool)
    is_start[:, 1:] = cell_sorted[:, 1:] != cell_sorted[:, :-1]
    start = torch.cummax(torch.where(is_start, pos, 0), dim=1).values
    rank = pos - start
    keep = (rank < cap) & (cell_sorted < n_cells)
    boff = (torch.arange(B, device=dev) * (n_cells + 1))[:, None]
    dump = B * (n_cells + 1) * cap
    flat = torch.where(keep, (boff + cell_sorted) * cap + rank, dump)
    table = torch.full((dump + 1,), -1, dtype=torch.int32, device=dev)
    table[flat.reshape(-1)] = order.reshape(-1).to(torch.int32)
    return table[:dump].view(B, n_cells + 1, cap)


class GatherRows(torch.autograd.Function):
    """Row gather whose backward is the row scatter-add.

    features (B, N, C), idx (B, R) -> (B, R, C); an index outside [0, N)
    reads a zero row and receives no gradient. On CUDA tensors the forward
    launches `gather_rows` and the backward `scatter_add_rows`
    (`csrc/group.cu`); on CPU tensors both run their plain versions. The
    backward launches nothing when `features` needs no gradient. Unlike the
    JAX package's `gather_rows_mm`, the gradient is not rounded to bf16."""

    @staticmethod
    def forward(ctx, features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.n_rows = features.shape[1]
        return dispatch.gather_rows(features, idx)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        return dispatch.scatter_add_rows(grad, idx, ctx.n_rows), None


def fused_query_group(radii: Sequence[float], nsamples: Sequence[int],
                      xyz: torch.Tensor, features: torch.Tensor | None,
                      new_xyz: torch.Tensor, pc_range, cap: int = 32,
                      feat_slices: Sequence[tuple] | None = None):
    """One-call multi-branch query + group for one SA level.

    xyz (B, N, 3), features (B, N, C) or None, new_xyz (B, M, 3);
    pc_range: (xmin, ymin, xmax, ymax). Returns a list over branches of
    (rel_xyz (B, M, K, 3), feats (B, M, K, Cb) or None, idx (B, M, K), hit (B, M))."""
    cs = float(max(radii))
    gw = grid_dims(pc_range, cs)
    pc_min = (float(pc_range[0]) - cs, float(pc_range[1]) - cs)
    table = build_slot_table(xyz, cs, gw, cap, pc_min)
    # the centers are bucketed by the code that bucketed the points
    center_cells = cell_ids(new_xyz, cs, gw, pc_min)
    selected = dispatch.window_select(table, center_cells, gw[0], xyz, new_xyz, radii, nsamples)
    B, M = new_xyz.shape[:2]
    outs = []
    for bi, (rel, idx, hit) in enumerate(selected):
        gf = None
        if features is not None:
            f = features
            if feat_slices is not None and feat_slices[bi] is not None:
                s0, s1 = feat_slices[bi]
                f = features[..., s0:s1]
            # an empty ball reads index -1: a zero row that takes no gradient
            rows = torch.where(hit[..., None], idx, -1).reshape(B, -1)
            gf = GatherRows.apply(f, rows).reshape(B, M, -1, f.shape[-1])
        outs.append((rel, gf, idx, hit))
    return outs
