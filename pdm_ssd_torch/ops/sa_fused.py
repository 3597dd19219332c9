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
payloads). Ranks are an exclusive `cumsum` over the candidate axis, and the
selection is a scatter by rank. Coordinates stay float32 (the JAX package
extracts them in bf16).
"""
from __future__ import annotations

from typing import Sequence

import torch


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
    """(B, N, 3) -> (B, n_cells + 1, cap) int64 point index per slot, -1 where
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
    table = torch.full((dump + 1,), -1, dtype=torch.long, device=dev)
    table[flat.reshape(-1)] = order.reshape(-1)
    return table[:dump].view(B, n_cells + 1, cap)


def window_candidates(table: torch.Tensor, new_xyz: torch.Tensor, cell_size: float,
                      grid_wh: tuple, pc_min) -> torch.Tensor:
    """Point indices of each center's 3x3 cell window: (B, M, 9*cap), -1 where
    empty. Out-of-range centers read the empty dump row."""
    B, n_rows, cap = table.shape
    W, _ = grid_wh
    n_cells = n_rows - 1
    M = new_xyz.shape[1]
    cc = cell_ids(new_xyz, cell_size, grid_wh, pc_min)            # (B, M)
    rows = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            rows.append(torch.where(cc == n_cells, cc,
                                    (cc + dy * W + dx).clamp(0, n_cells)))
    rows = torch.stack(rows, dim=-1)                              # (B, M, 9)
    boff = (torch.arange(B, device=table.device) * n_rows)[:, None, None]
    cand = table.reshape(B * n_rows, cap)[(rows + boff).reshape(-1)]
    return cand.reshape(B, M, 9 * cap)


def flat_gather(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, ...) -> (B, ..., C)."""
    B, N, C = features.shape
    boff = (torch.arange(B, device=idx.device) * N).reshape((B,) + (1,) * (idx.dim() - 1))
    return features.reshape(B * N, C)[(idx + boff).reshape(-1)].reshape(*idx.shape, C)


def window_group(cand: torch.Tensor, xyz: torch.Tensor, new_xyz: torch.Tensor,
                 radii: Sequence[float], nsamples: Sequence[int]):
    """Per-branch selection over the candidate window.

    Returns a list over branches of (grouped_rel_xyz (B, M, K, 3),
    grouped_idx (B, M, K) int64, hit (B, M) bool)."""
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
    cand = window_candidates(table, new_xyz, cs, gw, pc_min)
    outs = []
    for bi, (rel, idx, hit) in enumerate(window_group(cand, xyz, new_xyz, radii, nsamples)):
        gf = None
        if features is not None:
            f = features
            if feat_slices is not None and feat_slices[bi] is not None:
                s0, s1 = feat_slices[bi]
                f = features[..., s0:s1]
            gf = torch.where(hit[..., None, None], flat_gather(f, idx), 0.0)
        outs.append((rel, gf, idx, hit))
    return outs
