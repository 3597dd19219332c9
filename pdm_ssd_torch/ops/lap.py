"""Exact linear assignment for TransFusion's target matching (counterpart of
`pdm_ssd_tpu/ops/lap.py`, a jax-free copy).

- `np_lap`: Jonker-Volgenant shortest augmenting path in numpy float64 on
  the host; `lap_host` hands it a batch of costs, detached and copied to the
  CPU, where the JAX package calls it through `jax.pure_callback` and the
  reference through `.cpu()` and scipy (`hungarian_assigner.py:113-118`).
- `auction_lap`: Bertsekas' auction with epsilon scaling in torch, on the
  device of its cost (`LAP_BACKEND: auction`), square-padded with perturbed
  dummy bidders; exact for the integer-quantized costs.
"""
from __future__ import annotations

import numpy as np
import torch


def auction_lap(cost: torch.Tensor, bidder_mask: torch.Tensor | None = None,
                item_mask: torch.Tensor | None = None, scale: float = 1e5,
                eps_theta: float = 5.0, max_iters_per_phase: int = 2000) -> torch.Tensor:
    """Minimize the sum of cost[i, assign[i]] over distinct items. cost (M, Q)
    with M <= Q (bidders x items); bidder_mask (M,) and item_mask (Q,) bool.
    Returns (M,) int32, the item of each bidder, -1 for a masked bidder or
    one left without a valid item. The JAX package's algorithm step for
    step, one `while` loop a phase (it syncs with the host once a round)."""
    M0, Q = cost.shape
    dev = cost.device
    if bidder_mask is None:
        bidder_mask = torch.ones(M0, dtype=torch.bool, device=dev)
    if item_mask is None:
        item_mask = torch.ones(Q, dtype=torch.bool, device=dev)
    f32 = torch.float32
    finite = torch.where(bidder_mask[:, None] & item_mask[None, :], cost.to(f32), 0.0)
    cmax = torch.clamp(finite.abs().max(), min=1e-12)
    # every real bidder strictly prefers any valid item (integer benefits in
    # [scale, 3 * scale]); dummies and masked bidders take the leftovers, each
    # with its own sub-integer preference order so that their bids spread
    real = torch.round(-finite / cmax * scale) + 2.0 * scale
    n_pad = Q - M0
    jj = torch.arange(Q, device=dev)[None, :]
    unit = 0.4 / (Q * Q)
    dummy = -(((jj + torch.arange(n_pad, device=dev)[:, None] * 7) % Q).to(f32)) * unit
    masked_rows = -(((jj + (torch.arange(M0, device=dev)[:, None] + n_pad) * 7) % Q)
                    .to(f32)) * unit
    rows = torch.cat([torch.where(bidder_mask[:, None], real, masked_rows), dummy], dim=0)
    benefit = torch.where(item_mask[None, :], rows, -5.0 * scale)
    M = Q
    eps_final = 1.0 / (M + 1)
    n_phases = int(np.ceil(np.log(scale * (M + 1)) / np.log(eps_theta))) + 2
    ar_m, ar_q = torch.arange(M, device=dev), torch.arange(Q, device=dev)
    price = torch.zeros(Q, dtype=f32, device=dev)
    theta = torch.tensor(eps_theta, dtype=f32, device=dev)
    for phase in range(n_phases):
        eps = torch.clamp(scale / 2.0 * theta ** -torch.tensor(float(phase), dtype=f32,
                                                                device=dev), min=eps_final)
        assign = torch.full((M,), -1, dtype=torch.int64, device=dev)
        it = 0
        while bool((assign == -1).any()) and it < max_iters_per_phase:
            unas = assign == -1
            v = benefit - price[None, :]
            v1, j_star = v.max(dim=1)
            v_wo = v.clone()
            v_wo[ar_m, j_star] = float('-inf')
            v2 = v_wo.max(dim=1).values
            bid = price[j_star] + (v1 - v2) + eps
            bids = torch.where((ar_q[None, :] == j_star[:, None]) & unas[:, None],
                               bid[:, None], float('-inf'))
            best_bid, winner = bids.max(dim=0)
            has_bid = torch.isfinite(best_bid)
            price = torch.where(has_bid, best_bid, price)
            cur = assign.clamp(0, Q - 1)
            lost = (assign >= 0) & has_bid[cur] & (winner[cur] != ar_m)
            assign = torch.where(lost, -1, assign)
            item_of = torch.where((winner[None, :] == ar_m[:, None]) & has_bid[None, :],
                                  ar_q[None, :], -1)
            new_item = item_of.max(dim=1).values
            assign = torch.where(new_item >= 0, new_item, assign)
            it += 1
    assign = assign[:M0]
    got_valid = item_mask[assign.clamp(0, Q - 1)] & (assign >= 0)
    return torch.where(bidder_mask & got_valid, assign, -1).to(torch.int32)


def np_lap(cost) -> np.ndarray:
    """Jonker-Volgenant / shortest augmenting path (minimize) in numpy
    float64. cost (M, Q) with M <= Q. Returns (M,) int32, the item of each
    row."""
    cost = np.asarray(cost, np.float64)
    M, Q = cost.shape
    assert M <= Q, 'need rows <= cols'
    u = np.zeros(M)
    v = np.zeros(Q)
    col4row = np.full(M, -1, np.int64)
    row4col = np.full(Q, -1, np.int64)
    for cur_row in range(M):
        shortest = np.full(Q, np.inf)
        pred = np.full(Q, cur_row, np.int64)
        sr = np.zeros(M, bool)
        sc = np.zeros(Q, bool)
        min_val = 0.0
        i = cur_row
        sink = -1
        while sink == -1:
            sr[i] = True
            r = min_val + cost[i] - u[i] - v
            upd = (~sc) & (r < shortest)
            pred[upd] = i
            shortest[upd] = r[upd]
            masked = np.where(sc, np.inf, shortest)
            j = int(masked.argmin())
            min_val = masked[j]
            if not np.isfinite(min_val):
                raise ValueError('infeasible assignment problem')
            sc[j] = True
            if row4col[j] == -1:
                sink = j
            else:
                i = int(row4col[j])
        u[cur_row] += min_val
        rows = np.where(sr)[0]
        rows = rows[rows != cur_row]
        u[rows] += min_val - shortest[col4row[rows]]
        v[sc] += shortest[sc] - min_val
        j = sink
        while True:
            i = int(pred[j])
            row4col[j] = i
            col4row[i], j = j, col4row[i]
            if i == cur_row:
                break
    return col4row.astype(np.int32)


def np_lap_batch(cost, row_mask) -> np.ndarray:
    """(B, M, Q) costs and (B, M) row validity -> (B, M) int32, the item of
    each valid row, -1 for the masked rows."""
    cost = np.asarray(cost)
    row_mask = np.asarray(row_mask)
    B, M, _ = cost.shape
    out = np.full((B, M), -1, np.int32)
    for b in range(B):
        rows = np.where(row_mask[b])[0]
        if len(rows):
            out[b, rows] = np_lap(cost[b, rows])
    return out


def lap_host(cost: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    """`np_lap_batch` of a (B, M, Q) cost (detached and copied to the host)
    and its (B, M) row mask: (B, M) int32 on the cost's device."""
    out = np_lap_batch(cost.detach().cpu().numpy(), row_mask.cpu().numpy())
    return torch.from_numpy(out).to(cost.device)
