"""Top-K selection (counterpart of `pdm_ssd_tpu/ops/selection.py`).

`topk` is `lax.top_k`: ties go to the lower index. It is a stable descending
sort, because `torch.topk` does not promise an order among ties, and a
random-init model has exact ties in every empty BEV cell.
"""
from __future__ import annotations

import torch


def topk(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties
    lower-index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def two_stage_topk(x: torch.Tensor, k: int, block: int = 16):
    """x: (..., N) -> (values, indices) of shape (..., k), as the JAX package
    computes it: the top 2 of each length-`block` window, then the top k of
    those. It misses a value only when three of the true top k share a
    window."""
    n = x.shape[-1]
    k = min(k, n)
    lead = x.shape[:-1]
    if n // block <= k:
        return topk(x, k)
    n_pad = (n + block - 1) // block * block
    if n_pad != n:
        x = torch.nn.functional.pad(x, (0, n_pad - n), value=float('-inf'))
    nb = n_pad // block
    xb = x.reshape(lead + (nb, block))
    m1 = xb.amax(dim=-1)
    a1 = torch.argmax(xb, dim=-1)                       # first index of the maximum
    iota = torch.arange(block, device=x.device)
    masked = torch.where(iota == a1[..., None], float('-inf'), xb)
    m2 = masked.amax(dim=-1)
    a2 = torch.argmax(masked, dim=-1)
    cand_v = torch.cat([m1, m2], dim=-1)                # (..., 2*nb)
    boff = torch.arange(nb, device=x.device).repeat(2) * block
    cand_i = torch.cat([a1, a2], dim=-1) + boff
    vals, sel = topk(cand_v, k)
    return vals, torch.gather(cand_i, -1, sel)
