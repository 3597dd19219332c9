"""Plain PyTorch point-set ops (counterpart of `pdm_ssd_tpu/ops/pointnet2.py`).

`farthest_point_sample` is the plain version of the FPS kernel
(`ops/fps.py`): seed index 0, running minimum of the squared distance from
BIG, first index of the maximum. The distance is written as separate
elementwise ops, (dx*dx + dy*dy) + dz*dz, so that it rounds exactly like the
kernel. With a mask it is the JAX package's masked FPS: the seed is the first
valid index (0 where none is), and a point outside the mask reads -1 among
the candidates. `sector_fps` is PV-RCNN++'s sector FPS, one masked FPS a
sector.

`ball_query` is the plain version of the ball-query kernel
(`ops/ball_query.py`) and its contract: for each center the first `nsample`
points in point order with `d2 < r*r` (strict), an underfull ball repeats its
first hit, an empty ball is all zeros. Its distance is written out in the
same way, for the same reason. `three_nn` returns squared distances, and
`three_interpolate_weights` takes the square root itself.

`ball_query` and `three_nn` walk the dense (centers x points) distance matrix
in chunks of `CHUNK_ELEMS` elements, so their peak memory does not grow with
the product of the two clouds' sizes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .group import flat_gather

BIG = 1e10
# elements of one chunk of a dense (batch, rows, points) distance matrix
CHUNK_ELEMS = 1 << 25


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """xyz: (B, N, 3), mask (B, N) bool or None -> (B, npoint) int32
    indices. Without a mask the first is always 0; with one it is the first
    valid index, and once every valid point is picked the picks are the
    lowest valid index (a row with no valid point picks 0 throughout)."""
    B, N, _ = xyz.shape
    x = xyz.float()
    xs, ys, zs = x[..., 0], x[..., 1], x[..., 2]
    dists = torch.full((B, N), BIG, dtype=torch.float32, device=xyz.device)
    out = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    if mask is not None:
        last = torch.argmax(mask.to(torch.uint8), dim=1)   # the first valid index, else 0
        out[:, 0] = last.to(torch.int32)
    for i in range(1, npoint):
        lx = xs[rows, last][:, None]
        ly = ys[rows, last][:, None]
        lz = zs[rows, last][:, None]
        dx = xs - lx
        dy = ys - ly
        dz = zs - lz
        d = dx * dx + dy * dy + dz * dz
        dists = torch.minimum(dists, d)
        cand = dists if mask is None else torch.where(mask, dists, -1.0)
        last = torch.argmax(cand, dim=1)    # first index of the maximum
        out[:, i] = last.to(torch.int32)
    return out


def sector_masks(xyz: torch.Tensor, valid: torch.Tensor, num_sectors: int) -> torch.Tensor:
    """The valid points of each azimuth sector: (B, N, 3), (B, N) -> (B, S, N)
    bool, sector s holding the angles atan2(y, x) + pi in [s, s + 1) times
    2 pi / S (the last sector takes the angle 2 pi)."""
    S = int(num_sectors)
    x = xyz.float()
    ang = torch.atan2(x[..., 1], x[..., 0]) + math.pi
    # a true division by a device tensor: CUDA multiplies by the reciprocal
    # of a Python scalar divisor, which may round to the other sector
    width = torch.tensor(2 * math.pi / S, dtype=torch.float32, device=xyz.device)
    sec = torch.floor(ang / width).clamp(0, S - 1).long()
    return valid[:, None, :] & (sec[:, None, :] == torch.arange(S, device=xyz.device)[:, None])


def sector_fps(xyz: torch.Tensor, valid: torch.Tensor, npoint: int, num_sectors: int,
               per_sector_cap: int | None = None) -> torch.Tensor:
    """PV-RCNN++'s sector FPS (the JAX package's `sector_fps`): xyz (B, N, 3),
    valid (B, N) bool -> (B, npoint) int32 indices. The valid points are
    split into `num_sectors` azimuth sectors (`sector_masks`); one masked
    FPS a sector picks `per_sector_cap` points (all sectors of all clouds in
    one call of the FPS kernel on CUDA tensors); pick i of a sector of cnt
    points has the priority (i + 1) / cnt, a pick past cnt (or in an empty
    sector) 1e9; the npoint picks of least priority are kept, ties to the
    earlier sector and pick, as the JAX package's `top_k` of the negated
    priorities orders them."""
    B, N, _ = xyz.shape
    S = int(num_sectors)
    cap = int(per_sector_cap or npoint)
    masks = sector_masks(xyz, valid, S)
    cnt = masks.sum(dim=-1)                                          # (B, S)
    from . import dispatch                                           # dispatch imports this module
    idx = dispatch.farthest_point_sample(xyz, cap, mask=masks.reshape(B * S, N))
    idx = idx.reshape(B, S * cap)
    rank = torch.arange(cap, device=xyz.device)
    ok = (rank < cnt[..., None]) & (cnt[..., None] > 0)
    prio = torch.where(ok, (rank + 1.0) / cnt.clamp(min=1)[..., None], 1e9).reshape(B, S * cap)
    # the JAX package's top_k of -prio: least priority first, ties to the lower index
    sel = torch.argsort(prio, dim=1, stable=True)[:, :npoint]
    return torch.gather(idx, 1, sel)


def gather_operation(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, M) -> (B, M, C)."""
    C = features.shape[-1]
    return torch.gather(features, 1, idx.long()[..., None].expand(-1, -1, C))


def _pair_d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (B, R, 3), b (B, N, 3) -> (B, R, N) squared distances, each
    (dx*dx + dy*dy) + dz*dz from separate elementwise ops: the same rounding
    on the CPU, on CUDA and in the kernels, whatever order a reduction over
    the last axis would take."""
    dx = a[:, :, None, 0] - b[:, None, :, 0]
    dy = a[:, :, None, 1] - b[:, None, :, 1]
    dz = a[:, :, None, 2] - b[:, None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


def _row_chunks(B: int, rows: int, N: int):
    step = max(1, CHUNK_ELEMS // max(B * N, 1))
    return [(r0, min(r0 + step, rows)) for r0 in range(0, rows, step)]


def ball_query(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """xyz (B, N, 3), new_xyz (B, M, 3), mask (B, N) bool or None (a masked
    point is in no ball) -> (B, M, nsample) int32."""
    B, N, _ = xyz.shape
    M, K = new_xyz.shape[1], int(nsample)
    dev = xyz.device
    # a float32 tensor compared with a Python double compares in float32
    r2 = float(np.float32(float(radius) * float(radius)))
    pos = torch.arange(N, device=dev)
    k_iota = torch.arange(K, device=dev)
    out = torch.empty((B, M, K), dtype=torch.int32, device=dev)
    for m0, m1 in _row_chunks(B, M, N):
        within = _pair_d2(new_xyz[:, m0:m1].float(), xyz.float()) < r2
        if mask is not None:
            within = within & mask[:, None, :]
        w = within.long()
        rank = torch.cumsum(w, dim=-1) - w                            # exclusive
        hits = w.sum(dim=-1, keepdim=True)                            # (B, m, 1)
        slot = torch.where(within & (rank < K), rank, K)
        sel = torch.zeros((B, m1 - m0, K + 1), dtype=torch.long, device=dev)
        sel.scatter_(2, slot, pos.expand_as(slot))
        sel = sel[..., :K]
        # slots past the hit count repeat the first hit (0 in an empty ball)
        out[:, m0:m1] = torch.where(k_iota < hits, sel, sel[..., :1]).to(torch.int32)
    return out


def grouping_operation(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, M, K) -> (B, M, K, C)."""
    return flat_gather(features, idx.long())


def query_and_group(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
                    features: torch.Tensor | None, use_xyz: bool = True,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Ball query, neighbor xyz relative to the center, neighbor features
    behind them: (B, M, K, 3 + C) with `use_xyz` and features."""
    idx = ball_query(radius, nsample, xyz, new_xyz, mask=mask)
    grouped_xyz = grouping_operation(xyz, idx) - new_xyz[:, :, None, :]
    if features is None:
        if not use_xyz:
            raise ValueError('neither features nor xyz to group')
        return grouped_xyz
    grouped = grouping_operation(features, idx)
    return torch.cat([grouped_xyz, grouped], dim=-1) if use_xyz else grouped


def three_nn(unknown: torch.Tensor, known: torch.Tensor,
             known_mask: torch.Tensor | None = None):
    """The 3 nearest known points of each unknown point: squared distances
    (B, n, 3), ascending, and indices (B, n, 3) int32. Equal distances go to
    the lower index (three passes of a first-index minimum, not `topk`,
    whose order among ties is not fixed)."""
    B, n, _ = unknown.shape
    m = known.shape[1]
    if m < 3:
        raise ValueError(f'three_nn needs at least 3 known points, got {m}')
    dev = unknown.device
    dist = torch.empty((B, n, 3), dtype=torch.float32, device=dev)
    idx = torch.empty((B, n, 3), dtype=torch.int32, device=dev)
    for n0, n1 in _row_chunks(B, n, m):
        d2 = _pair_d2(unknown[:, n0:n1].float(), known.float())
        if known_mask is not None:
            d2 = torch.where(known_mask[:, None, :], d2, BIG)
        for j in range(3):
            val, arg = torch.min(d2, dim=-1, keepdim=True)            # first index of the minimum
            dist[:, n0:n1, j] = val[..., 0]
            idx[:, n0:n1, j] = arg[..., 0].to(torch.int32)
            d2.scatter_(2, arg, float('inf'))
    return dist, idx


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """features (B, m, C), idx and weight (B, n, 3) -> (B, n, C)."""
    return (grouping_operation(features, idx) * weight[..., None]).sum(dim=2)


def three_interpolate_weights(dist2: torch.Tensor) -> torch.Tensor:
    """Inverse-distance weights from squared distances: 1 / (sqrt(d2) + 1e-8),
    normalised over the three neighbors."""
    recip = 1.0 / (torch.sqrt(dist2) + 1e-8)
    return recip / recip.sum(dim=-1, keepdim=True)
