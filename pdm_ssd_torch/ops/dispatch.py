"""Device dispatch for the port's kernels (counterpart of
`pdm_ssd_tpu/ops/dispatch.py`).

A CPU tensor runs the plain PyTorch version. A CUDA tensor launches the
Hopper kernel, or raises: no CUDA work falls back to the plain version or to
the CPU. Any other device raises.
"""
from __future__ import annotations

import torch

from . import ball_query as bq
from . import fps, group
from . import pointnet2 as plain
from . import sparse_conv as sc


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """xyz (B, N, 3) -> (B, npoint) int32. With `mask` (B * G, N) bool, the
    masked FPS of G masked clouds over each cloud's coordinates (rows b * G
    to b * G + G - 1 over cloud b): (B * G, npoint), one launch on CUDA."""
    kind = xyz.device.type
    if kind == 'cpu':
        if mask is not None and mask.shape[0] != xyz.shape[0]:
            xyz = xyz.repeat_interleave(mask.shape[0] // xyz.shape[0], dim=0)
        return plain.farthest_point_sample(xyz, npoint, mask=mask)
    if kind == 'cuda':
        return fps.farthest_point_sample_cuda(xyz.contiguous(), npoint, mask=mask)
    raise NotImplementedError(f'no FPS for device {xyz.device}')


def ball_query_level(radii, nsamples, xyz: torch.Tensor, new_xyz: torch.Tensor,
                     mask: torch.Tensor | None = None) -> list:
    """Exact first-K ball query for all radii of one SA level: a list over
    radii of (B, M, K) int32 (one kernel launch on CUDA tensors)."""
    kind = xyz.device.type
    if kind == 'cpu':
        return [plain.ball_query(r, k, xyz, new_xyz, mask=mask) for r, k in zip(radii, nsamples)]
    if kind == 'cuda':
        return bq.ball_query_cuda(radii, nsamples, xyz.contiguous(), new_xyz.contiguous(),
                                  None if mask is None else mask.contiguous())
    raise NotImplementedError(f'no ball query for device {xyz.device}')


def ball_query(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
               pc_range=None, mask: torch.Tensor | None = None) -> torch.Tensor:
    """One radius. `pc_range` is taken and ignored, as in the JAX package's
    signature: the exact query needs no grid."""
    return ball_query_level([radius], [nsample], xyz, new_xyz, mask=mask)[0]


def grouping_operation(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, M, K) in [0, N) -> (B, M, K, C). On CUDA
    tensors the `gather_rows` kernel, with `scatter_add_rows` as its backward."""
    kind = features.device.type
    if kind == 'cpu':
        return plain.grouping_operation(features, idx)
    if kind == 'cuda':
        from .sa_fused import GatherRows      # sa_fused imports this module
        B, M, K = idx.shape
        if not group.gather_rows_reads_in_place(features):
            features = features.contiguous()
        return GatherRows.apply(features, idx.reshape(B, M * K)).reshape(B, M, K, -1)
    raise NotImplementedError(f'no grouping for device {features.device}')


def window_select(table: torch.Tensor, center_cells: torch.Tensor, grid_w: int,
                  xyz: torch.Tensor, new_xyz: torch.Tensor, radii, nsamples):
    """In-ball selection for all radii of one SA level: a list over radii of
    (rel_xyz, idx, hit). Indices are int64 from the plain version and int32
    from the kernel."""
    kind = xyz.device.type
    if kind == 'cpu':
        return group.window_select_plain(table, center_cells, grid_w, xyz, new_xyz,
                                         radii, nsamples)
    if kind == 'cuda':
        return group.window_select_cuda(table.to(torch.int32), center_cells.to(torch.int32),
                                        grid_w, xyz.contiguous(), new_xyz.contiguous(),
                                        radii, nsamples)
    raise NotImplementedError(f'no window selection for device {xyz.device}')


def gather_rows(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, R) -> (B, R, C); an index outside [0, N)
    gives a zero row. On CUDA tensors the kernel's float32 or bfloat16 entry
    point, by the rows' type; any other type raises there."""
    kind = features.device.type
    if kind == 'cpu':
        return group.gather_rows_plain(features, idx)
    if kind == 'cuda':
        return group.gather_rows_cuda(features, idx.to(torch.int32).contiguous())
    raise NotImplementedError(f'no row gather for device {features.device}')


def scatter_add_rows(vals: torch.Tensor, idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    kind = vals.device.type
    if kind == 'cpu':
        return group.scatter_add_rows_plain(vals, idx, n_rows)
    if kind == 'cuda':
        return group.scatter_add_rows_cuda(vals.contiguous(), idx.to(torch.int32).contiguous(),
                                           n_rows)
    raise NotImplementedError(f'no row scatter-add for device {vals.device}')


def sparse_conv(feats: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
                plan: sc.SparseConvPlan | None = None, bwd_nbr: torch.Tensor | None = None,
                bwd_plan: sc.SparseConvPlan | None = None) -> torch.Tensor:
    """feats (B, Vin, Cin), nbr (B, Vout, K) with entries outside [0, Vin)
    absent, weight (K*Cin, Cout) -> (B, Vout, Cout): the gather-matmul of one
    sparse conv layer. `plan` (`sc.sparse_conv_plan(nbr, Vin)`) is the
    kernel's; the plain version ignores it. Where a gradient is recorded the
    layer runs through `sc.SparseConvFunction`, whose data gradient reads
    the transposed map `bwd_nbr` (B, Vin, K) and its plan `bwd_plan`
    (`sc.sparse_conv_plan(bwd_nbr, Vout)`); the backward on CUDA tensors
    launches the kernels or raises, as the forward does."""
    kind = feats.device.type
    if kind not in ('cpu', 'cuda'):
        raise NotImplementedError(f'no sparse conv for device {feats.device}')
    if kind == 'cuda':
        feats, nbr, weight = feats.contiguous(), nbr.to(torch.int32).contiguous(), \
            weight.contiguous()
        if bwd_nbr is not None:
            bwd_nbr = bwd_nbr.to(torch.int32).contiguous()
    if torch.is_grad_enabled() and (feats.requires_grad or weight.requires_grad):
        return sc.SparseConvFunction.apply(feats, nbr, weight, plan, bwd_nbr, bwd_plan)
    if kind == 'cpu':
        return sc.sparse_conv_plain(feats, nbr, weight)
    return sc.sparse_conv_cuda(feats, nbr, weight, plan)
