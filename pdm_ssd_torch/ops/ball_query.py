"""Wrapper of the Hopper ball-query kernel (`csrc/ball_query.cu`).

Replaces `pdm_ssd_tpu/ops/pallas/retired/grid_query.py:grid_ball_query_pallas`
with the exact first-K contract of its plain version,
`ops/pointnet2.ball_query`, which it equals bit for bit. The wrapper takes
CUDA tensors only: `ops/dispatch.py` routes CPU tensors to the plain version.
One launch serves all radii of a set-abstraction level.
`ball_query_cuda.launches` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from . import kernels


def ball_query_cuda(radii: Sequence[float], nsamples: Sequence[int], xyz: torch.Tensor,
                    new_xyz: torch.Tensor, mask: torch.Tensor | None = None) -> list:
    """xyz (B, N, 3) and new_xyz (B, M, 3) float32, mask (B, N) bool or None,
    all contiguous CUDA tensors -> a list over radii of (B, M, K) int32.

    Launches on the current stream and does not synchronize."""
    tensors = [('xyz', xyz, torch.float32, 3), ('new_xyz', new_xyz, torch.float32, 3)]
    if mask is not None:
        tensors.append(('mask', mask, torch.bool, 2))
    for name, t, dtype, ndim in tensors:
        if t.device.type != 'cuda' or t.device != xyz.device:
            raise ValueError(f'{name}: the kernel needs CUDA tensors on one device, got '
                             f'{t.device}')
        if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f'{name}: the kernel needs a contiguous {dtype} tensor of {ndim} '
                             f'dimensions, got {t.dtype} {tuple(t.shape)}')
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
    outs = [torch.empty((B, M, int(K)), dtype=torch.int32, device=xyz.device) for K in nsamples]
    # the plain version compares float32 distances with the float32 rounding
    # of the Python double r*r
    r2 = (ctypes.c_float * nb)(*[float(np.float32(float(r) * float(r))) for r in radii])
    ks = (ctypes.c_int * nb)(*[int(K) for K in nsamples])
    ptrs = (ctypes.c_void_p * nb)(*[o.data_ptr() for o in outs])
    index = xyz.device.index
    with kernels.on_device(index):
        err = lib.ball_query_launch(xyz.data_ptr(), new_xyz.data_ptr(),
                                    None if mask is None else mask.data_ptr(), B, N, M, nb,
                                    r2, ks, ptrs, kernels.stream(index))
    if err != 0:
        raise RuntimeError(f'ball_query_launch failed with CUDA error {err}')
    ball_query_cuda.launches += 1
    return outs


ball_query_cuda.launches = 0
