"""Wrapper of the Hopper FPS kernel (`csrc/fps.cu`).

Replaces `pdm_ssd_tpu/ops/pallas/fps.py:farthest_point_sample_pallas`; its
plain version is `ops/pointnet2.farthest_point_sample`. The wrapper takes
CUDA tensors only: `ops/dispatch.py` routes CPU tensors to the plain version.
`farthest_point_sample_cuda.launches` counts the kernel launches.
"""
from __future__ import annotations

import torch

from . import kernels


def farthest_point_sample_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz: (B, N, 3) float32 contiguous CUDA tensor -> (B, npoint) int32.

    Launches on the current stream and does not synchronize."""
    if xyz.device.type != 'cuda':
        raise ValueError(f'FPS kernel needs a CUDA tensor, got {xyz.device}')
    if xyz.dtype != torch.float32:
        raise ValueError(f'FPS kernel needs float32, got {xyz.dtype}')
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f'FPS kernel needs (B, N, 3), got {tuple(xyz.shape)}')
    if not xyz.is_contiguous():
        raise ValueError('FPS kernel needs a contiguous tensor')
    B, N, _ = xyz.shape
    lib = kernels.load()
    if B < 1 or N < 1 or npoint < 1 or N > lib.fps_max_points():
        raise ValueError(f'FPS kernel takes 1 <= N <= {lib.fps_max_points()} '
                         f'and npoint >= 1, got B={B} N={N} npoint={npoint}')
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream(xyz.device).cuda_stream
        err = lib.fps_launch(xyz.data_ptr(), out.data_ptr(), B, N, npoint, stream)
    if err != 0:
        raise RuntimeError(f'fps_launch failed with CUDA error {err}')
    farthest_point_sample_cuda.launches += 1
    return out


farthest_point_sample_cuda.launches = 0
