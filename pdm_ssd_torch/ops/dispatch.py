"""Device dispatch for the port's kernels (counterpart of
`pdm_ssd_tpu/ops/dispatch.py`).

A CPU tensor runs the plain PyTorch version. A CUDA tensor launches the
Hopper kernel, or raises: no CUDA work falls back to the plain version or to
the CPU. Any other device raises.
"""
from __future__ import annotations

import torch

from . import fps
from . import pointnet2 as plain


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    kind = xyz.device.type
    if kind == 'cpu':
        return plain.farthest_point_sample(xyz, npoint)
    if kind == 'cuda':
        return fps.farthest_point_sample_cuda(xyz.contiguous(), npoint)
    raise NotImplementedError(f'no FPS for device {xyz.device}')
