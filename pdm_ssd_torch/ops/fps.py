"""Wrapper of the Hopper FPS kernels (`csrc/fps.cu`) and their launch plan.

Replaces `pdm_ssd_tpu/ops/pallas/fps.py:farthest_point_sample_pallas`; its
plain version is `ops/pointnet2.farthest_point_sample`. The wrapper takes
CUDA tensors only: `ops/dispatch.py` routes CPU tensors to the plain version.
`farthest_point_sample_cuda.launches` counts the kernel launches, of either
path, masked or not; `launches_cluster` and `launches_block` count them by
path, `launches_masked` those with a mask.

With a mask (PV-RCNN++'s sector FPS, `ops/pointnet2.sector_fps`) the kernels
compute the JAX package's masked FPS: the first pick is the first valid
point, a point outside the mask is never picked while a valid one is left,
and the picks after the valid points run out are the lowest valid index.
The mask may hold several rows a cloud: each row is a cloud of its own, over
the same coordinates, and all of them run in one launch.

Two kernels compute the same function. The cluster path spreads one cloud
over a thread-block cluster of S blocks, one per SM; the block path gives a
cloud one block. `fps_plan` chooses by shape: a cluster while every cloud's
cluster is resident at once (a second wave would double the time) and the
cloud is large enough that splitting it pays, else a block.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from . import kernels

# layouts the library holds (csrc/fps.cu)
CLUSTER_SIZES = (16, 8, 4, 2)
CLUSTER_MAX_THREADS = 256
CLUSTER_PPT = (1, 2, 4, 8, 16)
BLOCK_MAX_THREADS = 1024
BLOCK_PPT = (1, 2, 4, 8, 16)        # at up to 1024 threads
BLOCK_MAX_POINTS = BLOCK_MAX_THREADS * max(BLOCK_PPT)
MAX_POINTS = max(CLUSTER_SIZES) * CLUSTER_MAX_THREADS * max(CLUSTER_PPT)
# smallest cloud that takes the cluster path: below it one block's step is
# the shorter (chip_smoke.py phase 3 times both paths in turns; on an H100 at
# 700 W, 4 clouds of 4096 points took 1.06 us a step in a block and 1.17 in
# a cluster of 16 blocks, 8 clouds of 16384 points 2.18 in a block and 1.20
# in a cluster of 8; the crossover between the two sizes is not measured)
CLUSTER_MIN_POINTS = 8192


class FpsPlan(NamedTuple):
    path: str          # 'cluster' or 'block'
    S: int             # blocks per cloud (1 on the block path)
    threads: int       # threads per block
    ppt: int           # points per thread


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def cluster_layout(N: int, S: int) -> tuple[int, int] | None:
    """(threads, points a thread) of a cluster block holding ceil(N / S)
    points, or None where no layout of the library holds them."""
    per_block = -(-N // S)
    if per_block <= CLUSTER_MAX_THREADS:
        return max(32, _pow2_at_least(per_block)), 1
    ppt = _pow2_at_least(-(-per_block // CLUSTER_MAX_THREADS))
    return (CLUSTER_MAX_THREADS, ppt) if ppt in CLUSTER_PPT else None


def block_layout(N: int) -> tuple[int, int] | None:
    """(threads, points a thread) of one block holding N points, or None."""
    if N <= BLOCK_MAX_THREADS:
        return -(-N // 32) * 32, 1
    ppt = _pow2_at_least(-(-N // BLOCK_MAX_THREADS))
    return (BLOCK_MAX_THREADS, ppt) if ppt in BLOCK_PPT else None


def fps_plan(B: int, N: int, npoint: int, sm_count: int,
             max_active_clusters: Callable[[int, int, int], int],
             path: str | None = None) -> FpsPlan:
    """The launch of one FPS call. `max_active_clusters(S, threads, ppt)` is
    how many such clusters the card holds at once (the C side's
    `fps_max_active_clusters`). `path` forces 'cluster' or 'block' (to time
    both); the plan raises where the forced path cannot run."""
    if B < 1 or N < 1 or npoint < 1:
        raise ValueError(f'FPS takes B, N, npoint >= 1, got B={B} N={N} npoint={npoint}')
    if N > MAX_POINTS:
        raise ValueError(f'FPS kernel takes N <= {MAX_POINTS}, got N={N}')
    if path not in (None, 'cluster', 'block'):
        raise ValueError(f'unknown FPS path {path!r}')
    if path != 'block' and (path == 'cluster' or N >= CLUSTER_MIN_POINTS):
        for S in CLUSTER_SIZES:
            layout = cluster_layout(N, S)
            if layout is not None and B * S <= sm_count and B <= max_active_clusters(S, *layout):
                return FpsPlan('cluster', S, *layout)
    if path == 'cluster':
        raise ValueError(f'no cluster of FPS blocks fits {B} clouds of {N} points at once')
    layout = block_layout(N)
    if layout is not None:
        return FpsPlan('block', 1, *layout)
    if path == 'block':
        raise ValueError(f'one FPS block takes at most {BLOCK_MAX_POINTS} points, got N={N}')
    # a cloud too large for one block, and too many clouds for all their
    # clusters at once: the fewest blocks per cloud, the clusters in waves
    for S in reversed(CLUSTER_SIZES):
        layout = cluster_layout(N, S)
        if layout is not None:
            return FpsPlan('cluster', S, *layout)
    raise AssertionError('unreachable: N <= MAX_POINTS has a cluster layout')


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _max_active_clusters(index: int, S: int, threads: int, ppt: int) -> int:
    with torch.cuda.device(index):
        n = kernels.load().fps_max_active_clusters(S, threads, ppt)
    if n < 0:
        raise RuntimeError(f'fps_max_active_clusters failed with CUDA error {-n}')
    return n


@functools.lru_cache(maxsize=256)
def plan_for(index: int, B: int, N: int, npoint: int, path: str | None = None) -> FpsPlan:
    """`fps_plan` on card `index`, cached by shape."""
    return fps_plan(B, N, npoint, _sm_count(index),
                    functools.partial(_max_active_clusters, index), path)


def farthest_point_sample_cuda(xyz: torch.Tensor, npoint: int,
                               plan: FpsPlan | None = None,
                               mask: torch.Tensor | None = None) -> torch.Tensor:
    """xyz: (B, N, 3) float32 contiguous CUDA tensor -> (B, npoint) int32.
    With `mask`, (B * G, N) bool on the same card: G masked clouds over each
    cloud's coordinates, rows b * G to b * G + G - 1 over cloud b, and the
    result is (B * G, npoint). `plan` (default `plan_for` the shape) names
    the path and layout of the B * G clouds.

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
    clouds = B
    if mask is not None:
        if mask.dtype != torch.bool or mask.device != xyz.device:
            raise ValueError(f'FPS mask must be bool on {xyz.device}, got {mask.dtype} on '
                             f'{mask.device}')
        if mask.dim() != 2 or mask.shape[1] != N or mask.shape[0] % B != 0:
            raise ValueError(f'FPS mask must be (B * G, {N}) for B={B}, got {tuple(mask.shape)}')
        mask = mask.contiguous()
        clouds = mask.shape[0]
    index = xyz.device.index
    if plan is None:
        plan = plan_for(index, clouds, N, int(npoint))
    lib = kernels.load()
    out = torch.empty((clouds, npoint), dtype=torch.int32, device=xyz.device)
    with kernels.on_device(index):
        err = lib.fps_launch(xyz.data_ptr(), 0 if mask is None else mask.data_ptr(),
                             out.data_ptr(), clouds, N, npoint, clouds // B,
                             int(plan.path == 'cluster'), plan.S,
                             plan.threads, plan.ppt, kernels.stream(index))
    if err != 0:
        raise RuntimeError(f'fps_launch {plan} failed with CUDA error {err}')
    farthest_point_sample_cuda.launches += 1
    if mask is not None:
        farthest_point_sample_cuda.launches_masked += 1
    if plan.path == 'cluster':
        farthest_point_sample_cuda.launches_cluster += 1
    else:
        farthest_point_sample_cuda.launches_block += 1
    return out


farthest_point_sample_cuda.launches = 0
farthest_point_sample_cuda.launches_cluster = 0
farthest_point_sample_cuda.launches_block = 0
farthest_point_sample_cuda.launches_masked = 0
