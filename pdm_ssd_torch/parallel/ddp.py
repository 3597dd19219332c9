"""Data parallelism on `torch.distributed` (counterpart of
`pdm_ssd_tpu/parallel/mesh.py`).

The JAX package runs one program over the global batch, sharded on a mesh,
and XLA inserts the reductions: its BatchNorm statistics and its loss
normalisers are global by construction. Here there is one process a card
(`torchrun --nproc_per_node=N`, or `spawn`), each holding B / W samples,
and DistributedDataParallel averages the gradients of the ranks' losses.
That average is the global loss's gradient only if three things hold, and
this module gives each:

- BatchNorm takes its statistics over the global batch: `sync_sum` all-reduces
  a layer's sums through autograd (`models/layers._FlaxBatchStatistics`,
  `backbones_3d/sparse_backbone.MaskedBatchNorm`), so that its backward sums
  across the ranks too.
- Every count or sum a loss divides by is global (`global_sum`). A rank's
  loss is then its share of the global loss, the shares add up to it, and
  the train step scales each by W so that DDP's mean of the gradients is the
  gradient of the sum (`runtime/trainer.make_train_step`).
- The ROI heads draw their target sampling for the global batch and keep
  their own rows (`rank_rows`), so the draw is the one process's.

Evaluation shards the set with wrap-around padding (`shard_indices`, the
rule of `pad_batch_to`); `gather_to_rank0` brings the detections to rank 0,
which drops the padding and evaluates once.

With one process, or without a process group, every helper is the identity
and the single-card path is unchanged. A detector whose losses this module
does not hold refuses to train on several ranks (`check_held`).
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist
from torch import nn

NOT_HELD_ITEM = 'ROADMAP Queue 1 item 20'


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_distributed() -> bool:
    """A process group of more than one rank is up."""
    return world_size() > 1


def free_port() -> int:
    """A free TCP port on localhost, for a process group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def init_distributed(device: str = 'cuda', backend: str | None = None) -> torch.device:
    """Join the process group that torchrun's environment describes
    (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`).
    `device` 'cuda' takes the card of `LOCAL_RANK` (one process a card) and
    NCCL; 'cuda:<i>' that card; 'cpu' gloo. `backend` overrides the choice
    (gloo for several ranks on one card, which NCCL refuses). Returns the
    rank's device."""
    rank_ = int(os.environ.get('RANK', 0))
    world = int(os.environ.get('WORLD_SIZE', 1))
    local = int(os.environ.get('LOCAL_RANK', rank_))
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is unavailable; pass device='cpu' (--device cpu) to run on "
                               'the CPU')
        dev = torch.device('cuda', local if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    backend = backend or ('nccl' if dev.type == 'cuda' else 'gloo')
    os.environ.setdefault('MASTER_ADDR', 'localhost')
    os.environ.setdefault('MASTER_PORT', '29500')
    dist.init_process_group(backend, rank=rank_, world_size=world)
    return dev


def shutdown() -> None:
    """Leave the process group."""
    if is_initialized():
        dist.destroy_process_group()


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks, outside autograd (counts and sums that a
    loss divides by, logged metrics). `t` itself on one rank."""
    if not is_distributed():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def sync_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks through autograd: the backward sums the
    gradient over the ranks too (a BatchNorm's statistics). `t` itself on
    one rank. Like `torch.nn.SyncBatchNorm`'s, these all-reduces share the
    default group with DistributedDataParallel's gradient buckets: every
    rank issues both in the order its forward and its autograd engine run
    them, which is the same on every rank."""
    if not is_distributed():
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t)


def global_count(n: int, device):
    """The global number of a per-rank count `n` (a batch's clouds): `n`
    itself on one rank, else a float32 0-d tensor on `device`."""
    if not is_distributed():
        return n
    return global_sum(torch.tensor(float(n), device=device))


def rank_rows(draw, rows: int, *shape, generator=None, device=None) -> torch.Tensor:
    """`draw((W * rows, *shape), generator=generator, device=device)`, this
    rank's `rows` of it: with one step-seeded generator on every rank, the
    rows one process drawing for the global batch gives these samples."""
    W = world_size()
    if W == 1:
        return draw((rows, *shape), generator=generator, device=device)
    full = draw((W * rows, *shape), generator=generator, device=device)
    return full[rank() * rows:(rank() + 1) * rows]


def check_held(model: nn.Module) -> None:
    """Raise NotImplementedError for a detector whose BatchNorm statistics
    and loss normalisers are not held global across ranks. A detector class
    declares it in `DATA_PARALLEL_HELD`: True on any backbone, or the
    BACKBONE_3D names it is held on; a class without it is not held."""
    cfg = getattr(model, 'model_cfg', None)
    name = cfg.get('NAME', type(model).__name__) if cfg is not None else type(model).__name__
    backbone = (cfg.get('BACKBONE_3D') or {}).get('NAME') if cfg is not None else None
    held = getattr(type(model), 'DATA_PARALLEL_HELD', ())
    if held is True or backbone in held:
        return
    raise NotImplementedError(
        f'data-parallel training of {name} (BACKBONE_3D {backbone}) is not held: its BatchNorm '
        f'statistics or loss normalisers would stay rank-local ({NOT_HELD_ITEM})')


class LossForward(nn.Module):
    """The detector's `forward_with_loss` as the `forward` that
    DistributedDataParallel calls."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, batch: dict, target_generator=None):
        return self.net.forward_with_loss(batch, target_generator=target_generator)


def wrap_model(model: nn.Module) -> nn.Module:
    """`model` under DistributedDataParallel when a process group is up (it
    broadcasts rank 0's parameters and buffers), else `model` itself. Refuses
    a detector that `check_held` does not hold on more than one rank."""
    if not is_initialized():
        return model
    if is_distributed():
        check_held(model)
    dev = next(model.parameters()).device
    return nn.parallel.DistributedDataParallel(
        LossForward(model), device_ids=[dev.index] if dev.type == 'cuda' else None)


def unwrap(model: nn.Module) -> nn.Module:
    """The detector under `wrap_model`'s wrapper."""
    return model.module.net if isinstance(model, nn.parallel.DistributedDataParallel) else model


def padded_size(n: int, world: int | None = None) -> int:
    """The smallest multiple of the world size at least `n`."""
    world = world or world_size()
    return -(-n // world) * world


def shard_indices(n: int, rank_: int | None = None, world: int | None = None) -> list:
    """This rank's indices of a set of `n` samples for evaluation: the set
    padded by wrap-around to `padded_size` (repeating samples from the
    start, as `pad_batch_to` does) and dealt out in turn, as
    DistributedSampler deals them. A position at or past `n` in the padded
    order is padding."""
    rank_ = rank() if rank_ is None else rank_
    world = world or world_size()
    padded = [i % n for i in range(padded_size(n, world))] if n else []
    return padded[rank_::world]


def gather_to_rank0(obj):
    """The list of every rank's `obj` on rank 0 (in rank order), None on
    the others; `[obj]` on one rank."""
    if not is_distributed():
        return [obj]
    out = [None] * world_size() if rank() == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out


def broadcast_from_rank0(obj):
    """Rank 0's `obj` on every rank."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _rank_entry(local_rank: int, fn, world: int, port: int, device: str, backend, args,
                threads):
    os.environ.update(RANK=str(local_rank), LOCAL_RANK=str(local_rank),
                      WORLD_SIZE=str(world), MASTER_ADDR='localhost', MASTER_PORT=str(port))
    if threads is not None:
        torch.set_num_threads(threads)
    dev = init_distributed(device, backend)
    try:
        fn(dev, *args)
    finally:
        shutdown()


def spawn(fn, nprocs: int, device: str = 'cuda', backend: str | None = None, args=(),
          threads: int | None = None, join: bool = True):
    """Run `fn(device, *args)` on `nprocs` ranks of a new process group on
    localhost, one spawned process each, and wait for them; raise if one
    fails. `fn` must be importable by name (a module's top-level function).
    `device` and `backend` are `init_distributed`'s: 'cuda' puts rank i on
    card i, 'cuda:0' with backend 'gloo' every rank on one card. `threads`
    sets each rank's torch intra-op threads. With `join` False it returns
    the processes' context at once: its `join()` waits (call it until it
    returns True)."""
    import torch.multiprocessing as mp
    return mp.start_processes(
        _rank_entry, args=(fn, nprocs, free_port(), device, backend, args, threads),
        nprocs=nprocs, join=join, start_method='spawn')
