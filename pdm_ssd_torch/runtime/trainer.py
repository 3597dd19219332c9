"""Train and predict steps, the epoch loop and checkpoints (counterpart of
`pdm_ssd_tpu/runtime/trainer.py`).

Eager PyTorch in float32 on the model's device: one step is forward, target
assignment, losses, backward, gradient clip, optimizer update and the
BatchNorm statistics' update. A checkpoint is one `torch.save` file,
`checkpoint_epoch_<n>.pth`, holding the model's state, the optimizer's state,
the schedule's iteration and the epoch; the newest `max_ckpt_save_num` are
kept and training resumes from the newest (the JAX package's orbax manager).

Data parallelism: the loops take the detector under `parallel.wrap_model`
(DistributedDataParallel, one process a card). Each rank takes its share of
the global batch; BatchNorm statistics and loss normalisers are the global
batch's (`parallel.ddp`), so W ranks take the step one process takes over
the whole batch. Rank 0 logs and writes the checkpoints; every rank loads
them.
"""
from __future__ import annotations

import re
import time
from pathlib import Path

import numpy as np
import torch

from ..parallel import ddp
from .hooks import apply_epoch_hooks
from .optimization import build_optimizer_and_schedule
from .prefetch import prefetch_batches

# the array entries of a collated batch that a model's predict reads, and
# those its training adds (the role of `_filter_device_batch` in the JAX
# package)
VOXEL_KEYS = ('voxels', 'voxel_coords', 'voxel_num_points', 'voxel_mask')
# a Waymo sequence batch's frame stack, poses and offline proposals (MPPNet)
SEQUENCE_KEYS = ('points_multi_frame', 'poses', 'roi_boxes', 'roi_scores', 'roi_labels')
# a camera batch's images, depth maps and transforms (BEVFusion)
CAMERA_KEYS = ('camera_imgs', 'camera_depth', 'camera2lidar', 'camera_intrinsics',
               'img_aug_matrix', 'lidar_aug_matrix')
# a KITTI camera batch's image transforms (CaDDN; `camera_imgs` is the
# images above) and its depth targets and 2D boxes, which its training adds
MONO_KEYS = ('trans_lidar_to_cam', 'trans_cam_to_img')
MONO_TARGET_KEYS = ('depth_maps', 'gt_boxes2d', 'gt_boxes2d_mask')
INPUT_KEYS = ('points', 'points_mask') + VOXEL_KEYS + SEQUENCE_KEYS + CAMERA_KEYS + MONO_KEYS
DEVICE_KEYS = INPUT_KEYS + ('gt_boxes', 'gt_mask') + MONO_TARGET_KEYS


def resolve_device(device=None) -> torch.device:
    """`device`, the card when None. Asking for the card where CUDA is
    unavailable raises: nothing falls back to the CPU unless told to."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("CUDA is unavailable; pass device='cpu' (--device cpu) to run on "
                           'the CPU')
    return device


def to_device_batch(batch: dict, device, keys=DEVICE_KEYS) -> dict:
    """The arrays `keys` of a collated numpy batch, as tensors on `device`.
    A voxel model's ragged raw points (padded to the batch's longest cloud,
    with a 'points_mask') stay on the host: it reads the voxels. So do the
    camera keys of a batch without images ('lidar_aug_matrix', which every
    sample carries)."""
    if 'voxels' in batch and 'points_mask' in batch:
        keys = [k for k in keys if k not in ('points', 'points_mask')]
    if 'camera_imgs' not in batch:
        keys = [k for k in keys if k not in CAMERA_KEYS]
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
            for k in keys if k in batch}


def create_train_state(model: torch.nn.Module, opt_cfg, total_iters_each_epoch: int,
                       total_epochs: int):
    """The optimizer for `model`'s parameters, on the model's device (build
    the model with `models.build_network`, which puts it on the card unless
    told otherwise). Returns (optimizer, lr schedule)."""
    return build_optimizer_and_schedule(model.parameters(), opt_cfg, total_iters_each_epoch,
                                        total_epochs)


def make_train_step(model: torch.nn.Module, optimizer, host_prepare=None):
    """Returns `train_step(batch) -> metrics`: 'loss' and the heads' entries
    as detached 0-d tensors on the model's device (no host synchronisation).
    `batch` holds the model's inputs ('points', or a voxel model's voxels),
    'gt_boxes' and 'gt_mask' on that device. `host_prepare`
    (`models.get_host_prepare(..., training=True)`) runs on the batch first,
    outside the autograd graph: the sparse ladder's maps and their
    transposes.

    A two-stage model samples its ROI targets from a `torch.Generator` on
    the model's device, seeded before each step from the optimizer's
    update count (the JAX package's `fold_in(base_key, step)`
    'targets' stream): every step draws anew, and a resumed run draws what
    an unbroken one would. The single-stage models draw nothing from it.

    `model` may be the detector under `parallel.wrap_model`: then `batch` is
    this rank's share of the global batch, the rank's loss (its share of the
    global loss) is scaled by the world size for the backward, so that
    DDP's mean of the gradients is the global loss's gradient, and the
    metrics are the global batch's, summed over the ranks."""
    net = ddp.unwrap(model)
    device = next(net.parameters()).device
    generator = torch.Generator(device=device)
    world = ddp.world_size()

    def train_step(batch: dict) -> dict:
        model.train()
        if host_prepare is not None:
            with torch.no_grad():
                batch = host_prepare(batch)
        optimizer.zero_grad()
        generator.manual_seed(optimizer.count)
        if net is model:
            loss, tb = net.forward_with_loss(batch, target_generator=generator)
        else:
            loss, tb = model(batch, target_generator=generator)
        (loss * world if world > 1 else loss).backward()
        optimizer.step()
        metrics = {k: v.detach() for k, v in {'loss': loss, **tb}.items()}
        if world > 1:
            summed = ddp.global_sum(torch.stack([v.to(loss.dtype) for v in metrics.values()]))
            metrics = dict(zip(metrics, summed.unbind()))
        return metrics

    return train_step


def make_predict_step(model: torch.nn.Module):
    """Returns `predict_step(batch) -> detections` in eval mode."""

    def predict_step(batch: dict) -> dict:
        model.eval()
        return model.predict(batch)

    return predict_step


# the steps `train_model` traces with `profile_dir` (`--profile`)
PROFILE_STEPS = 5


def train_model(model, optimizer, schedule, loader, epochs: int, ckpt_dir=None,
                max_ckpt_save_num: int = 5, start_epoch: int = 0, logger=None,
                log_interval: int = 50, host_prepare=None, hook_cfg=None, dataset=None,
                profile_dir=None) -> list:
    """Epochs `start_epoch` .. `epochs - 1` over `loader` (collated numpy
    batches) on the model's device, a checkpoint after each into `ckpt_dir`
    when given. `schedule` maps the optimizer's update count to the learning
    rate, for the log; `host_prepare` is `make_train_step`'s. `model` may be
    the detector under `parallel.wrap_model`; the loader's sampler then
    gets `set_epoch` before each epoch, and rank 0 alone logs and writes
    checkpoints. `hook_cfg` (a config's HOOK) runs `hooks.apply_epoch_hooks`
    on `dataset` before each epoch. The batches move to the device on a
    worker thread (`prefetch.prefetch_batches`), one ahead of the step.
    With `profile_dir`, a `torch.profiler` trace of the first PROFILE_STEPS
    steps goes there as `trace_rank<r>.json`. Returns the
    mean loss of each epoch run (of the global batch)."""
    net = ddp.unwrap(model)
    device = next(net.parameters()).device
    lead = ddp.rank() == 0
    log = logger if lead else None
    train_step = make_train_step(model, optimizer, host_prepare)
    profiler = start_profiler(device) if profile_dir is not None else None
    history = []
    for epoch in range(start_epoch, epochs):
        if hasattr(loader, 'sampler') and hasattr(loader.sampler, 'set_epoch'):
            loader.sampler.set_epoch(epoch)
        if dataset is not None:
            apply_epoch_hooks(hook_cfg, dataset, epoch, epochs, logger=log)
        t0 = time.time()
        total, n = torch.zeros((), device=device), 0
        batches = prefetch_batches(loader, lambda b: to_device_batch(b, device))
        for it, batch in enumerate(batches):
            metrics = train_step(batch)
            total += metrics['loss']
            n += 1
            if profiler is not None and n == PROFILE_STEPS:
                stop_profiler(profiler, profile_dir, log)
                profiler = None
            if log is not None and it % log_interval == 0:
                log.info('epoch %d iter %d/%d loss %.4f lr %.3e ' % (
                    epoch, it, len(loader), float(metrics['loss']), schedule(optimizer.count))
                    + ' '.join(f'{k}={float(v):.4f}' for k, v in metrics.items()
                               if k != 'loss'))
        mean_loss = float(total) / max(n, 1)
        history.append(mean_loss)
        if log is not None:
            log.info('epoch %d done in %.1fs, mean loss %.4f' % (
                epoch, time.time() - t0, mean_loss))
        if ckpt_dir is not None and lead:
            save_checkpoint(ckpt_dir, net, optimizer, epoch + 1, max_ckpt_save_num)
    if profiler is not None:
        stop_profiler(profiler, profile_dir, log)
    return history


def start_profiler(device: torch.device):
    """A running `torch.profiler` trace of the host, and of the card when
    `device` is one."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == 'cuda' else [])
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def stop_profiler(prof, out_dir, logger=None) -> None:
    """End the trace and write it to `out_dir/trace_rank<r>.json`."""
    prof.__exit__(None, None, None)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f'trace_rank{ddp.rank()}.json'
    prof.export_chrome_trace(str(path))
    if logger is not None:
        logger.info(f'profiler trace written to {path}')


_CKPT = re.compile(r'checkpoint_epoch_(\d+)\.pth$')


def list_checkpoints(ckpt_dir) -> list:
    """The checkpoints under `ckpt_dir`, oldest epoch first."""
    ckpt_dir = Path(ckpt_dir)
    found = [(int(m.group(1)), p) for p in ckpt_dir.glob('checkpoint_epoch_*.pth')
             if (m := _CKPT.search(p.name))] if ckpt_dir.is_dir() else []
    return [p for _, p in sorted(found)]


def save_checkpoint(ckpt_dir, model, optimizer, epoch: int, max_ckpt_save_num: int = 5) -> Path:
    """Write `checkpoint_epoch_<epoch>.pth` (the reference's `{epoch,
    model_state, optimizer_state}` plus the schedule's iteration), then keep
    the newest `max_ckpt_save_num` checkpoints."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f'checkpoint_epoch_{epoch}.pth'
    torch.save({'epoch': epoch, 'it': optimizer.count, 'model_state': model.state_dict(),
                'optimizer_state': optimizer.optimizer.state_dict()}, path)
    for old in list_checkpoints(ckpt_dir)[:-max_ckpt_save_num]:
        old.unlink()
    return path


def load_checkpoint(path, model, optimizer=None) -> int:
    """Load a checkpoint into `model` (and `optimizer`, with the schedule's
    iteration, when given), on the model's device. Returns its epoch."""
    device = next(model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(ckpt['model_state'])
    if optimizer is not None:
        optimizer.optimizer.load_state_dict(ckpt['optimizer_state'])
        optimizer.count = int(ckpt['it'])
    return int(ckpt['epoch'])


def resume(ckpt_dir, model, optimizer) -> int:
    """Auto-resume from the newest checkpoint under `ckpt_dir`: returns the
    epoch to start from (0 when there is none)."""
    ckpts = list_checkpoints(ckpt_dir)
    return load_checkpoint(ckpts[-1], model, optimizer) if ckpts else 0


def load_pretrained(path, model, logger=None) -> tuple:
    """Partial, shape-tolerant overlay of a checkpoint's weights on `model`
    (`--pretrained_model`; the JAX package's `trainer.load_pretrained`):
    every entry of the checkpoint's model state whose name `model` has, with
    the same shape, is copied; the rest keep their values. Neither the
    optimizer's state nor the update count is read. `path` is a checkpoint
    file, or a directory whose newest checkpoint is taken. Returns (entries
    loaded, entries kept)."""
    path = Path(path)
    if path.is_dir():
        ckpts = list_checkpoints(path)
        if not ckpts:
            raise FileNotFoundError(f'no checkpoint under {path}')
        path = ckpts[-1]
    device = next(model.parameters()).device
    src = torch.load(path, map_location=device, weights_only=True)['model_state']
    state = model.state_dict()
    take = {k: v for k, v in src.items() if k in state and v.shape == state[k].shape}
    model.load_state_dict(take, strict=False)
    if logger is not None:
        logger.info(f'pretrained {path}: loaded {len(take)} entries, kept {len(state) - len(take)}')
    return len(take), len(state) - len(take)
