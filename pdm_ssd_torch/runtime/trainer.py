"""Train and predict steps, the epoch loop and checkpoints (counterpart of
`pdm_ssd_tpu/runtime/trainer.py`).

Eager PyTorch in float32 on the model's device: one step is forward, target
assignment, losses, backward, gradient clip, optimizer update and the
BatchNorm statistics' update. A checkpoint is one `torch.save` file,
`checkpoint_epoch_<n>.pth`, holding the model's state, the optimizer's state,
the schedule's iteration and the epoch; the newest `max_ckpt_save_num` are
kept and training resumes from the newest (the JAX package's orbax manager).
No data parallelism yet (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import re
import time
from pathlib import Path

import numpy as np
import torch

from .optimization import build_optimizer_and_schedule

# the array entries of a collated batch that a model's predict reads, and
# those its training adds (the role of `_filter_device_batch` in the JAX
# package)
VOXEL_KEYS = ('voxels', 'voxel_coords', 'voxel_num_points', 'voxel_mask')
# a Waymo sequence batch's frame stack, poses and offline proposals (MPPNet)
SEQUENCE_KEYS = ('points_multi_frame', 'poses', 'roi_boxes', 'roi_scores', 'roi_labels')
# a camera batch's images, depth maps and transforms (BEVFusion)
CAMERA_KEYS = ('camera_imgs', 'camera_depth', 'camera2lidar', 'camera_intrinsics',
               'img_aug_matrix', 'lidar_aug_matrix')
INPUT_KEYS = ('points', 'points_mask') + VOXEL_KEYS + SEQUENCE_KEYS + CAMERA_KEYS
DEVICE_KEYS = INPUT_KEYS + ('gt_boxes', 'gt_mask')


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
    an unbroken one would. The single-stage models draw nothing from it."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)

    def train_step(batch: dict) -> dict:
        model.train()
        if host_prepare is not None:
            with torch.no_grad():
                batch = host_prepare(batch)
        optimizer.zero_grad()
        generator.manual_seed(optimizer.count)
        loss, tb = model.forward_with_loss(batch, target_generator=generator)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in {'loss': loss, **tb}.items()}

    return train_step


def make_predict_step(model: torch.nn.Module):
    """Returns `predict_step(batch) -> detections` in eval mode."""

    def predict_step(batch: dict) -> dict:
        model.eval()
        return model.predict(batch)

    return predict_step


def train_model(model, optimizer, schedule, loader, epochs: int, ckpt_dir=None,
                max_ckpt_save_num: int = 5, start_epoch: int = 0, logger=None,
                log_interval: int = 50, host_prepare=None) -> list:
    """Epochs `start_epoch` .. `epochs - 1` over `loader` (collated numpy
    batches) on the model's device, a checkpoint after each into `ckpt_dir`
    when given. `schedule` maps the optimizer's update count to the learning
    rate, for the log; `host_prepare` is `make_train_step`'s. Returns the
    mean loss of each epoch run."""
    device = next(model.parameters()).device
    train_step = make_train_step(model, optimizer, host_prepare)
    history = []
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        total, n = torch.zeros((), device=device), 0
        for it, batch in enumerate(loader):
            metrics = train_step(to_device_batch(batch, device))
            total += metrics['loss']
            n += 1
            if logger is not None and it % log_interval == 0:
                logger.info('epoch %d iter %d/%d loss %.4f lr %.3e ' % (
                    epoch, it, len(loader), float(metrics['loss']), schedule(optimizer.count))
                    + ' '.join(f'{k}={float(v):.4f}' for k, v in metrics.items()
                               if k != 'loss'))
        mean_loss = float(total) / max(n, 1)
        history.append(mean_loss)
        if logger is not None:
            logger.info('epoch %d done in %.1fs, mean loss %.4f' % (
                epoch, time.time() - t0, mean_loss))
        if ckpt_dir is not None:
            save_checkpoint(ckpt_dir, model, optimizer, epoch + 1, max_ckpt_save_num)
    return history


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
