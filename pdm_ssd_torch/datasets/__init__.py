"""Dataset registry and `build_dataloader` (counterpart of
`pdm_ssd_tpu/datasets/__init__.py`, every dataset of its registry).

The host-side loader is torch's CPU DataLoader, for worker-process
prefetching; batches are plain numpy dicts that the loops move to the device.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch.utils.data as torch_data

from ..parallel import ddp
from .argo2.argo2_dataset import Argo2Dataset
from .custom.custom_dataset import CustomDataset
from .dataset import DatasetTemplate
from .kitti.kitti_dataset import KittiDataset
from .lyft.lyft_dataset import LyftDataset
from .nuscenes.nuscenes_dataset import NuScenesDataset
from .once.once_dataset import ONCEDataset
from .pandaset.pandaset_dataset import PandasetDataset
from .waymo.waymo_dataset import WaymoDataset

__all__ = {
    'DatasetTemplate': DatasetTemplate,
    'KittiDataset': KittiDataset,
    'CustomDataset': CustomDataset,
    'NuScenesDataset': NuScenesDataset,
    'WaymoDataset': WaymoDataset,
    'ONCEDataset': ONCEDataset,
    'LyftDataset': LyftDataset,
    'PandasetDataset': PandasetDataset,
    'Argo2Dataset': Argo2Dataset,
}


def _worker_init_fn(worker_id, seed=None):
    if seed is not None:
        np.random.seed(seed + worker_id)


class ShardSampler(torch_data.Sampler):
    """This rank's share of an evaluation set: `parallel.shard_indices`, the
    set padded by wrap-around to a multiple of the world size and dealt out
    in turn. `indices` lists them in the order the loader yields them: the
    k-th is position rank + k * W of the padded order, and a position at or
    past `n` is padding."""

    def __init__(self, n: int):
        self.n = n
        self.indices = ddp.shard_indices(n)

    def __iter__(self):
        return iter(self.indices)

    def __len__(self) -> int:
        return len(self.indices)


def build_dataloader(dataset_cfg, class_names, batch_size, dist=False, root_path=None, workers=4,
                     seed=None, logger=None, training=True, merge_all_iters_to_one_epoch=False,
                     total_epochs=0):
    """Returns (dataset, loader, sampler): a shuffled loader that drops the
    last partial batch when training, else one in order that keeps it. With
    `seed`, worker i seeds `np.random` with seed + i. `batch_size` is a
    rank's.

    With `dist` (a process group up, `parallel.init_distributed`) each rank
    loads its share: in training a DistributedSampler that shuffles by
    `seed` (0 without one) plus the epoch (`sampler.set_epoch`, which
    `runtime.trainer.train_model` calls) and drops the samples past a
    multiple of the world size; in evaluation a `ShardSampler`, whose
    padding `runtime.eval_utils.eval_one_epoch` drops. Without `dist` the
    sampler is None. `merge_all_iters_to_one_epoch` makes one epoch of
    `total_epochs` passes over the set (a dataset that reads
    MERGE_ALL_ITERS_TO_ONE_EPOCH; the KITTI one does)."""
    dataset = __all__[dataset_cfg.DATASET](
        dataset_cfg=dataset_cfg, class_names=class_names,
        root_path=root_path, training=training, logger=logger)

    if merge_all_iters_to_one_epoch:
        dataset.dataset_cfg['MERGE_ALL_ITERS_TO_ONE_EPOCH'] = True
        dataset.total_epochs = total_epochs

    sampler = None
    if dist:
        sampler = (torch_data.DistributedSampler(
            dataset, num_replicas=ddp.world_size(), rank=ddp.rank(), shuffle=True,
            seed=seed or 0, drop_last=True) if training else ShardSampler(len(dataset)))
    dataloader = torch_data.DataLoader(
        dataset, batch_size=batch_size, pin_memory=False, num_workers=workers,
        shuffle=training and sampler is None, sampler=sampler, collate_fn=dataset.collate_batch,
        drop_last=training, timeout=0,
        worker_init_fn=partial(_worker_init_fn, seed=seed) if seed is not None else None,
    )
    return dataset, dataloader, sampler
