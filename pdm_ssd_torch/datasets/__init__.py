"""Dataset registry and `build_dataloader` (counterpart of
`pdm_ssd_tpu/datasets/__init__.py`, every dataset of its registry).

The host-side loader is torch's CPU DataLoader, for worker-process
prefetching; batches are plain numpy dicts that the loops move to the device.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch.utils.data as torch_data

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


def build_dataloader(dataset_cfg, class_names, batch_size, root_path=None, workers=4,
                     seed=None, logger=None, training=True):
    """Returns (dataset, loader, None): a shuffled loader that drops the last
    partial batch when training, else one in order that keeps it. With
    `seed`, worker i seeds `np.random` with seed + i."""
    dataset = __all__[dataset_cfg.DATASET](
        dataset_cfg=dataset_cfg, class_names=class_names,
        root_path=root_path, training=training, logger=logger)

    dataloader = torch_data.DataLoader(
        dataset, batch_size=batch_size, pin_memory=False, num_workers=workers,
        shuffle=training, collate_fn=dataset.collate_batch, drop_last=training,
        timeout=0,
        worker_init_fn=partial(_worker_init_fn, seed=seed) if seed is not None else None,
    )
    return dataset, dataloader, None
