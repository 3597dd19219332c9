"""A generated mini Argoverse 2 set: one log a split, each of `n_frames`
sweeps as `.npy` files (`<split>/<log>/sensors/lidar/<timestamp_ns>.npy`,
(N, 4) float32: x, y, z, intensity in [0, 1)), and `argo2_infos_{split}.pkl`
whose infos carry 'gt_boxes' and 'gt_names' (REGULAR_VEHICLE, BUS,
BOX_TRUCK, PEDESTRIAN, BICYCLIST), as `argo2_utils.get_infos` writes them
from the raw feather files. The sweeps are `.npy` so that the set reads
without pandas (the raw feather files need it). Seeded
(`synthetic_scene.scene`): `python -m pdm_ssd_torch.tools.make_mini_sets
--set argo2`.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..synthetic_scene import scene

NAMES = ('REGULAR_VEHICLE', 'BUS', 'BOX_TRUCK', 'PEDESTRIAN', 'BICYCLIST')
KINDS = ('vehicle', 'bus', 'truck', 'pedestrian', 'cyclist')
PROBS = (0.45, 0.1, 0.1, 0.2, 0.15)
LOGS = {'train': '0b86f508-5df9-4a46-bc59-5b9536dbde9f',
        'val': '02678d04-cc9f-3148-9f95-1ba66347dff9'}
CLASS_NAMES = ['REGULAR_VEHICLE', 'PEDESTRIAN', 'BICYCLIST']
DATASET_CFG = {'DATASET': 'Argo2Dataset',
               'INFO_PATH': {'train': ['argo2_infos_train.pkl'],
                             'test': ['argo2_infos_val.pkl']}}


def make_mini_argo2(root, n_frames: int = 8, n_bg: int = 6000, seed: int = 0) -> Path:
    root = Path(root)
    rng = np.random.RandomState(seed)
    for split, log in LOGS.items():
        lidar_dir = root / split / log / 'sensors' / 'lidar'
        lidar_dir.mkdir(parents=True, exist_ok=True)
        infos = []
        for i in range(n_frames):
            ts = 315967376859506000 + 100_000_000 * i
            points, boxes, kind, counts = scene(rng, KINDS, PROBS, n_bg)
            path = lidar_dir / f'{ts}.npy'
            np.save(path, points)
            infos.append({'log_id': log, 'timestamp_ns': ts, 'frame_id': f'{log}_{ts}',
                          'lidar_path': str(path.relative_to(root)), 'gt_boxes': boxes,
                          'gt_names': np.asarray(NAMES)[kind], 'num_lidar_pts': counts})
        with open(root / f'argo2_infos_{split}.pkl', 'wb') as f:
            pickle.dump(infos, f)
    return root
