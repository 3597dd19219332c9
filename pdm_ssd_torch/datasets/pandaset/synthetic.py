"""A generated mini Pandaset: one sequence a split, each of `n_frames`
frames as `.npy` files (`dataset/<seq>/lidar/<idx:02d>.npy`, (N, 4) float32
in the normative frame: x forward, y left, z up, intensity in [0, 1)), and
`pandaset_infos_{split}.pkl` whose infos carry 'gt_boxes' and 'gt_names'
after the TRAINING_CATEGORIES map (Car, Bus, Truck, Pedestrian, Cyclist).
The raw `.pkl.gz` frames and cuboids need pandas to read, so the set is
written in the form that reads without it. Seeded
(`synthetic_scene.scene`): `python -m pdm_ssd_torch.tools.make_mini_sets
--set pandaset`.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..synthetic_scene import scene

NAMES = ('Car', 'Bus', 'Truck', 'Pedestrian', 'Cyclist')
KINDS = ('vehicle', 'bus', 'truck', 'pedestrian', 'cyclist')
PROBS = (0.45, 0.1, 0.1, 0.2, 0.15)
SEQUENCES = {'train': '001', 'val': '002'}
CLASS_NAMES = ['Car', 'Pedestrian', 'Cyclist']
DATASET_CFG = {'DATASET': 'PandasetDataset',
               'INFO_PATH': {'train': ['pandaset_infos_train.pkl'],
                             'test': ['pandaset_infos_val.pkl']}}


def make_mini_pandaset(root, n_frames: int = 8, n_bg: int = 6000, seed: int = 0) -> Path:
    root = Path(root)
    rng = np.random.RandomState(seed)
    for split, seq in SEQUENCES.items():
        lidar_dir = root / 'dataset' / seq / 'lidar'
        lidar_dir.mkdir(parents=True, exist_ok=True)
        infos = []
        for i in range(n_frames):
            points, boxes, kind, _ = scene(rng, KINDS, PROBS, n_bg)
            path = lidar_dir / f'{i:02d}.npy'
            np.save(path, points)
            infos.append({'sequence': seq, 'frame_idx': i, 'frame_id': f'{seq}_{i:02d}',
                          'lidar_path': str(path.relative_to(root)), 'gt_boxes': boxes,
                          'gt_names': np.asarray(NAMES)[kind]})
        with open(root / f'pandaset_infos_{split}.pkl', 'wb') as f:
            pickle.dump(infos, f)
    return root
