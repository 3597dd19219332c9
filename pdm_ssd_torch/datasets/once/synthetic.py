"""A generated mini ONCE set: two sequences (one a split), each of
`n_frames` frames of `data/<sequence>/lidar_roof/<frame>.bin` (4 float32
columns), `ImageSets/{train,val}.txt` and `once_infos_{train,val}.pkl` with
each frame's 'annos' ('name' among Car, Bus, Truck, Pedestrian and Cyclist,
'boxes_3d' (M, 7)). Seeded (`synthetic_scene.scene`), so the set is
regenerated instead of downloaded: `python -m
pdm_ssd_torch.tools.make_mini_sets --set once`.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..synthetic_scene import scene

NAMES = ('Car', 'Bus', 'Truck', 'Pedestrian', 'Cyclist')
KINDS = ('vehicle', 'bus', 'truck', 'pedestrian', 'cyclist')
PROBS = (0.45, 0.1, 0.1, 0.2, 0.15)
SEQUENCES = {'train': '000076', 'val': '000080'}
# the flagship's three classes among the set's, in its order
CLASS_NAMES = ['Car', 'Pedestrian', 'Cyclist']
DATASET_CFG = {'DATASET': 'ONCEDataset', 'DATA_SPLIT': {'train': 'train', 'test': 'val'},
               'INFO_PATH': {'train': ['once_infos_train.pkl'], 'test': ['once_infos_val.pkl']}}


def make_mini_once(root, n_frames: int = 8, n_bg: int = 6000, seed: int = 0) -> Path:
    root = Path(root)
    rng = np.random.RandomState(seed)
    (root / 'ImageSets').mkdir(parents=True, exist_ok=True)
    for split, seq in SEQUENCES.items():
        (root / 'ImageSets' / f'{split}.txt').write_text(seq + '\n')
        lidar_dir = root / 'data' / seq / 'lidar_roof'
        lidar_dir.mkdir(parents=True, exist_ok=True)
        infos = []
        for i in range(n_frames):
            frame_id = str(1616100800000 + 100 * i + (0 if split == 'train' else 50000))
            points, boxes, kind, _ = scene(rng, KINDS, PROBS, n_bg)
            points.tofile(str(lidar_dir / f'{frame_id}.bin'))
            infos.append({'sequence_id': seq, 'frame_id': frame_id,
                          'annos': {'name': np.asarray(NAMES)[kind], 'boxes_3d': boxes}})
        with open(root / f'once_infos_{split}.pkl', 'wb') as f:
            pickle.dump(infos, f)
    return root
