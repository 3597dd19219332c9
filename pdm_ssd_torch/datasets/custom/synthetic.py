"""A generated mini set in the custom layout: `points/<id>.npy` ((N, 4)
float32: x, y, z, intensity in [0, 1)), `labels/<id>.txt` ('x y z dx dy dz
heading name' a line, names Vehicle, Pedestrian and Cyclist),
`ImageSets/{train,val}.txt` of `n_frames` ids each, then the infos
(`custom_infos_{train,val}.pkl`, `CustomDataset.get_infos`) and the GT
database of the train split (`gt_database/`, `custom_dbinfos_train.pkl`,
`CustomDataset.create_groundtruth_database`), as the reference's
`create_custom_infos` makes them. Seeded (`synthetic_scene.scene`):
`python -m pdm_ssd_torch.tools.make_mini_sets --set custom`.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ...utils.config import CfgNode
from ..synthetic_scene import scene
from .custom_dataset import CustomDataset

NAMES = ('Vehicle', 'Pedestrian', 'Cyclist')
KINDS = ('vehicle', 'pedestrian', 'cyclist')
PROBS = (0.5, 0.3, 0.2)
CLASS_NAMES = list(NAMES)
DATASET_CFG = {'DATASET': 'CustomDataset', 'DATA_SPLIT': {'train': 'train', 'test': 'val'},
               'INFO_PATH': {'train': ['custom_infos_train.pkl'],
                             'test': ['custom_infos_val.pkl']}}


def tooling_cfg(root) -> CfgNode:
    """The least dataset config under which `CustomDataset` makes the infos
    and the GT database of the set at `root`."""
    return CfgNode({**DATASET_CFG, 'DATA_PATH': str(root),
                    'POINT_CLOUD_RANGE': [-50.0, -45.0, -3.0, 70.4, 45.0, 1.0],
                    'POINT_FEATURE_ENCODING': {
                        'encoding_type': 'absolute_coordinates_encoding',
                        'used_feature_list': ['x', 'y', 'z', 'intensity'],
                        'src_feature_list': ['x', 'y', 'z', 'intensity']},
                    'DATA_PROCESSOR': []})


def make_mini_custom(root, n_frames: int = 8, n_bg: int = 6000, seed: int = 0) -> Path:
    root = Path(root)
    rng = np.random.RandomState(seed)
    for sub in ('points', 'labels', 'ImageSets'):
        (root / sub).mkdir(parents=True, exist_ok=True)
    ids = {'train': [f'{i:06d}' for i in range(n_frames)],
           'val': [f'{i:06d}' for i in range(n_frames, 2 * n_frames)]}
    for split, split_ids in ids.items():
        (root / 'ImageSets' / f'{split}.txt').write_text('\n'.join(split_ids) + '\n')
        for idx in split_ids:
            points, boxes, kind, _ = scene(rng, KINDS, PROBS, n_bg)
            np.save(root / 'points' / f'{idx}.npy', points)
            (root / 'labels' / f'{idx}.txt').write_text(''.join(
                ' '.join(f'{v:.6f}' for v in b) + f' {NAMES[k]}\n' for b, k in zip(boxes, kind)))
    cfg = tooling_cfg(root)
    for split in ('train', 'val'):
        ds = CustomDataset(cfg, CLASS_NAMES, training=split == 'train', root_path=root)
        with open(root / f'custom_infos_{split}.pkl', 'wb') as f:
            pickle.dump(ds.get_infos(has_label=True), f)
    ds = CustomDataset(cfg, CLASS_NAMES, training=True, root_path=root)
    ds.create_groundtruth_database(root / 'custom_infos_train.pkl', used_classes=CLASS_NAMES,
                                   split='train')
    return root
