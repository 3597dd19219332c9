"""Lyft Level-5 info creation without the devkit (copy of
`pdm_ssd_tpu/datasets/lyft/lyft_utils.py`; the reference's
`pcdet/datasets/lyft/lyft_dataset.py:200-303` and `lyft_utils.py`).

The Lyft raw format is the nuScenes schema (JSON tables: sample,
sample_data, sample_annotation, calibrated_sensor, ego_pose, ...), so the
info creator reuses the port's nuScenes table reader
(`datasets/nuscenes/nuscenes_info.NuScenesTables`) with Lyft's flat category
names in place of the nuScenes detection-name map.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..nuscenes import nuscenes_info as NI

LYFT_CLASSES = ('car', 'truck', 'bus', 'emergency_vehicle', 'other_vehicle',
                'motorcycle', 'bicycle', 'pedestrian', 'animal')


def fill_lyft_infos(tables, scene_names, max_sweeps=1):
    """Per-sample infos in the lyft_dataset schema: 'lidar_path', 'token',
    'gt_boxes' (N, 7), 'gt_names', 'num_lidar_pts', 'sweeps'."""
    # the port's own map is swapped for the call and restored on any exit
    orig_map = NI.NAME_MAP
    try:
        # Lyft categories pass through unchanged
        NI.NAME_MAP = {c: c for c in LYFT_CLASSES}
        raw = NI.fill_infos(tables, scene_names, max_sweeps=max_sweeps)
    finally:
        NI.NAME_MAP = orig_map
    out = []
    for info in raw:
        boxes = np.asarray(info.get('gt_boxes', np.zeros((0, 9))))
        out.append({
            'lidar_path': info['lidar_path'],
            'token': info['token'],
            'sweeps': info.get('sweeps', []),
            'gt_boxes': boxes[:, :7].astype(np.float32),
            'gt_names': np.asarray(info.get('gt_names', [])),
            'num_lidar_pts': np.asarray(info.get('num_lidar_pts',
                                                 np.ones(len(boxes)))),
        })
    return out


def create_lyft_infos(data_path, save_path, version='trainval',
                      train_scenes=None, val_scenes=None, max_sweeps=1,
                      logger=None):
    """`create_lyft_infos` CLI analog: read the JSON tables, split scenes,
    dump `lyft_infos_{train,val}.pkl`."""
    data_path, save_path = Path(data_path), Path(save_path)
    tables = NI.NuScenesTables(data_path, version)
    all_scenes = [s['name'] for s in tables.t['scene'].values()]
    train_scenes = train_scenes if train_scenes is not None else all_scenes
    val_scenes = val_scenes or []
    for split, scenes in (('train', train_scenes), ('val', val_scenes)):
        infos = fill_lyft_infos(tables, scenes, max_sweeps=max_sweeps)
        out = save_path / f'lyft_infos_{split}.pkl'
        with open(out, 'wb') as f:
            pickle.dump(infos, f)
        if logger:
            logger.info(f'lyft {split}: {len(infos)} infos -> {out}')
