"""A generated mini Lyft Level-5 set: the raw JSON tables in the nuScenes
schema under `trainval/` (the shape of `nuscenes/synthetic.write_tables`,
with Lyft's flat category names), two scenes of `n_frames` key frames each
(`scene-0` for training, `scene-1` for validation), the sweeps as
`lidar/<token>.bin` of 5 float32 columns (x, y, z, intensity, ring), and
`lyft_infos_{train,val}.pkl` from `lyft_utils.create_lyft_infos`, as a real
set's infos are made. The ego stays at the origin; the LiDAR sits 1.7 m
above it. Seeded (`synthetic_scene.scene`): `python -m
pdm_ssd_torch.tools.make_mini_sets --set lyft`.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..synthetic_scene import scene
from .lyft_utils import create_lyft_infos

NAMES = ('car', 'bus', 'truck', 'pedestrian', 'bicycle')
KINDS = ('vehicle', 'bus', 'truck', 'pedestrian', 'cyclist')
PROBS = (0.45, 0.1, 0.1, 0.2, 0.15)
VERSION = 'trainval'
LIDAR_Z = 1.7
CLASS_NAMES = ['car', 'pedestrian', 'bicycle']
DATASET_CFG = {'DATASET': 'LyftDataset',
               'INFO_PATH': {'train': ['lyft_infos_train.pkl'], 'test': ['lyft_infos_val.pkl']}}


def _yaw_quat(yaw):
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def make_mini_lyft(root, n_frames: int = 8, n_bg: int = 6000, seed: int = 0) -> Path:
    root = Path(root)
    rng = np.random.RandomState(seed)
    v = root / VERSION
    v.mkdir(parents=True, exist_ok=True)
    (root / 'lidar').mkdir(exist_ok=True)
    samples, sds, anns, insts, scenes = [], [], [], [], []
    for sc in range(2):
        for i in range(n_frames):
            tok = f's{sc}_{i}'
            ts = 1_557_000_000_000_000 + sc * 100_000_000 + i * 200_000
            samples.append({'token': tok, 'timestamp': ts, 'scene_token': f'sc{sc}',
                            'prev': f's{sc}_{i - 1}' if i else '',
                            'next': f's{sc}_{i + 1}' if i < n_frames - 1 else ''})
            points, boxes, kind, counts = scene(rng, KINDS, PROBS, n_bg)
            ring = rng.randint(0, 64, (len(points), 1)).astype(np.float32)
            fname = f'lidar/{tok}.bin'
            np.concatenate([points, ring], 1).tofile(str(root / fname))
            sds.append({'token': f'sd{tok}', 'sample_token': tok, 'calibrated_sensor_token': 'cs0',
                        'ego_pose_token': 'ep0', 'timestamp': ts, 'is_key_frame': True,
                        'filename': fname, 'prev': '', 'next': ''})
            for j, (b, k) in enumerate(zip(boxes.astype(np.float64), kind)):
                inst = f'i{tok}_{j}'
                insts.append({'token': inst, 'category_token': f'cat{k}'})
                anns.append({'token': f'a{tok}_{j}', 'sample_token': tok, 'instance_token': inst,
                             'translation': [b[0], b[1], b[2] + LIDAR_Z],
                             'size': [b[4], b[3], b[5]],         # (w, l, h)
                             'rotation': _yaw_quat(b[6]), 'num_lidar_pts': int(counts[j]),
                             'prev': '', 'next': ''})
        scenes.append({'token': f'sc{sc}', 'name': f'scene-{sc}', 'first_sample_token': f's{sc}_0'})
    tables = {
        'sample': samples, 'sample_data': sds, 'sample_annotation': anns, 'instance': insts,
        'scene': scenes,
        'ego_pose': [{'token': 'ep0', 'translation': [0.0, 0.0, 0.0], 'rotation': [1, 0, 0, 0],
                      'timestamp': 0}],
        'calibrated_sensor': [{'token': 'cs0', 'translation': [0.0, 0.0, LIDAR_Z],
                               'rotation': [1, 0, 0, 0], 'sensor_token': 'sens0'}],
        'sensor': [{'token': 'sens0', 'channel': 'LIDAR_TOP', 'modality': 'lidar'}],
        'category': [{'token': f'cat{k}', 'name': n} for k, n in enumerate(NAMES)],
    }
    for name, recs in tables.items():
        (v / f'{name}.json').write_text(json.dumps(recs))
    create_lyft_infos(root, root, version=VERSION, train_scenes=['scene-0'],
                      val_scenes=['scene-1'])
    return root
