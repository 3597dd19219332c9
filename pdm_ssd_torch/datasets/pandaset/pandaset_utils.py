"""Pandaset raw-data parsing without the devkit (copy of
`pdm_ssd_tpu/datasets/pandaset/pandaset_utils.py`; the reference's
`pcdet/datasets/pandaset/pandaset_dataset.py:20-260` goes through the
pandaset devkit). The raw format is gzip'd pandas pickles and a pose JSON:

- per-frame lidar `lidar/{idx:02d}.pkl.gz` (world-frame x, y, z, i, t, d)
  with poses in `lidar/poses.json`;
- cuboid annotations `annotations/cuboids/{idx:02d}.pkl.gz`;
- world -> ego via the lidar pose quaternion, then the reference's
  normative-axis remap (pandaset ego: x right, y forward, z up ->
  unified: x forward, y left, z up).

A pickled DataFrame cannot be read without pandas, so the two raw readers
import it when called (`common_utils.import_pandas`) and raise without it;
the pose algebra, `get_infos` and `create_pandaset_infos` need no pandas.
"""
from __future__ import annotations

import json
import pickle
from pathlib import Path

import numpy as np

from ...utils.common_utils import import_pandas


def quat_to_rot(q):
    """(w, x, y, z) -> 3x3."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def world_to_ego(points, pose):
    """Inverse rigid transform by the lidar pose dict
    {'position': {x,y,z}, 'heading': {w,x,y,z}} (devkit
    `ps.geometry.lidar_points_to_ego`)."""
    t = np.array([pose['position']['x'], pose['position']['y'],
                  pose['position']['z']])
    q = (pose['heading']['w'], pose['heading']['x'],
         pose['heading']['y'], pose['heading']['z'])
    R = quat_to_rot(q)
    return (np.asarray(points) - t) @ R          # R^-1 = R^T applied rowwise


def zrot_world_to_ego(pose):
    """Yaw of the world y-axis in the ego frame (`pandaset_dataset.py:
    216-231`)."""
    ypts = world_to_ego(np.array([[0., 0., 0.], [0., 1., 0.]]), pose)
    yaxis = ypts[1] - ypts[0]
    return float(np.arctan2(-yaxis[0], yaxis[1]))


def load_poses(seq_dir):
    with open(Path(seq_dir) / 'lidar' / 'poses.json') as f:
        return json.load(f)


def load_lidar_frame(path, pose, device=0):
    """Raw frame -> normative-frame (N, 4) [x, y, z, intensity/255]."""
    pd = import_pandas('a raw Pandaset frame (.pkl.gz)')
    df = pd.read_pickle(path)
    if device != -1 and 'd' in df.columns:
        df = df[df.d == device]
    arr = df.to_numpy()
    ego = world_to_ego(arr[:, :3], pose)
    pts = np.stack([ego[:, 1], -ego[:, 0], ego[:, 2],
                    arr[:, 3] / 255.0], axis=1)
    return pts.astype(np.float32)


def load_cuboids(path, pose, device=0, training_categories=None):
    """Raw cuboids -> normative boxes (N, 7) + names (`_get_annotations:
    188-252`: world->ego centers, yaw + zrot, axis remap swaps dims)."""
    pd = import_pandas('raw Pandaset cuboids (.pkl.gz)')
    cu = pd.read_pickle(path)
    if device != -1 and 'cuboids.sensor_id' in cu.columns:
        cu = cu[cu['cuboids.sensor_id'] != 1 - device]
    centers = np.stack([cu['position.x'].to_numpy(),
                        cu['position.y'].to_numpy(),
                        cu['position.z'].to_numpy()], 1)
    ego = world_to_ego(centers, pose)
    zrot = zrot_world_to_ego(pose)
    yaws = cu['yaw'].to_numpy() + zrot
    boxes = np.stack([ego[:, 1], -ego[:, 0], ego[:, 2],
                      cu['dimensions.y'].to_numpy(),
                      cu['dimensions.x'].to_numpy(),
                      cu['dimensions.z'].to_numpy(), yaws], 1)
    names = cu['label'].to_numpy()
    if training_categories:
        names = np.array([training_categories.get(str(n), str(n))
                          for n in names])
    else:
        names = names.astype(str)
    return boxes.astype(np.float32), names, zrot


def get_infos(root, sequences):
    """Path-level infos, one per frame (`get_infos:370-397`)."""
    root = Path(root)
    infos = []
    for seq in sequences:
        lidar_dir = root / 'dataset' / seq / 'lidar'
        frames = sorted(p for p in lidar_dir.glob('*.pkl.gz'))
        for p in frames:
            ii = int(p.name.split('.')[0])
            infos.append({
                'sequence': seq, 'frame_idx': ii,
                'frame_id': f'{seq}_{ii:02d}',
                'lidar_path': str(p.relative_to(root)),
                'cuboids_path': str((root / 'dataset' / seq / 'annotations'
                                     / 'cuboids' / p.name).relative_to(root)),
            })
    return infos


def create_pandaset_infos(dataset_cfg, class_names, data_path, save_path,
                          logger=None):
    """`create_pandaset_infos` analog: path infos per split pickle."""
    data_path, save_path = Path(data_path), Path(save_path)
    for split in ('train', 'val', 'test'):
        seqs = dataset_cfg.get('SEQUENCES', {}).get(split, [])
        if not seqs:
            continue
        infos = get_infos(data_path, seqs)
        out = save_path / f'pandaset_infos_{split}.pkl'
        with open(out, 'wb') as f:
            pickle.dump(infos, f)
        if logger:
            logger.info(f'pandaset {split}: {len(infos)} infos -> {out}')
