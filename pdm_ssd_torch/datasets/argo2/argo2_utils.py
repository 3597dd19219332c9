"""Argoverse 2 sensor-dataset info creation without the devkit (copy of
`pdm_ssd_tpu/datasets/argo2/argo2_utils.py`; the reference's
`pcdet/datasets/argo2/argo2_dataset.py` and `argo2_utils`). The raw format is
per-log feather files:

- `sensors/lidar/{timestamp_ns}.feather`: ego-frame sweeps (x, y, z,
  intensity, ...);
- `annotations.feather`: ego-frame cuboids per timestamp (tx/ty/tz_m,
  length/width/height_m, quaternion qw..qz, category, num_interior_pts).

The feather readers import pandas when called (`common_utils.import_pandas`)
and raise without it; `quat_to_yaw` needs none.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ...utils.common_utils import import_pandas


def quat_to_yaw(qw, qx, qy, qz):
    """Yaw about +z of a (w, x, y, z) quaternion."""
    return np.arctan2(2.0 * (qw * qz + qx * qy),
                      1.0 - 2.0 * (qy * qy + qz * qz))


def read_lidar_sweep(path):
    """A sweep's (N, 3 or 4) float32 points, intensity over 255."""
    pd = import_pandas('a raw Argoverse 2 sweep (.feather)')
    df = pd.read_feather(path)
    cols = ['x', 'y', 'z']
    if 'intensity' in df.columns:
        cols.append('intensity')
    pts = df[cols].to_numpy().astype(np.float32)
    if pts.shape[1] == 4:
        pts[:, 3] = pts[:, 3] / 255.0
    return pts


def read_annotations(path, timestamp_ns=None):
    """annotations.feather -> (boxes (N, 7), names, num_pts) for one sweep
    timestamp (or all rows when None)."""
    pd = import_pandas('raw Argoverse 2 annotations (.feather)')
    df = pd.read_feather(path)
    if timestamp_ns is not None and 'timestamp_ns' in df.columns:
        df = df[df.timestamp_ns == timestamp_ns]
    yaw = quat_to_yaw(df['qw'].to_numpy(), df['qx'].to_numpy(),
                      df['qy'].to_numpy(), df['qz'].to_numpy())
    boxes = np.stack([df['tx_m'].to_numpy(), df['ty_m'].to_numpy(),
                      df['tz_m'].to_numpy(), df['length_m'].to_numpy(),
                      df['width_m'].to_numpy(), df['height_m'].to_numpy(),
                      yaw], 1).astype(np.float32)
    names = df['category'].to_numpy().astype(str)
    num_pts = df['num_interior_pts'].to_numpy() \
        if 'num_interior_pts' in df.columns else np.ones(len(df), np.int64)
    return boxes, names, num_pts


def get_infos(root, log_ids, has_label=True):
    """Per-sweep infos: {'log_id', 'timestamp_ns', 'lidar_path',
    'gt_boxes', 'gt_names', 'num_lidar_pts'}."""
    root = Path(root)
    infos = []
    for log in log_ids:
        lidar_dir = root / log / 'sensors' / 'lidar'
        ann_path = root / log / 'annotations.feather'
        for sweep in sorted(lidar_dir.glob('*.feather')):
            ts = int(sweep.stem)
            info = {'log_id': log, 'timestamp_ns': ts,
                    'frame_id': f'{log}_{ts}',
                    'lidar_path': str(sweep.relative_to(root))}
            if has_label and ann_path.exists():
                boxes, names, num_pts = read_annotations(ann_path, ts)
                info.update({'gt_boxes': boxes, 'gt_names': names,
                             'num_lidar_pts': num_pts})
            infos.append(info)
    return infos


def create_argo2_infos(data_path, save_path, splits=('train', 'val'),
                       logger=None):
    """CLI analog: `{data_path}/{split}/<log dirs>` -> per-split info pkl."""
    data_path, save_path = Path(data_path), Path(save_path)
    for split in splits:
        split_dir = data_path / split
        if not split_dir.exists():
            continue
        logs = sorted(p.name for p in split_dir.iterdir() if p.is_dir())
        infos = get_infos(split_dir, logs)
        out = save_path / f'argo2_infos_{split}.pkl'
        with open(out, 'wb') as f:
            pickle.dump(infos, f)
        if logger:
            logger.info(f'argo2 {split}: {len(infos)} infos -> {out}')
