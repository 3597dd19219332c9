"""Fabricated raw-table mini nuScenes set, LiDAR half (copy of
`pdm_ssd_tpu/datasets/nuscenes/synthetic.py` without its camera stream).

Writes the subset of the v1.0 JSON tables that `nuscenes_info.py` reads
(sample / sample_data / ego_pose / calibrated_sensor / sensor / annotation /
instance / category / scene) for one LIDAR_TOP stream: one scene, key
frames 0.5 s apart, a static ego pose and one car that moves 1 m a frame.
The same arguments give the same JSON bytes and sweep files as the JAX
package's `write_tables(..., with_cams=False)`. The CAM_FRONT stream and its
PNGs belong to the camera models (ROADMAP Queue 1 item 12).

Deterministic; regenerated on demand instead of checked in.
"""
import json

import numpy as np

from .nuscenes_info import MINI_TRAIN

CAMERA_ITEM = ('the camera half of the nuScenes set is not ported yet (ROADMAP Queue 1 '
               'item 12, camera and temporal models)')


def _yaw_quat(yaw):
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def write_tables(root, ego_xy=(5.0, 2.0), ego_yaw=0.3, with_cams=False,
                 lidar_points=None, n_samples=3):
    """Write the tables and the LiDAR sweeps under `root` (which must not
    hold a 'v1.0-mini' directory yet) and return `root`. `lidar_points(i)`
    gives frame i's (N, 5) float32 cloud (default `_default_lidar_points`)."""
    if with_cams:
        raise NotImplementedError(CAMERA_ITEM)
    v = root / 'v1.0-mini'
    v.mkdir(parents=True)
    (root / 'sweeps').mkdir(exist_ok=True)

    def dump(name, recs):
        (v / f'{name}.json').write_text(json.dumps(recs))

    dump('sensor', [{'token': 'sen1', 'channel': 'LIDAR_TOP', 'modality': 'lidar'}])
    dump('calibrated_sensor', [{'token': 'cs1', 'sensor_token': 'sen1',
                                'translation': [0, 0, 1.8], 'rotation': [1, 0, 0, 0]}])
    samples, sds, egos, anns = [], [], [], []
    n = n_samples
    for i in range(n):
        ts = 1_000_000_000_000 + i * 500_000          # 0.5 s apart
        samples.append({'token': f's{i}', 'timestamp': ts,
                        'scene_token': 'sc0',
                        'prev': f's{i-1}' if i else '',
                        'next': f's{i+1}' if i < n - 1 else ''})
        egos.append({'token': f'ego{i}', 'timestamp': ts,
                     'translation': [ego_xy[0], ego_xy[1], 0.0],
                     'rotation': _yaw_quat(ego_yaw)})
        fname = f'sweeps/lidar_{i}.bin'
        if lidar_points is not None:
            pts = lidar_points(i)
        else:
            pts = _default_lidar_points(i, ego_xy, ego_yaw)
        (root / fname).write_bytes(pts.tobytes())
        sds.append({'token': f'sd{i}', 'sample_token': f's{i}',
                    'calibrated_sensor_token': 'cs1',
                    'ego_pose_token': f'ego{i}', 'timestamp': ts,
                    'is_key_frame': True, 'filename': fname,
                    'prev': f'sd{i-1}' if i else '', 'next': ''})
        # one moving car: global position advances 1 m/sample in x
        anns.append({'token': f'a{i}', 'sample_token': f's{i}',
                     'instance_token': 'inst0',
                     'translation': [20.0 + 1.0 * i, 5.0, 0.5],
                     'size': [1.9, 4.5, 1.6],        # (w, l, h)
                     'rotation': _yaw_quat(1.0),
                     'num_lidar_pts': 17,
                     'prev': f'a{i-1}' if i else '',
                     'next': f'a{i+1}' if i < n - 1 else ''})
    dump('sample', samples)
    dump('sample_data', sds)
    dump('ego_pose', egos)
    dump('sample_annotation', anns)
    dump('instance', [{'token': 'inst0', 'category_token': 'cat0'}])
    dump('category', [{'token': 'cat0', 'name': 'vehicle.car'}])
    dump('scene', [{'token': 'sc0', 'name': MINI_TRAIN[0],
                    'first_sample_token': 's0'}])
    return root


def _default_lidar_points(i, ego_xy, ego_yaw, n_bg=1024, seed=0):
    """Lidar frame cloud: background clutter + a cluster on the moving car
    so the gt box is detectable, (N, 5) float32 (x y z intensity ring)."""
    rng = np.random.RandomState(seed + i)
    bg = np.stack([rng.uniform(0, 50, n_bg), rng.uniform(-20, 20, n_bg),
                   rng.uniform(-1.8, 0.5, n_bg)], -1)
    c, s = np.cos(-ego_yaw), np.sin(-ego_yaw)
    gx, gy = 20.0 + 1.0 * i - ego_xy[0], 5.0 - ego_xy[1]
    center = np.array([gx * c - gy * s, gx * s + gy * c, 0.5 - 1.8])
    m = 128
    obj = center + np.stack([rng.uniform(-2.2, 2.2, m),
                             rng.uniform(-0.9, 0.9, m),
                             rng.uniform(-0.8, 0.8, m)], -1)
    pts = np.concatenate([bg, obj]).astype(np.float32)
    feats = rng.rand(len(pts), 2).astype(np.float32)
    return np.concatenate([pts, feats], -1)


def make_mini_nuscenes(root, with_cams=False, n_samples=3, max_sweeps=1):
    """Write tables + run devkit-free info creation; returns root."""
    from .nuscenes_info import create_nuscenes_infos
    write_tables(root, with_cams=with_cams, n_samples=n_samples)
    create_nuscenes_infos(root, 'v1.0-mini', max_sweeps=max_sweeps)
    return root
