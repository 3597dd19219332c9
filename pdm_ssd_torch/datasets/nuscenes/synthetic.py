"""Fabricated raw-table mini nuScenes set (copy of
`pdm_ssd_tpu/datasets/nuscenes/synthetic.py`).

Writes the subset of the v1.0 JSON tables that `nuscenes_info.py` reads
(sample / sample_data / ego_pose / calibrated_sensor / sensor / annotation /
instance / category / scene) for one LIDAR_TOP stream: one scene, key
frames 0.5 s apart, a static ego pose and one car that moves 1 m a frame;
with `with_cams` also a CAM_FRONT stream whose grey PNGs carry a bright dot
where the car's centre projects. The same arguments give the same JSON
bytes and sweep files as the JAX package's `write_tables`, and images of
the same pixels (written by `image_ops.write_png`, not PIL, so the files'
bytes differ).

Deterministic; regenerated on demand instead of checked in.
"""
import json

import numpy as np

from .. import image_ops
from .nuscenes_info import MINI_TRAIN, _rot_to_quat

CAM_W, CAM_H, CAM_F = 192, 128, 80.0
# camera axes in ego frame: x_cam = -y_ego, y_cam = -z_ego, z_cam = +x_ego
CAM_R = np.array([[0., 0., 1.], [-1., 0., 0.], [0., -1., 0.]])
CAM_T = [0.5, 0.0, 1.6]


def _yaw_quat(yaw):
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def _cam_image(root, fname, dots_uv):
    """Grey PNG with a bright 7 x 7 dot at each (u, v) that lies 3 pixels
    inside the image."""
    img = np.full((CAM_H, CAM_W, 3), 50, np.uint8)
    for u, v in dots_uv:
        ui, vi = int(round(u)), int(round(v))
        if 3 <= ui < CAM_W - 3 and 3 <= vi < CAM_H - 3:
            img[vi - 3:vi + 4, ui - 3:ui + 4] = 255
    (root / fname).parent.mkdir(parents=True, exist_ok=True)
    image_ops.write_png(root / fname, img)


def write_tables(root, ego_xy=(5.0, 2.0), ego_yaw=0.3, with_cams=False,
                 lidar_points=None, n_samples=3):
    """Write the tables, the LiDAR sweeps and, with `with_cams`, the camera
    images under `root` (which must not hold a 'v1.0-mini' directory yet)
    and return `root`. `lidar_points(i)` gives frame i's (N, 5) float32
    cloud (default `_default_lidar_points`)."""
    v = root / 'v1.0-mini'
    v.mkdir(parents=True)
    (root / 'sweeps').mkdir(exist_ok=True)

    def dump(name, recs):
        (v / f'{name}.json').write_text(json.dumps(recs))

    sensors = [{'token': 'sen1', 'channel': 'LIDAR_TOP', 'modality': 'lidar'}]
    cal = [{'token': 'cs1', 'sensor_token': 'sen1',
            'translation': [0, 0, 1.8], 'rotation': [1, 0, 0, 0]}]
    if with_cams:
        sensors.append({'token': 'senc', 'channel': 'CAM_FRONT', 'modality': 'camera'})
        cal.append({'token': 'csc', 'sensor_token': 'senc', 'translation': CAM_T,
                    'rotation': list(_rot_to_quat(CAM_R)),
                    'camera_intrinsic': [[CAM_F, 0, CAM_W / 2], [0, CAM_F, CAM_H / 2],
                                         [0, 0, 1]]})
    dump('sensor', sensors)
    dump('calibrated_sensor', cal)
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
        if with_cams:
            # the landmark dot where the car's centre projects into the camera
            c, s = np.cos(-ego_yaw), np.sin(-ego_yaw)
            gx, gy = 20.0 + 1.0 * i - ego_xy[0], 5.0 - ego_xy[1]
            p_lidar = np.array([gx * c - gy * s, gx * s + gy * c, 0.5 - 1.8])
            p_cam = CAM_R.T @ (p_lidar + [0, 0, 1.8] - np.asarray(CAM_T, np.float64))
            u = CAM_F * p_cam[0] / p_cam[2] + CAM_W / 2
            vv = CAM_F * p_cam[1] / p_cam[2] + CAM_H / 2
            img_name = f'samples/cam_front_{i}.png'
            _cam_image(root, img_name, [(u, vv)])
            sds.append({'token': f'sdc{i}', 'sample_token': f's{i}',
                        'calibrated_sensor_token': 'csc',
                        'ego_pose_token': f'ego{i}', 'timestamp': ts,
                        'is_key_frame': True, 'filename': img_name,
                        'prev': '', 'next': ''})
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
