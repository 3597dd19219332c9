"""nuScenes info creation without the devkit (copy of
`pdm_ssd_tpu/datasets/nuscenes/nuscenes_info.py`, numpy only).

The reference builds infos through the nuscenes-devkit
(`pcdet/datasets/nuscenes/nuscenes_utils.py:fill_trainval_infos:312-469`);
the raw dataset is plain JSON tables, so this module reads them directly
(sample / sample_data / ego_pose / calibrated_sensor / sample_annotation /
instance / category / scene) and produces the info schema the loader reads:

    {token, lidar_path, sweeps: [{lidar_path, transform_matrix, time_lag}],
     gt_boxes (N, 9 with global-frame velocity rotated into lidar),
     gt_names, num_lidar_pts}

plus the per-camera transforms under 'cams', which BEVFusion's camera
path reads (`nuscenes_dataset.load_camera_info`).

Usage:
    python -m pdm_ssd_torch.datasets.nuscenes.nuscenes_info \
        --root data/nuscenes --version v1.0-mini --max_sweeps 10
"""
from __future__ import annotations

import argparse
import json
import pickle
from pathlib import Path

import numpy as np

# official mini splits (scene names); trainval splits can be supplied via
# --splits_json {"train": [...], "val": [...]}
MINI_TRAIN = ['scene-0061', 'scene-0553', 'scene-0655', 'scene-0757',
              'scene-0796', 'scene-1077', 'scene-1094', 'scene-1100']
MINI_VAL = ['scene-0103', 'scene-0916']

# nuScenes detection-category mapping (`nuscenes_utils.map_name_from_general_to_detection`)
NAME_MAP = {
    'human.pedestrian.adult': 'pedestrian',
    'human.pedestrian.child': 'pedestrian',
    'human.pedestrian.construction_worker': 'pedestrian',
    'human.pedestrian.police_officer': 'pedestrian',
    'vehicle.car': 'car', 'vehicle.bus.bendy': 'bus',
    'vehicle.bus.rigid': 'bus', 'vehicle.truck': 'truck',
    'vehicle.construction': 'construction_vehicle',
    'vehicle.motorcycle': 'motorcycle', 'vehicle.bicycle': 'bicycle',
    'vehicle.trailer': 'trailer',
    'movable_object.barrier': 'barrier',
    'movable_object.trafficcone': 'traffic_cone',
}


def quat_to_rot(q) -> np.ndarray:
    """(w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def quat_yaw(q) -> float:
    """Yaw of the quaternion's rotated x-axis projected to the ground plane
    (the devkit's `quaternion_yaw`)."""
    v = quat_to_rot(q) @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


def make_tf(translation, rotation_q) -> np.ndarray:
    tf = np.eye(4)
    tf[:3, :3] = quat_to_rot(rotation_q)
    tf[:3, 3] = translation
    return tf


class NuScenesTables:
    """Raw JSON tables indexed by token."""

    def __init__(self, root: Path, version: str):
        self.root = Path(root)
        tdir = self.root / version
        self.t = {}
        for name in ['sample', 'sample_data', 'ego_pose', 'calibrated_sensor',
                     'sample_annotation', 'instance', 'category', 'scene',
                     'sensor']:
            recs = json.loads((tdir / f'{name}.json').read_text())
            self.t[name] = {r['token']: r for r in recs}
        # sample -> LIDAR_TOP sample_data (key frames); sample -> CAM_* ones
        self.lidar_of_sample = {}
        self.cams_of_sample = {}
        for sd in self.t['sample_data'].values():
            cs = self.t['calibrated_sensor'][sd['calibrated_sensor_token']]
            sensor = self.t['sensor'][cs['sensor_token']]
            if sensor['channel'] == 'LIDAR_TOP' and sd['is_key_frame']:
                self.lidar_of_sample[sd['sample_token']] = sd
            elif sensor['channel'].startswith('CAM') and sd['is_key_frame']:
                self.cams_of_sample.setdefault(
                    sd['sample_token'], {})[sensor['channel']] = sd
        # sample -> annotations
        self.anns_of_sample = {}
        for a in self.t['sample_annotation'].values():
            self.anns_of_sample.setdefault(a['sample_token'], []).append(a)

    def global_from_sensor(self, sd) -> np.ndarray:
        """lidar -> global 4x4 for a sample_data record."""
        cs = self.t['calibrated_sensor'][sd['calibrated_sensor_token']]
        ego = self.t['ego_pose'][sd['ego_pose_token']]
        return make_tf(ego['translation'], ego['rotation']) \
            @ make_tf(cs['translation'], cs['rotation'])

    def box_velocity(self, ann, eps_s: float = 1.5) -> np.ndarray:
        """Global-frame (vx, vy) from neighboring annotations of the same
        instance (the devkit's `box_velocity` central difference)."""
        def center_time(a):
            sd = self.lidar_of_sample.get(a['sample_token'])
            ts = self.t['sample'][a['sample_token']]['timestamp'] * 1e-6
            return np.asarray(a['translation']), ts

        first = self.t['sample_annotation'].get(ann['prev']) or ann
        last = self.t['sample_annotation'].get(ann['next']) or ann
        if first is ann and last is ann:
            return np.zeros(2)
        c0, t0 = center_time(first)
        c1, t1 = center_time(last)
        if t1 - t0 < 1e-6 or t1 - t0 > 2 * eps_s:
            return np.zeros(2)
        v = (c1 - c0) / (t1 - t0)
        return v[:2]


def fill_infos(tables: NuScenesTables, scene_names, max_sweeps: int = 10):
    infos = []
    for scene in tables.t['scene'].values():
        if scene['name'] not in scene_names:
            continue
        tok = scene['first_sample_token']
        while tok:
            sample = tables.t['sample'][tok]
            sd = tables.lidar_of_sample[tok]
            g_from_ref = tables.global_from_sensor(sd)
            ref_from_g = np.linalg.inv(g_from_ref)
            ref_time = sd['timestamp'] * 1e-6

            sweeps = []
            prev = sd
            while len(sweeps) < max_sweeps - 1 and prev['prev']:
                prev = tables.t['sample_data'][prev['prev']]
                tm = ref_from_g @ tables.global_from_sensor(prev)
                sweeps.append({
                    'lidar_path': prev['filename'],
                    'transform_matrix': tm,
                    'time_lag': ref_time - prev['timestamp'] * 1e-6,
                })

            names, boxes = [], []
            for ann in tables.anns_of_sample.get(tok, []):
                cat = tables.t['category'][
                    tables.t['instance'][ann['instance_token']]['category_token']]
                name = NAME_MAP.get(cat['name'])
                if name is None:
                    continue
                # global box -> lidar frame
                ctr = ref_from_g @ np.array([*ann['translation'], 1.0])
                yaw_g = quat_yaw(ann['rotation'])
                # compose with the inverse reference rotation's yaw
                ref_yaw = quat_yaw(_rot_to_quat(g_from_ref[:3, :3]))
                w, l, h = ann['size']
                vel_g = tables.box_velocity(ann)
                vel = ref_from_g[:2, :2] @ vel_g
                boxes.append([*ctr[:3], l, w, h, yaw_g - ref_yaw, *vel])
                names.append(name)

            # per-camera transforms (role of the devkit's obtain_sensor2top
            # for the 6 CAM channels; consumed by `load_camera_info`)
            cams = {}
            for chan, cam_sd in tables.cams_of_sample.get(tok, {}).items():
                cs = tables.t['calibrated_sensor'][
                    cam_sd['calibrated_sensor_token']]
                cam2lidar = ref_from_g @ tables.global_from_sensor(cam_sd)
                cams[chan] = {
                    'data_path': cam_sd['filename'],
                    'camera_intrinsics': np.asarray(
                        cs['camera_intrinsic'], np.float32),
                    'sensor2ego_rotation': cs['rotation'],
                    'sensor2ego_translation': cs['translation'],
                    'sensor2lidar_rotation': cam2lidar[:3, :3],
                    'sensor2lidar_translation': cam2lidar[:3, 3],
                }

            infos.append({
                'token': tok,
                'lidar_path': sd['filename'],
                'sweeps': sweeps,
                'cams': cams,
                'timestamp': ref_time,
                'gt_boxes': np.asarray(boxes, np.float32).reshape(-1, 9),
                'gt_names': np.asarray(names),
                'num_lidar_pts': np.asarray(
                    [a.get('num_lidar_pts', -1)
                     for a in tables.anns_of_sample.get(tok, [])
                     if NAME_MAP.get(tables.t['category'][tables.t['instance'][
                         a['instance_token']]['category_token']]['name'])]),
            })
            tok = sample['next']
    return infos


def _rot_to_quat(R) -> tuple:
    """3x3 rotation -> (w, x, y, z)."""
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    if w < 1e-8:
        # fall back through the largest diagonal element
        i = int(np.argmax([R[0, 0], R[1, 1], R[2, 2]]))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(0.0, 1 + R[i, i] - R[j, j] - R[k, k])) * 2
        q = [0.0, 0.0, 0.0, 0.0]
        q[0] = (R[k, j] - R[j, k]) / s
        q[i + 1] = s / 4
        q[j + 1] = (R[j, i] + R[i, j]) / s
        q[k + 1] = (R[k, i] + R[i, k]) / s
        return tuple(q)
    x = (R[2, 1] - R[1, 2]) / (4 * w)
    y = (R[0, 2] - R[2, 0]) / (4 * w)
    z = (R[1, 0] - R[0, 1]) / (4 * w)
    return (w, x, y, z)


def create_nuscenes_infos(root, version='v1.0-mini', max_sweeps=10,
                          splits=None):
    root = Path(root)
    tables = NuScenesTables(root, version)
    if splits is None:
        if version == 'v1.0-mini':
            splits = {'train': MINI_TRAIN, 'val': MINI_VAL}
        else:
            all_scenes = [s['name'] for s in tables.t['scene'].values()]
            splits = {'train': all_scenes, 'val': []}
    out = {}
    for split, scenes in splits.items():
        infos = fill_infos(tables, set(scenes), max_sweeps=max_sweeps)
        path = root / f'nuscenes_infos_{max_sweeps}sweeps_{split}.pkl'
        path.write_bytes(pickle.dumps(infos))
        out[split] = (len(infos), str(path))
        print(f'{split}: {len(infos)} infos -> {path}')
    return out


if __name__ == '__main__':
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', required=True)
    ap.add_argument('--version', default='v1.0-mini')
    ap.add_argument('--max_sweeps', type=int, default=10)
    ap.add_argument('--splits_json', default=None)
    args = ap.parse_args()
    sp = json.loads(Path(args.splits_json).read_text()) \
        if args.splits_json else None
    create_nuscenes_infos(args.root, args.version, args.max_sweeps, sp)
