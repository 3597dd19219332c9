"""Synthetic mini-Waymo sequence set (copy of
`pdm_ssd_tpu/datasets/waymo/synthetic.py`).

Builds the extracted-format layout the Waymo pipeline consumes
(`waymo_processed_data*/<seq>/NNNN.npy` + `<seq>/<seq>.pkl` infos,
`ImageSets/{train,val}.txt`) with a moving ego and global-frame objects, so
the multi-frame sequence path (`WaymoDataset.get_sequence_data`) is
exercised for real: pose-composing a previous frame into the current ego
frame lands a static global object on itself. Optionally writes an offline
stage-1 prediction pickle (per-frame ego-frame boxes + velocities) for the
USE_PREDBOX path. The same arguments give the same files, byte for byte, as
the JAX package's `make_mini_waymo`.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np


def _ego_pose(i):
    """Ego drives +x at 20 m/s (2 m per 0.1 s frame) with a slow yaw."""
    yaw = 0.02 * i
    c, s = np.cos(yaw), np.sin(yaw)
    pose = np.eye(4, dtype=np.float64)
    pose[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    pose[:3, 3] = [2.0 * i, 0.1 * i, 0.0]
    return pose


def _global_objects(rng, n_static=3, moving=True):
    """Objects in the GLOBAL frame: [x, y, z, dx, dy, dz, heading, vx, vy]."""
    objs = []
    for _ in range(n_static):
        objs.append([rng.uniform(8, 28), rng.uniform(-12, 12), 0.8,
                     4.6, 2.0, 1.7, rng.uniform(-np.pi, np.pi), 0.0, 0.0])
    if moving:
        objs.append([15.0, -6.0, 0.8, 4.6, 2.0, 1.7, 0.4, 4.0, 1.5])
    return np.array(objs, np.float64)


def _to_ego(objs_global, pose, t):
    """Global objects at time t -> ego-frame (N, 9) boxes."""
    inv = np.linalg.inv(pose)
    out = objs_global.copy()
    out[:, 0:2] += objs_global[:, 7:9] * 0.1 * t        # constant velocity
    centers = np.concatenate(
        [out[:, :3], np.ones((len(out), 1))], -1) @ inv.T
    out[:, :3] = centers[:, :3]
    out[:, 7:9] = objs_global[:, 7:9] @ inv[:2, :2].T
    out[:, 6] -= np.arctan2(pose[1, 0], pose[0, 0])
    return out.astype(np.float32)


def _frame_points(rng, boxes_ego, n_bg):
    """(N, 6) [x, y, z, intensity, elongation, NLZ=-1] ego-frame cloud."""
    bg = np.stack([rng.uniform(-10, 60, n_bg), rng.uniform(-25, 25, n_bg),
                   rng.uniform(-1.0, 2.5, n_bg),
                   rng.uniform(0, 0.6, n_bg), rng.uniform(0, 0.3, n_bg),
                   -np.ones(n_bg)], 1)
    obj_pts = []
    for b in boxes_ego:
        n = 120
        local = rng.uniform(-0.5, 0.5, (n, 3)) * b[3:6] * 0.9
        c, s = np.cos(b[6]), np.sin(b[6])
        gx = local[:, 0] * c - local[:, 1] * s + b[0]
        gy = local[:, 0] * s + local[:, 1] * c + b[1]
        gz = local[:, 2] + b[2]
        obj_pts.append(np.stack(
            [gx, gy, gz, rng.uniform(0, 0.6, n), rng.uniform(0, 0.3, n),
             -np.ones(n)], 1))
    return np.concatenate([bg] + obj_pts).astype(np.float32)


def make_mini_waymo(root, n_seq=1, n_frames=8, n_bg=2000, seed=0,
                    processed_tag='waymo_processed_data_v0_5_0',
                    with_pred_boxes=True, pred_noise=0.05,
                    class_name='Vehicle'):
    """Returns the list of sequence names. When `with_pred_boxes`, writes
    `pred_boxes.pkl` at the root (GT boxes with small noise as ego-frame
    per-frame 'predictions' + scores) consumable by
    `WaymoDataset.load_pred_boxes_to_dict`."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    (root / 'ImageSets').mkdir(parents=True, exist_ok=True)
    seq_names, pred_dicts = [], []
    for s in range(n_seq):
        seq = f'segment_{s:03d}'
        seq_names.append(seq)
        seq_dir = root / processed_tag / seq
        seq_dir.mkdir(parents=True, exist_ok=True)
        objs = _global_objects(rng)
        infos = []
        for i in range(n_frames):
            pose = _ego_pose(i)
            boxes_ego = _to_ego(objs, pose, i)
            pts = _frame_points(rng, boxes_ego, n_bg)
            np.save(seq_dir / ('%04d.npy' % i), pts)
            frame_id = f'{seq}_{i:03d}'
            names = np.array([class_name] * len(boxes_ego))
            infos.append({
                'point_cloud': {'lidar_sequence': seq, 'sample_idx': i,
                                'num_features': 6},
                'frame_id': frame_id,
                'pose': pose,
                'annos': {
                    'name': names,
                    'gt_boxes_lidar': boxes_ego,
                    'difficulty': np.zeros(len(boxes_ego), np.int32),
                    'num_points_in_gt': np.full(len(boxes_ego), 120,
                                                np.int32),
                },
            })
            if with_pred_boxes:
                noisy = boxes_ego.copy()
                noisy[:, :3] += rng.uniform(-pred_noise, pred_noise,
                                            (len(noisy), 3))
                pred_dicts.append({
                    'frame_id': frame_id, 'name': names,
                    'boxes_lidar': noisy,
                    'score': rng.uniform(0.6, 0.95, len(noisy)).astype(
                        np.float32),
                })
        with open(seq_dir / f'{seq}.pkl', 'wb') as f:
            pickle.dump(infos, f)
    for split in ('train', 'val'):
        (root / 'ImageSets' / f'{split}.txt').write_text(
            '\n'.join(seq_names) + '\n')
    if with_pred_boxes:
        with open(root / 'pred_boxes.pkl', 'wb') as f:
            pickle.dump(pred_dicts, f)
    return seq_names
