"""Waymo raw-data extraction (copy of `pdm_ssd_tpu/datasets/waymo/waymo_utils.py`).

The tfrecord decoding and range-image unprojection need tensorflow and the
waymo_open_dataset devkit, which neither machine has: those calls stay
behind lazy imports with a clear error. Everything downstream of the proto
objects (label conversion to the unified box format with ego-frame speeds,
the info dicts, the per-frame `.npy` files) is plain numpy, exercised by
mock frames in the tests.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

WAYMO_CLASSES = ['unknown', 'Vehicle', 'Pedestrian', 'Sign', 'Cyclist']


def drop_info_with_name(info, name):
    keep = [i for i, n in enumerate(info['name']) if n != name]
    return {k: (np.asarray(v)[keep] if len(np.asarray(v)) ==
                len(info['name']) else v) for k, v in info.items()}


def generate_labels(frame, pose):
    """Proto laser labels -> unified annotations dict with lidar-frame boxes
    (`waymo_utils.generate_labels:23-71`): lwh dims, heading, per-object
    difficulty/track ids/point counts, and global->ego-rotated speeds
    appended to the box (9-code boxes for multi-frame models)."""
    names, difficulty, dims, locs, headings = [], [], [], [], []
    trk_diff, speeds, accels, obj_ids, num_pts = [], [], [], [], []
    for lab in frame.laser_labels:
        box = lab.box
        names.append(WAYMO_CLASSES[lab.type])
        difficulty.append(lab.detection_difficulty_level)
        trk_diff.append(lab.tracking_difficulty_level)
        dims.append([box.length, box.width, box.height])
        locs.append([box.center_x, box.center_y, box.center_z])
        headings.append(box.heading)
        obj_ids.append(lab.id)
        num_pts.append(lab.num_lidar_points_in_box)
        speeds.append([lab.metadata.speed_x, lab.metadata.speed_y])
        accels.append([lab.metadata.accel_x, lab.metadata.accel_y])
    ann = {
        'name': np.array(names), 'difficulty': np.array(difficulty),
        'dimensions': np.array(dims).reshape(-1, 3),
        'location': np.array(locs).reshape(-1, 3),
        'heading_angles': np.array(headings),
        'obj_ids': np.array(obj_ids),
        'tracking_difficulty': np.array(trk_diff),
        'num_points_in_gt': np.array(num_pts),
        'speed_global': np.array(speeds).reshape(-1, 2),
        'accel_global': np.array(accels).reshape(-1, 2),
    }
    ann = drop_info_with_name(ann, 'unknown')
    if len(ann['name']) > 0:
        gspeed = np.pad(ann['speed_global'], ((0, 0), (0, 1)))
        speed = (gspeed @ np.linalg.inv(pose[:3, :3].T))[:, :2]
        ann['gt_boxes_lidar'] = np.concatenate(
            [ann['location'], ann['dimensions'],
             ann['heading_angles'][:, None], speed], axis=1)
    else:
        ann['gt_boxes_lidar'] = np.zeros((0, 9))
    return ann


def frame_to_points(frame):
    """Range images -> stacked point cloud [x, y, z, intensity, elongation,
    NLZ_flag] via the official parser (devkit-gated; the reference's
    `convert_range_image_to_point_cloud:74-161`)."""
    try:
        import tensorflow  # noqa: F401
        from waymo_open_dataset.utils import frame_utils
    except ImportError as e:
        raise RuntimeError(
            'Waymo raw extraction needs tensorflow + waymo_open_dataset '
            '(not in this image); run on a machine with the devkit or use '
            'pre-extracted npy data.') from e
    ri, cp, _, top_pose = frame_utils.parse_range_image_and_camera_projection(
        frame)
    pts, _cp = frame_utils.convert_range_image_to_point_cloud(
        frame, ri, cp, top_pose, keep_polar_features=True)
    # keep_polar_features rows: (range, intensity, elongation, x, y, z)
    out = [np.concatenate([p[:, 3:6], np.tanh(p[:, 1:2]), p[:, 2:3],
                           np.zeros_like(p[:, :1])], axis=1) for p in pts]
    return np.concatenate(out).astype(np.float32)


def process_single_sequence(sequence_file, save_path, sampled_interval=1,
                            has_label=True, frame_iter=None):
    """One tfrecord -> per-frame npy + a sequence info pkl
    (`waymo_utils.process_single_sequence:180-268`). `frame_iter` may inject
    decoded frame objects (mock-testable path); otherwise the tfrecord is
    read through tensorflow."""
    sequence_file = Path(sequence_file)
    sequence_name = sequence_file.stem.replace('.tfrecord', '')
    cur_save_dir = Path(save_path) / sequence_name
    cur_save_dir.mkdir(parents=True, exist_ok=True)
    pkl_file = cur_save_dir / f'{sequence_name}.pkl'
    if pkl_file.exists():
        return pickle.load(open(pkl_file, 'rb'))

    if frame_iter is None:
        try:
            import tensorflow as tf
            from waymo_open_dataset import dataset_pb2
        except ImportError as e:
            raise RuntimeError(
                'tfrecord reading needs tensorflow + waymo_open_dataset') from e

        def _iter():
            for data in tf.data.TFRecordDataset(str(sequence_file),
                                                compression_type=''):
                frame = dataset_pb2.Frame()
                frame.ParseFromString(bytearray(data.numpy()))
                yield frame
        frame_iter = _iter()

    infos = []
    for cnt, frame in enumerate(frame_iter):
        if cnt % sampled_interval != 0:
            continue
        pose = np.array(frame.pose.transform, np.float32).reshape(4, 4)
        info = {
            'point_cloud': {'lidar_sequence': sequence_name,
                            'sample_idx': cnt},
            'frame_id': f'{sequence_name}_{cnt:03d}',
            'metadata': {'context_name': getattr(
                getattr(frame, 'context', None), 'name', sequence_name),
                'timestamp_micros': getattr(frame, 'timestamp_micros', 0)},
            'pose': pose,
        }
        if has_label:
            info['annos'] = generate_labels(frame, pose)
        pts = frame.points if hasattr(frame, 'points') \
            else frame_to_points(frame)
        np.save(cur_save_dir / f'{cnt:04d}.npy', pts.astype(np.float32))
        info['num_points_of_each_lidar'] = [len(pts)]
        infos.append(info)
    with open(pkl_file, 'wb') as f:
        pickle.dump(infos, f)
    return infos
