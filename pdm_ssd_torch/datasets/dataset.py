"""Dataset template: augmentation -> feature encoding -> processing -> padded
batch (copy of `pdm_ssd_tpu/datasets/dataset.py` for LiDAR points).

- `prepare_data` keeps the reference flow (train aug with gt_boxes_mask, class
  filtering, class-index append, zero-GT resample signal, encoder+processor
  queues; `dataset.py:158-218`).
- `collate_batch` produces statically-shaped numpy arrays: points (B, N, C) —
  N is fixed by the `sample_points` processor — and gt_boxes (B, M_max, 8)
  with a boolean `gt_mask` instead of ragged zero-padding with a batch-idx
  column (`dataset.py:220-325`); the voxel keys are padded to the
  voxelizer's cap with a `voxel_mask`, as the JAX package pads them; a
  nuScenes sample's `metadata` dicts become an object array of B; a KITTI
  camera sample's 'images' and 'depth_maps' stack, and its 'gt_boxes2d' are
  padded to MAX_GT_BOXES with a `gt_boxes2d_mask`.
"""
from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np

from .augmentor.data_augmentor import DataAugmentor
from .processor.data_processor import DataProcessor
from .processor.point_feature_encoder import PointFeatureEncoder


class DatasetTemplate(object):
    def __init__(self, dataset_cfg=None, class_names=None, training=True,
                 root_path=None, logger=None):
        self.dataset_cfg = dataset_cfg
        self.training = training
        self.class_names = class_names
        self.logger = logger
        self.root_path = Path(root_path if root_path is not None else self.dataset_cfg.DATA_PATH)

        if self.dataset_cfg is None or class_names is None:
            return

        self.point_cloud_range = np.array(self.dataset_cfg.POINT_CLOUD_RANGE, dtype=np.float32)
        self.max_gt_boxes = self.dataset_cfg.get('MAX_GT_BOXES', 64)
        self.point_feature_encoder = PointFeatureEncoder(
            self.dataset_cfg.POINT_FEATURE_ENCODING,
            point_cloud_range=self.point_cloud_range)
        self.data_augmentor = DataAugmentor(
            self.root_path, self.dataset_cfg.DATA_AUGMENTOR, self.class_names,
            logger=self.logger) if self.training and self.dataset_cfg.get('DATA_AUGMENTOR') else None
        self.data_processor = DataProcessor(
            self.dataset_cfg.DATA_PROCESSOR, point_cloud_range=self.point_cloud_range,
            training=self.training,
            num_point_features=self.point_feature_encoder.num_point_features)
        self.grid_size = self.data_processor.grid_size
        self.voxel_size = self.data_processor.voxel_size

    @property
    def mode(self):
        return 'train' if self.training else 'test'

    def __len__(self):
        raise NotImplementedError

    @staticmethod
    def set_lidar_aug_matrix(data_dict):
        """Accumulated world-aug transform as a 4x4 (used to recover original
        point coordinates, e.g. for camera-depth projection; reference
        `dataset.py:134-156`)."""
        m = np.eye(4)
        if data_dict.get('flip_x', False):
            m[:3, :3] = np.diag([1., -1., 1.]) @ m[:3, :3]
        if data_dict.get('flip_y', False):
            m[:3, :3] = np.diag([-1., 1., 1.]) @ m[:3, :3]
        if 'noise_rot' in data_dict:
            a = data_dict['noise_rot']
            c, s = np.cos(a), np.sin(a)
            m[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ m[:3, :3]
        if 'noise_scale' in data_dict:
            m[:3, :3] *= data_dict['noise_scale']
        if 'noise_translate' in data_dict:
            m[:3, 3] = np.asarray(data_dict['noise_translate']).reshape(3)
        data_dict['lidar_aug_matrix'] = m.astype(np.float32)
        return data_dict

    def prepare_data(self, data_dict):
        """(`dataset.py:158-218`.) Returns None when training and augmentation
        leaves zero GT (caller resamples another index)."""
        if self.training:
            assert 'gt_boxes' in data_dict, 'gt_boxes should be provided for training'
            if self.data_augmentor is not None:
                data_dict = self.data_augmentor.forward(data_dict)
        data_dict = self.set_lidar_aug_matrix(data_dict)

        if data_dict.get('gt_boxes', None) is not None:
            selected = np.array(
                [n in self.class_names for n in data_dict['gt_names']], dtype=bool)
            data_dict['gt_boxes'] = data_dict['gt_boxes'][selected]
            data_dict['gt_names'] = data_dict['gt_names'][selected]
            gt_classes = np.array(
                [self.class_names.index(n) + 1 for n in data_dict['gt_names']],
                dtype=np.int32)
            gt_boxes = np.concatenate(
                (data_dict['gt_boxes'], gt_classes.reshape(-1, 1).astype(np.float32)),
                axis=1)
            data_dict['gt_boxes'] = gt_boxes

        if data_dict.get('points', None) is not None:
            data_dict = self.point_feature_encoder.forward(data_dict)

        data_dict = self.data_processor.forward(data_dict=data_dict)

        if self.training and len(data_dict.get('gt_boxes', [])) == 0:
            return None

        data_dict.pop('gt_names', None)
        return data_dict

    def collate_batch(self, batch_list):
        """Pad and stack into fixed-shape arrays."""
        data_dict = defaultdict(list)
        for cur_sample in batch_list:
            for key, val in cur_sample.items():
                data_dict[key].append(val)
        batch_size = len(batch_list)
        ret = {}
        for key, val in data_dict.items():
            if key == 'points':
                lens = {len(v) for v in val}
                if len(lens) == 1:
                    ret['points'] = np.stack(val, axis=0).astype(np.float32)
                else:
                    # no fixed-N sampler in the pipeline (voxel models):
                    # pad to the batch max with a validity mask
                    N = max(lens)
                    pts = np.zeros((batch_size, N, val[0].shape[-1]), np.float32)
                    pmask = np.zeros((batch_size, N), bool)
                    for i, v in enumerate(val):
                        pts[i, :len(v)] = v
                        pmask[i, :len(v)] = True
                    ret['points'] = pts
                    ret['points_mask'] = pmask
            elif key == 'gt_boxes':
                M = self.max_gt_boxes
                code = max([v.shape[1] if len(v) else 8 for v in val])
                boxes = np.zeros((batch_size, M, code), np.float32)
                mask = np.zeros((batch_size, M), bool)
                for i, v in enumerate(val):
                    n = min(len(v), M)
                    if n > 0:
                        boxes[i, :n] = v[:n]
                        mask[i, :n] = True
                ret['gt_boxes'] = boxes
                ret['gt_mask'] = mask
            elif key in ['voxels', 'voxel_coords', 'voxel_num_points']:
                # pad to the processor's static cap so batch shapes never vary
                V = getattr(self.data_processor, 'max_num_voxels', None) \
                    or max(len(v) for v in val)
                out = np.zeros((batch_size, V) + val[0].shape[1:], val[0].dtype)
                vmask = np.zeros((batch_size, V), bool)
                for i, v in enumerate(val):
                    out[i, :len(v)] = v
                    vmask[i, :len(v)] = True
                ret[key] = out
                ret.setdefault('voxel_mask', vmask)
            elif key in ['frame_id', 'calib', 'image_shape', 'use_lead_xyz',
                         'flip_x', 'flip_y', 'noise_rot', 'noise_scale']:
                ret[key] = np.array(val) if key in ['frame_id', 'image_shape'] else val
            elif key == 'gt_boxes2d':
                M = self.max_gt_boxes
                b2 = np.zeros((batch_size, M, 4), np.float32)
                m2 = np.zeros((batch_size, M), bool)
                for i, v in enumerate(val):
                    n = min(len(v), M)
                    if n > 0:
                        b2[i, :n] = v[:n]
                        m2[i, :n] = True
                ret['gt_boxes2d'] = b2
                ret['gt_boxes2d_mask'] = m2
            elif key == 'metadata':
                ret[key] = np.empty(batch_size, object)
                ret[key][:] = val
            else:
                try:
                    ret[key] = np.stack(val, axis=0)
                except Exception:
                    ret[key] = val
        ret['batch_size'] = batch_size
        return ret
