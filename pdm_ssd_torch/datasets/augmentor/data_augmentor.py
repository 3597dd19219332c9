"""Config-driven augmentation queue (host-side numpy): copy of the LiDAR
part of `pdm_ssd_tpu/datasets/augmentor/data_augmentor.py`.

gt_sampling and the world flip / rotation / scaling / translation, with
DISABLE_AUG_LIST, the `disable_augmentation` hook and the heading normalized
to [-pi, pi) at the end (reference `data_augmentor.py:290-317`). The world
flip, rotation and scaling also move a sample's offline proposals
('roi_boxes', (T, R, 9), Waymo's USE_PREDBOX path) with the ground truth,
as the JAX package's do (its `data_augmentor.py:53-115`). `imgaug` flips and
rotates BEVFusion's camera images (`image_ops`, PIL's operations without
PIL) and records both in each image's `img_process_infos`. The other
augmentations of the JAX package raise `NotImplementedError`, naming the
ROADMAP item of those a config of the repo uses.
"""
from __future__ import annotations

from functools import partial

import numpy as np

from .. import image_ops
from . import augmentor_utils
from .database_sampler import DataBaseSampler

# augmentations of the JAX package's queue that a config of the repo uses and
# the port does not have yet, with the ROADMAP item that brings each
_UNPORTED = {'random_image_flip': 'ROADMAP Queue 1 item 12, CaDDN'}
_PORTED = ('gt_sampling', 'random_world_flip', 'random_world_rotation',
           'random_world_scaling', 'random_world_translation', 'imgaug')


class DataAugmentor(object):
    def __init__(self, root_path, augmentor_configs, class_names, logger=None):
        self.root_path = root_path
        self.class_names = class_names
        self.logger = logger
        self.augmentor_configs = augmentor_configs
        self.aug_config_list = augmentor_configs if isinstance(augmentor_configs, list) \
            else augmentor_configs.AUG_CONFIG_LIST
        self.data_augmentor_queue = self._build_queue(augmentor_configs)

    def _build_queue(self, augmentor_configs):
        aug_config_list = augmentor_configs if isinstance(augmentor_configs, list) \
            else augmentor_configs.AUG_CONFIG_LIST
        queue = []
        for cur_cfg in aug_config_list:
            if not isinstance(augmentor_configs, list):
                if cur_cfg.NAME in augmentor_configs.DISABLE_AUG_LIST:
                    continue
            if cur_cfg.NAME not in _PORTED:
                why = _UNPORTED.get(cur_cfg.NAME, 'no config of the repo uses it')
                raise NotImplementedError(f'the augmentation {cur_cfg.NAME} is not ported ({why})')
            queue.append(getattr(self, cur_cfg.NAME)(config=cur_cfg))
        return queue

    def disable_augmentation(self, augmentor_configs):
        """Rebuild the queue without listed augs (`disable_augmentation_hook`)."""
        self.data_augmentor_queue = self._build_queue(augmentor_configs)

    def gt_sampling(self, config=None):
        return DataBaseSampler(root_path=self.root_path, sampler_cfg=config,
                               class_names=self.class_names, logger=self.logger)

    @staticmethod
    def _roi_boxes_flip(roi_boxes, axis):
        """An enabled world flip of the per-frame offline proposals (T, R, 9),
        in place; zero-padded slots stay zero except the y flip's heading,
        -pi there, as in the JAX package."""
        if axis == 'x':
            roi_boxes[..., 1] = -roi_boxes[..., 1]
            roi_boxes[..., 6] = -roi_boxes[..., 6]
            if roi_boxes.shape[-1] > 8:
                roi_boxes[..., 8] = -roi_boxes[..., 8]
        else:
            roi_boxes[..., 0] = -roi_boxes[..., 0]
            roi_boxes[..., 6] = -(roi_boxes[..., 6] + np.pi)
            if roi_boxes.shape[-1] > 7:
                roi_boxes[..., 7] = -roi_boxes[..., 7]
        return roi_boxes

    def random_world_flip(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_flip, config=config)
        gt_boxes, points = data_dict['gt_boxes'], data_dict['points']
        for cur_axis in config.ALONG_AXIS_LIST:
            assert cur_axis in ['x', 'y']
            gt_boxes, points, enable = getattr(
                augmentor_utils, f'random_flip_along_{cur_axis}')(gt_boxes, points)
            data_dict[f'flip_{cur_axis}'] = enable
            if enable and 'roi_boxes' in data_dict:
                data_dict['roi_boxes'] = self._roi_boxes_flip(data_dict['roi_boxes'], cur_axis)
        data_dict['gt_boxes'], data_dict['points'] = gt_boxes, points
        return data_dict

    def random_world_rotation(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_rotation, config=config)
        rot_range = config.WORLD_ROT_ANGLE
        if not isinstance(rot_range, (list, tuple)):
            rot_range = [-rot_range, rot_range]
        gt_boxes, points, noise_rot = augmentor_utils.global_rotation(
            data_dict['gt_boxes'], data_dict['points'], rot_range=rot_range)
        if 'roi_boxes' in data_dict:
            # centers, headings and velocities by the same angle
            rb = data_dict['roi_boxes']
            flat = rb.reshape(-1, rb.shape[-1]).copy()
            flat[:, 0:3] = augmentor_utils.rotate_points_along_z_np(flat[:, 0:3], noise_rot)
            flat[:, 6] += noise_rot
            if flat.shape[-1] > 7:
                vel = np.concatenate([flat[:, 7:9], np.zeros((len(flat), 1))], axis=1)
                flat[:, 7:9] = augmentor_utils.rotate_points_along_z_np(vel, noise_rot)[:, 0:2]
            data_dict['roi_boxes'] = flat.reshape(rb.shape)
        data_dict['gt_boxes'], data_dict['points'] = gt_boxes, points
        data_dict['noise_rot'] = noise_rot
        return data_dict

    def random_world_scaling(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_scaling, config=config)
        gt_boxes, points, noise_scale = augmentor_utils.global_scaling(
            data_dict['gt_boxes'], data_dict['points'], config.WORLD_SCALE_RANGE)
        if 'roi_boxes' in data_dict:
            # the geometry and velocity columns scale; the heading does not
            data_dict['roi_boxes'][..., [0, 1, 2, 3, 4, 5, 7, 8]] *= noise_scale
        data_dict['gt_boxes'], data_dict['points'] = gt_boxes, points
        data_dict['noise_scale'] = noise_scale
        return data_dict

    def random_world_translation(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.random_world_translation, config=config)
        gt_boxes, points, noise = augmentor_utils.global_translation(
            data_dict['gt_boxes'], data_dict['points'], config.NOISE_TRANSLATE_STD)
        data_dict['gt_boxes'], data_dict['points'] = gt_boxes, points
        data_dict['noise_translate'] = noise
        return data_dict

    def imgaug(self, data_dict=None, config=None):
        """Each camera image flipped left-right (a `np.random.choice([0, 1])`
        draw, with RAND_FLIP) and then rotated by a `np.random.uniform(*ROT_LIM)`
        draw of degrees, those draws in that order an image, as the JAX
        package's; both recorded in the image's `img_process_infos` entry
        ([resize, crop, flip, rotate]) for `image_calibrate`."""
        if data_dict is None:
            return partial(self.imgaug, config=config)
        new_imgs = []
        for img, info in zip(data_dict['camera_imgs'], data_dict['img_process_infos']):
            flip = bool(config.RAND_FLIP and np.random.choice([0, 1]))
            rotate = float(np.random.uniform(*config.ROT_LIM))
            if flip:
                img = image_ops.flip_left_right(img)
            img = image_ops.rotate(img, rotate)
            info[2] = flip
            info[3] = rotate
            new_imgs.append(img)
        data_dict['camera_imgs'] = new_imgs
        return data_dict

    def forward(self, data_dict):
        for cur_augmentor in self.data_augmentor_queue:
            data_dict = cur_augmentor(data_dict=data_dict)
        data_dict['gt_boxes'][:, 6] = self._limit_heading(data_dict['gt_boxes'][:, 6])
        return data_dict

    @staticmethod
    def _limit_heading(val, offset=0.5, period=2 * np.pi):
        return val - np.floor(val / period + offset) * period
