"""Config-driven host-side data processing queue (copy of the point and voxel
steps of `pdm_ssd_tpu/datasets/processor/data_processor.py:41-129`).

Each config entry resolves to a `_build_<NAME>` factory returning a bound
step closure. The steps of the KITTI pipelines are here: range masking,
shuffling, the near/far-aware fixed-N point sampler, which gives point
models their static shapes, the grid of the point models that pillarize on
the device, and the voxelizer of the voxel models
(`ops/voxelize.voxelize` on a CPU tensor: the contract of the JAX package's
`_numpy_voxelize`, without its Python loop over cells). Every other step
raises `NotImplementedError` naming its ROADMAP item.
"""
from __future__ import annotations

import numpy as np
import torch

from ...ops.voxelize import voxelize
from ...utils import box_utils_np

# steps of the JAX package's queue that the port does not have, with the
# ROADMAP item that brings each
_UNPORTED = {
    'generate_depth_map': 'Queue 1 item 12, camera and temporal models',
    'downsample_depth_map': 'Queue 1 item 12, camera and temporal models',
    'image_normalize': 'Queue 1 item 12, camera and temporal models',
    'image_calibrate': 'Queue 1 item 12, camera and temporal models',
    'generate_camera_depth': 'Queue 1 item 12, camera and temporal models',
}


class DataProcessor:
    def __init__(self, processor_configs, point_cloud_range, training,
                 num_point_features):
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)
        self.training = training
        self.num_point_features = num_point_features
        self.mode = 'train' if training else 'test'
        self.grid_size = None
        self.voxel_size = None
        self.steps = [self._build(cfg) for cfg in processor_configs]

    def _build(self, cfg):
        if cfg.NAME in _UNPORTED:
            raise NotImplementedError(f'the data processor step {cfg.NAME} is not ported yet '
                                      f'(ROADMAP {_UNPORTED[cfg.NAME]})')
        return getattr(self, f'_build_{cfg.NAME}')(cfg)

    def _set_grid(self, voxel_size):
        extent = self.point_cloud_range[3:6] - self.point_cloud_range[0:3]
        self.voxel_size = voxel_size
        self.grid_size = np.round(extent / np.asarray(voxel_size)).astype(np.int64)

    def forward(self, data_dict: dict) -> dict:
        for step in self.steps:
            data_dict = step(data_dict)
        return data_dict

    # ---- step factories (names are the config NAME keys) ----

    def _build_mask_points_and_boxes_outside_range(self, cfg):
        filter_boxes = cfg.REMOVE_OUTSIDE_BOXES and self.training
        min_corners = cfg.get('min_num_corners', 1)
        center_filter = cfg.get('USE_CENTER_TO_FILTER', True)

        def step(dd):
            pts = dd.get('points')
            if pts is not None:
                dd['points'] = pts[box_utils_np.mask_points_by_range(
                    pts, self.point_cloud_range)]
            if filter_boxes and dd.get('gt_boxes') is not None:
                keep = box_utils_np.mask_boxes_outside_range_numpy(
                    dd['gt_boxes'], self.point_cloud_range,
                    min_num_corners=min_corners,
                    use_center_to_filter=center_filter)
                dd['gt_boxes'] = dd['gt_boxes'][keep]
                if 'gt_names' in dd:
                    dd['gt_names'] = dd['gt_names'][keep]
            return dd
        return step

    def _build_shuffle_points(self, cfg):
        enabled = cfg.SHUFFLE_ENABLED[self.mode]

        def step(dd):
            if enabled:
                dd['points'] = dd['points'][
                    np.random.permutation(len(dd['points']))]
            return dd
        return step

    def _build_sample_points(self, cfg):
        """Fixed-N sampler. Over budget: keep all far (>=40 m) points, fill
        with random near points; under budget: pad with random duplicates;
        always reshuffle (reference `sample_points` semantics)."""
        n_want = cfg.NUM_POINTS[self.mode]

        def step(dd):
            if n_want == -1:
                return dd
            points = dd['points']
            n_have = len(points)
            if n_have == 0:
                # an aggressive aug (e.g. a flip on a forward-only range)
                # can empty the cloud; emit all-zero padding as the JAX
                # package does (ROADMAP Queue 3: the zero rows form a phantom
                # cluster at the origin)
                dd['points'] = np.zeros((n_want, points.shape[1]),
                                        points.dtype)
                return dd
            if n_want >= n_have:
                n_pad = n_want - n_have
                pad = np.random.choice(n_have, n_pad, replace=n_pad > n_have)
                keep = np.concatenate([np.arange(n_have), pad])
            else:
                is_far = np.linalg.norm(points[:, :3], axis=1) >= 40.0
                far = np.flatnonzero(is_far)
                if len(far) < n_want:
                    near = np.flatnonzero(~is_far)
                    fill = np.random.choice(near, n_want - len(far),
                                            replace=False)
                    keep = np.concatenate([far, fill])
                else:
                    keep = np.random.choice(n_have, n_want, replace=False)
            np.random.shuffle(keep)
            dd['points'] = points[keep]
            return dd
        return step

    def _build_calculate_grid_size(self, cfg):
        """Sets the grid and changes no sample (the point models that
        pillarize on the device read the grid from the config)."""
        self._set_grid(cfg.VOXEL_SIZE)
        return lambda dd: dd

    def _build_transform_points_to_voxels(self, cfg):
        """The first MAX_POINTS_PER_VOXEL points of each occupied cell, the
        first MAX_NUMBER_OF_VOXELS cells in key order, zyx coords: 'voxels'
        (V, P, C) float32, 'voxel_coords' (V, 3) int32 and 'voxel_num_points'
        (V,) int32 for the V cells filled (the collate pads them to the cap)."""
        self._set_grid(cfg.VOXEL_SIZE)
        self.max_num_voxels = cfg.MAX_NUMBER_OF_VOXELS[self.mode]
        max_voxels = self.max_num_voxels
        max_pts = cfg.MAX_POINTS_PER_VOXEL
        pc_range = self.point_cloud_range.tolist()
        vs = np.asarray(cfg.VOXEL_SIZE, np.float32).tolist()

        def step(dd):
            pts = torch.from_numpy(np.ascontiguousarray(dd['points'], np.float32))
            voxels, coords, num, n = voxelize(pts, pc_range, vs, max_pts, max_voxels)
            dd['voxels'] = voxels[:n].numpy()
            dd['voxel_coords'] = coords[:n].numpy()
            dd['voxel_num_points'] = num[:n].numpy()
            return dd
        return step
