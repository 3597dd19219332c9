"""Config-driven host-side data processing queue (copy of the point and voxel
steps of `pdm_ssd_tpu/datasets/processor/data_processor.py:41-129`).

Each config entry resolves to a `_build_<NAME>` factory returning a bound
step closure. The steps of the KITTI pipelines are here: range masking,
shuffling, the near/far-aware fixed-N point sampler, which gives point
models their static shapes, the grid of the point models that pillarize on
the device, and the voxelizer of the voxel models
(`ops/voxelize.voxelize` on a CPU tensor: the contract of the JAX package's
`_numpy_voxelize`, without its Python loop over cells); and BEVFusion's
camera steps (`data_processor.py:175-256` there): the images normalized,
each image's recorded resize, crop, flip and rotation folded into its
'img_aug_matrix', and the sparse LiDAR depth map of each camera; and
CaDDN's depth maps (`data_processor.py:131-173` there): the points projected
through the KITTI calibration, the nearest depth kept at each pixel, then
the block mean over a zero-padded map down to the image features' size.
"""
from __future__ import annotations

import numpy as np
import torch

from ...ops.voxelize import voxelize
from ...utils import box_utils_np

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

    def _build_generate_depth_map(self, cfg):
        """'depth_maps' (H, W) float32 of a KITTI sample's points
        (`lidar_depth_map`), at MAP_SHAPE (H, W), or without it at the
        sample's 'image_shape'. KITTI sets 'image_shape' only after the data
        path has run, so a config without MAP_SHAPE raises `KeyError` there,
        as in the JAX package (ROADMAP Queue 3)."""
        shape = cfg.get('MAP_SHAPE', None)

        def step(dd):
            calib, pts = dd.get('calib'), dd.get('points')
            if calib is None or pts is None:
                return dd
            H, W = shape if shape is not None else dd['image_shape']
            dd['depth_maps'] = lidar_depth_map(pts, calib, int(H), int(W))
            return dd
        return step

    def _build_downsample_depth_map(self, cfg):
        """'depth_maps' down by DOWNSAMPLE_FACTOR (`block_mean`)."""
        f = int(cfg.DOWNSAMPLE_FACTOR)
        self.depth_downsample_factor = f

        def step(dd):
            if dd.get('depth_maps') is not None:
                dd['depth_maps'] = block_mean(dd['depth_maps'], f)
            return dd
        return step

    def _build_image_normalize(self, cfg):
        """Camera images (uint8 (H, W, 3) each) -> (N_cam, H, W, 3) float32,
        (x / 255 - mean) / std."""
        mean = np.asarray(cfg.mean, np.float32)
        std = np.asarray(cfg.std, np.float32)

        def step(dd):
            imgs = dd.get('camera_imgs')
            if imgs is None:
                return dd
            arrs = [(np.asarray(im, np.float32) / 255.0 - mean) / std for im in imgs]
            dd['camera_imgs'] = np.stack(arrs).astype(np.float32)
            return dd
        return step

    def _build_image_calibrate(self, cfg):
        """Each image's [resize, crop, flip, rotate] (`img_process_infos`) as a
        4x4 'img_aug_matrix' mapping original pixels to augmented ones."""
        def step(dd):
            infos = dd.get('img_process_infos')
            if infos is None:
                return dd
            transforms = []
            for resize, crop, flip, rotate in infos:
                rot = np.eye(2) * resize
                tra = -np.asarray(crop[:2], np.float64)
                if flip:
                    A = np.array([[-1.0, 0.0], [0.0, 1.0]])
                    b = np.array([crop[2] - crop[0], 0.0])
                    rot = A @ rot
                    tra = A @ tra + b
                theta = rotate / 180.0 * np.pi
                A = np.array([[np.cos(theta), np.sin(theta)],
                              [-np.sin(theta), np.cos(theta)]])
                b = np.array([crop[2] - crop[0], crop[3] - crop[1]]) / 2.0
                b = A @ (-b) + b
                rot = A @ rot
                tra = A @ tra + b
                tf = np.eye(4, dtype=np.float32)
                tf[:2, :2] = rot
                tf[:2, 3] = tra
                transforms.append(tf)
            dd['img_aug_matrix'] = np.stack(transforms)
            return dd
        return step

    def _build_generate_camera_depth(self, cfg):
        """'camera_depth' (N_cam, iH, iW, 1): the points moved back through
        the inverse of the world augmentation ('lidar_aug_matrix'), projected
        by each camera's 'lidar2image' and its 'img_aug_matrix'; each pixel
        hit keeps the depth of the last point written there."""
        iH, iW = (int(v) for v in cfg.IMAGE_DIM)

        def step(dd):
            if 'lidar2image' not in dd:
                return dd
            dd['camera_depth'] = camera_depth_map(
                dd['points'], dd['lidar2image'], dd.get('img_aug_matrix'),
                dd.get('lidar_aug_matrix'), iH, iW)
            return dd
        return step


def lidar_depth_map(points: np.ndarray, calib, H: int, W: int) -> np.ndarray:
    """(H, W) float32 depth map of a cloud (N, >= 3) seen through a KITTI
    `Calibration`: each point in front of the camera projects to the pixel
    it floors into, and the nearest depth wins (the points sorted by
    descending depth, stable, the last write kept); 0 where no point falls."""
    uv, depth = calib.rect_to_img(calib.lidar_to_rect(points[:, :3]))
    u = np.floor(uv[:, 0]).astype(np.int64)
    v = np.floor(uv[:, 1]).astype(np.int64)
    ok = (depth > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    dm = np.full((H * W,), 0.0, np.float32)
    flat = v[ok] * W + u[ok]
    order = np.argsort(-depth[ok], kind='stable')
    dm[flat[order]] = depth[ok][order]
    return dm.reshape(H, W)


def block_mean(dm: np.ndarray, f: int) -> np.ndarray:
    """The mean of each f x f block of a (H, W) map zero-padded at its far
    edges to multiples of f: (ceil(H / f), ceil(W / f))."""
    H, W = dm.shape
    Hp, Wp = (H + f - 1) // f * f, (W + f - 1) // f * f
    pad = np.zeros((Hp, Wp), dm.dtype)
    pad[:H, :W] = dm
    return pad.reshape(Hp // f, f, Wp // f, f).mean((1, 3))


def camera_depth_map(points: np.ndarray, lidar2image: np.ndarray, img_aug=None, lidar_aug=None,
                     iH: int = 256, iW: int = 704) -> np.ndarray:
    """(N_cam, iH, iW, 1) float32 sparse depth maps of one cloud (N, >= 3):
    the points moved back through the inverse of `lidar_aug` (4x4, or none),
    projected by each camera's `lidar2image` (N_cam, 4, 4) and `img_aug`
    (N_cam, 4, 4, or none); each pixel hit keeps the depth of the last point
    written there (numpy's fancy assignment)."""
    pts = points[:, :3].astype(np.float64)
    la = np.eye(4) if lidar_aug is None else lidar_aug
    pts = (pts - la[:3, 3]) @ np.linalg.inv(la[:3, :3]).T
    aug = np.broadcast_to(np.eye(4), lidar2image.shape) if img_aug is None else img_aug
    n_cam = lidar2image.shape[0]
    depth = np.zeros((n_cam, iH, iW, 1), np.float32)
    hom = np.concatenate([pts, np.ones((len(pts), 1))], -1)
    for c in range(n_cam):
        uvw = hom @ lidar2image[c].T                      # (N, 4)
        dist = uvw[:, 2]
        w = np.clip(uvw[:, 2], 1e-5, 1e5)
        coords = np.stack([uvw[:, 0] / w, uvw[:, 1] / w, np.ones_like(w)], -1)
        coords = coords @ aug[c][:3, :3].T + aug[c][:3, 3]
        u, v = coords[:, 0], coords[:, 1]
        on = (u >= 0) & (u < iW) & (v >= 0) & (v < iH) & (dist > 0)
        depth[c, v[on].astype(int), u[on].astype(int), 0] = dist[on]
    return depth
