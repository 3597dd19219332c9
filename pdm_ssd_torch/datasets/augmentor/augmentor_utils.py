"""Global geometry augmentations (host-side numpy): copy of the world
flip / rotation / scaling / translation of
`pdm_ssd_tpu/datasets/augmentor/augmentor_utils.py`, and CaDDN's image flip.
Each returns the applied noise parameters (used for the accumulated lidar
aug matrix).

The draws use the global `np.random`, as there, so one seed gives both
packages the same sample. The per-object, frustum and pyramid augmentations
are not copied: no KITTI config of the repo uses them.
"""
from __future__ import annotations

import numpy as np


def rotate_points_along_z_np(points: np.ndarray, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], points.dtype)
    out = points.copy()
    out[:, 0:3] = points[:, 0:3] @ rot
    return out


def random_flip_along_x(gt_boxes, points, enable_prob=0.5):
    """Flip across the x axis (y -> -y). (`augmentor_utils.py:random_flip_along_x`.)"""
    enable = np.random.choice([False, True], p=[1 - enable_prob, enable_prob])
    if enable:
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6]
        points[:, 1] = -points[:, 1]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 8] = -gt_boxes[:, 8]
    return gt_boxes, points, enable


def random_flip_along_y(gt_boxes, points, enable_prob=0.5):
    enable = np.random.choice([False, True], p=[1 - enable_prob, enable_prob])
    if enable:
        gt_boxes[:, 0] = -gt_boxes[:, 0]
        gt_boxes[:, 6] = -(gt_boxes[:, 6] + np.pi)
        points[:, 0] = -points[:, 0]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 7] = -gt_boxes[:, 7]
    return gt_boxes, points, enable


def global_rotation(gt_boxes, points, rot_range):
    noise_rotation = np.random.uniform(rot_range[0], rot_range[1])
    points = rotate_points_along_z_np(points, noise_rotation)
    gt_boxes[:, 0:3] = rotate_points_along_z_np(gt_boxes[:, 0:3], noise_rotation)
    gt_boxes[:, 6] += noise_rotation
    if gt_boxes.shape[1] > 7:
        vel = np.concatenate([gt_boxes[:, 7:9], np.zeros((len(gt_boxes), 1))], axis=1)
        gt_boxes[:, 7:9] = rotate_points_along_z_np(vel, noise_rotation)[:, 0:2]
    return gt_boxes, points, noise_rotation


def global_scaling(gt_boxes, points, scale_range):
    if scale_range[1] - scale_range[0] < 1e-3:
        return gt_boxes, points, 1.0
    noise_scale = np.random.uniform(scale_range[0], scale_range[1])
    points[:, :3] *= noise_scale
    gt_boxes[:, :6] *= noise_scale
    if gt_boxes.shape[1] > 7:
        gt_boxes[:, 7:9] *= noise_scale
    return gt_boxes, points, noise_scale


def global_translation(gt_boxes, points, noise_translate_std):
    if not isinstance(noise_translate_std, (list, tuple, np.ndarray)):
        noise_translate_std = np.array(
            [noise_translate_std, noise_translate_std, noise_translate_std])
    noise = np.array([
        np.random.normal(0, noise_translate_std[0]),
        np.random.normal(0, noise_translate_std[1]),
        np.random.normal(0, noise_translate_std[2]),
    ], points.dtype)
    points[:, :3] += noise
    gt_boxes[:, :3] += noise
    return gt_boxes, points, noise


def random_image_flip_horizontal(image, depth_map, gt_boxes, calib):
    """With probability 0.5 (one `np.random.choice([False, True])` draw),
    the image (H, W, 3) and the depth map, where there is one, flipped left
    to right, and each 3D box's centre mirrored through the image: projected
    by `calib`, u -> W - u, back-projected at the same depth; its heading
    negated. The points are not moved. Returns (image, depth map, boxes,
    enabled)."""
    enable = np.random.choice([False, True], p=[0.5, 0.5])
    if not enable:
        return image, depth_map, gt_boxes, enable
    aug_image = np.fliplr(image)
    aug_depth_map = np.fliplr(depth_map) if depth_map is not None else None
    aug_gt_boxes = gt_boxes.copy()
    if len(aug_gt_boxes):
        img_pts, img_depth = calib.lidar_to_img(aug_gt_boxes[:, :3])
        img_pts[:, 0] = image.shape[1] - img_pts[:, 0]
        pts_rect = calib.img_to_rect(u=img_pts[:, 0], v=img_pts[:, 1], depth_rect=img_depth)
        aug_gt_boxes[:, :3] = calib.rect_to_lidar(pts_rect)
        aug_gt_boxes[:, 6] = -1 * aug_gt_boxes[:, 6]
    return aug_image, aug_depth_map, aug_gt_boxes, enable
