"""KITTI camera<->lidar box conversions and point-in-box tests (host numpy;
copy of `pdm_ssd_tpu/datasets/kitti/kitti_utils.py`). `points_in_boxes_cpu`
is the numpy test only: the JAX package first tries a native library.
"""
from __future__ import annotations

import numpy as np


def boxes3d_kitti_camera_to_lidar(boxes3d_camera, calib):
    """(N, 7) [x, y, z, l, h, w, ry] camera -> (N, 7) [x, y, z, dx(l), dy(w), dz(h), heading] lidar."""
    xyz_camera = boxes3d_camera[:, 0:3]
    l, h, w = boxes3d_camera[:, 3:4], boxes3d_camera[:, 4:5], boxes3d_camera[:, 5:6]
    r = boxes3d_camera[:, 6:7]
    xyz_lidar = calib.rect_to_lidar(xyz_camera)
    xyz_lidar[:, 2] += h[:, 0] / 2
    return np.concatenate([xyz_lidar, l, w, h, -(np.pi / 2 + r)], axis=-1)


def boxes3d_lidar_to_kitti_camera(boxes3d_lidar, calib):
    """(N, 7) lidar [x,y,z,dx,dy,dz,heading] -> (N, 7) camera [x,y,z,l,h,w,ry]."""
    xyz_lidar = boxes3d_lidar[:, 0:3].copy()
    l, w, h = boxes3d_lidar[:, 3:4], boxes3d_lidar[:, 4:5], boxes3d_lidar[:, 5:6]
    r = boxes3d_lidar[:, 6:7]
    xyz_lidar[:, 2] -= h.reshape(-1) / 2
    xyz_cam = calib.lidar_to_rect(xyz_lidar)
    r_cam = -r - np.pi / 2
    return np.concatenate([xyz_cam, l, h, w, r_cam], axis=-1)


def boxes3d_to_corners3d_kitti_camera(boxes3d, bottom_center=True):
    """(N, 7) camera boxes -> (N, 8, 3) corners (camera frame)."""
    boxes_num = boxes3d.shape[0]
    l, h, w = boxes3d[:, 3], boxes3d[:, 4], boxes3d[:, 5]
    x_corners = np.array([l / 2., l / 2., -l / 2., -l / 2.,
                          l / 2., l / 2., -l / 2., -l / 2.], dtype=np.float32).T
    z_corners = np.array([w / 2., -w / 2., -w / 2., w / 2.,
                          w / 2., -w / 2., -w / 2., w / 2.], dtype=np.float32).T
    if bottom_center:
        y_corners = np.zeros((boxes_num, 8), dtype=np.float32)
        y_corners[:, 4:8] = -h.reshape(boxes_num, 1).repeat(4, axis=1)
    else:
        y_corners = np.array([h / 2., h / 2., h / 2., h / 2.,
                              -h / 2., -h / 2., -h / 2., -h / 2.], dtype=np.float32).T

    ry = boxes3d[:, 6]
    zeros, ones = np.zeros(ry.size, dtype=np.float32), np.ones(ry.size, dtype=np.float32)
    rot_list = np.array([[np.cos(ry), zeros, -np.sin(ry)],
                         [zeros, ones, zeros],
                         [np.sin(ry), zeros, np.cos(ry)]])
    R_list = np.transpose(rot_list, (2, 0, 1))

    temp_corners = np.concatenate((x_corners.reshape(-1, 8, 1),
                                   y_corners.reshape(-1, 8, 1),
                                   z_corners.reshape(-1, 8, 1)), axis=2)
    rotated_corners = np.matmul(temp_corners, R_list)
    x_loc, y_loc, z_loc = boxes3d[:, 0], boxes3d[:, 1], boxes3d[:, 2]
    x = x_loc.reshape(-1, 1) + rotated_corners[:, :, 0]
    y = y_loc.reshape(-1, 1) + rotated_corners[:, :, 1]
    z = z_loc.reshape(-1, 1) + rotated_corners[:, :, 2]
    return np.concatenate((x.reshape(-1, 8, 1), y.reshape(-1, 8, 1),
                           z.reshape(-1, 8, 1)), axis=2).astype(np.float32)


def boxes3d_kitti_camera_to_imageboxes(boxes3d, calib, image_shape=None):
    """(N, 7) camera boxes -> (N, 4) [x1, y1, x2, y2] image boxes."""
    corners3d = boxes3d_to_corners3d_kitti_camera(boxes3d)
    pts_img, _ = calib.corners3d_to_img_boxes(corners3d)
    if image_shape is not None:
        pts_img[:, 0] = np.clip(pts_img[:, 0], a_min=0, a_max=image_shape[1] - 1)
        pts_img[:, 1] = np.clip(pts_img[:, 1], a_min=0, a_max=image_shape[0] - 1)
        pts_img[:, 2] = np.clip(pts_img[:, 2], a_min=0, a_max=image_shape[1] - 1)
        pts_img[:, 3] = np.clip(pts_img[:, 3], a_min=0, a_max=image_shape[0] - 1)
    return pts_img


def points_in_boxes_cpu(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(npoints, 3), (nboxes, 7) -> (nboxes, npoints) 0/1 mask (rotated test,
    center-z convention; mirrors `points_in_boxes_cpu`)."""
    if len(boxes) == 0 or len(points) == 0:
        return np.zeros((len(boxes), len(points)), np.int32)
    shift = points[None, :, 0:3] - boxes[:, None, 0:3]
    cosa, sina = np.cos(-boxes[:, 6]), np.sin(-boxes[:, 6])
    lx = shift[..., 0] * cosa[:, None] - shift[..., 1] * sina[:, None]
    ly = shift[..., 0] * sina[:, None] + shift[..., 1] * cosa[:, None]
    inside = ((np.abs(shift[..., 2]) <= boxes[:, None, 5] / 2)
              & (np.abs(lx) < boxes[:, None, 3] / 2 + 1e-5)
              & (np.abs(ly) < boxes[:, None, 4] / 2 + 1e-5))
    return inside.astype(np.int32)
