"""Geometry augmentations (host-side numpy): copy of
`pdm_ssd_tpu/datasets/augmentor/augmentor_utils.py`. The world flip /
rotation / scaling / translation return the applied noise parameters (used
for the accumulated lidar aug matrix); then the per-object translation,
rotation and scaling, the world and per-object frustum dropouts, SE-SSD's
pyramid dropout, sparsify and swap, and CaDDN's image flip.

The draws use the global `np.random`, as there, so one seed gives both
packages the same sample.
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


# ---- local (per-object) augmentations ---------------------------------------
# Copies of the JAX package's (the reference's `augmentor_utils.py:153-467`):
# one vectorized pass computes every point's owning box (first match), then
# all per-object noises apply in one gather and arithmetic sweep. Each draws
# from `np.random` in the JAX package's order.

_MARGIN = 1e-1


def points_box_assignment(points: np.ndarray, gt_boxes: np.ndarray):
    """(M, 3+C) x (N, 7) -> owner (M,) int (first matching box, -1 outside),
    plus the per-point local (box-frame) coordinates for owned points.
    Membership test matches `get_points_in_box` (z-extent exact, xy + margin).
    """
    if len(gt_boxes) == 0:
        return np.full(len(points), -1, np.int64), None
    shift = points[:, None, 0:3] - gt_boxes[None, :, 0:3]          # (M, N, 3)
    c, s = np.cos(-gt_boxes[:, 6]), np.sin(-gt_boxes[:, 6])
    lx = shift[..., 0] * c + shift[..., 1] * (-s)
    ly = shift[..., 0] * s + shift[..., 1] * c
    inside = ((np.abs(shift[..., 2]) <= gt_boxes[None, :, 5] / 2.0)
              & (np.abs(lx) <= gt_boxes[None, :, 3] / 2.0 + _MARGIN)
              & (np.abs(ly) <= gt_boxes[None, :, 4] / 2.0 + _MARGIN))
    any_in = inside.any(1)
    owner = np.where(any_in, inside.argmax(1), -1)
    return owner, (lx, ly, shift[..., 2])


def local_translation(gt_boxes, points, offset_range, axes=(0, 1, 2)):
    """Per-object random translation along the chosen axes
    (`random_local_translation_along_{x,y,z}`, reference :153-218)."""
    owner, _ = points_box_assignment(points, gt_boxes)
    offsets = np.zeros((len(gt_boxes) + 1, 3), points.dtype)
    for ax in axes:
        offsets[:-1, ax] = np.random.uniform(offset_range[0], offset_range[1],
                                             len(gt_boxes))
    points[:, 0:3] += offsets[owner]
    gt_boxes[:, 0:3] += offsets[:-1]
    return gt_boxes, points


def local_rotation(gt_boxes, points, rot_range):
    """Per-object rotation about each box center (reference :321-367)."""
    owner, _ = points_box_assignment(points, gt_boxes)
    angles = np.random.uniform(rot_range[0], rot_range[1], len(gt_boxes))
    ang_p = np.concatenate([angles, [0.0]])[owner]
    owned = owner >= 0
    ctr = np.concatenate([gt_boxes[:, 0:3], np.zeros((1, 3), gt_boxes.dtype)])[owner]
    rel = points[:, 0:3] - ctr
    c, s = np.cos(ang_p), np.sin(ang_p)
    rx = rel[:, 0] * c - rel[:, 1] * s
    ry = rel[:, 0] * s + rel[:, 1] * c
    points[owned, 0] = (rx + ctr[:, 0])[owned]
    points[owned, 1] = (ry + ctr[:, 1])[owned]
    gt_boxes[:, 6] += angles
    if gt_boxes.shape[1] > 8:
        c, s = np.cos(angles), np.sin(angles)
        vx = gt_boxes[:, 7] * c - gt_boxes[:, 8] * s
        vy = gt_boxes[:, 7] * s + gt_boxes[:, 8] * c
        gt_boxes[:, 7], gt_boxes[:, 8] = vx, vy
    return gt_boxes, points


def local_scaling(gt_boxes, points, scale_range):
    """Per-object scaling about each box center (reference :287-318)."""
    if scale_range[1] - scale_range[0] < 1e-3:
        return gt_boxes, points
    owner, _ = points_box_assignment(points, gt_boxes)
    scales = np.random.uniform(scale_range[0], scale_range[1], len(gt_boxes))
    sc_p = np.concatenate([scales, [1.0]])[owner]
    ctr = np.concatenate([gt_boxes[:, 0:3], np.zeros((1, 3), gt_boxes.dtype)])[owner]
    points[:, 0:3] = (points[:, 0:3] - ctr) * sc_p[:, None] + ctr
    gt_boxes[:, 3:6] *= scales[:, None]
    return gt_boxes, points


def global_frustum_dropout(gt_boxes, points, intensity_range, direction):
    """Drop everything beyond a scene-level fraction along one direction
    (`global_frustum_dropout_{top,bottom,left,right}`, reference :219-286)."""
    axis, sign = {'top': (2, +1), 'bottom': (2, -1),
                  'left': (1, +1), 'right': (1, -1)}[direction]
    intensity = np.random.uniform(intensity_range[0], intensity_range[1])
    lo, hi = np.min(points[:, axis]), np.max(points[:, axis])
    if sign > 0:
        thr = hi - intensity * (hi - lo)
        pmask, bmask = points[:, axis] < thr, gt_boxes[:, axis] < thr
    else:
        thr = lo + intensity * (hi - lo)
        pmask, bmask = points[:, axis] > thr, gt_boxes[:, axis] > thr
    return gt_boxes[bmask], points[pmask]


def local_frustum_dropout(gt_boxes, points, intensity_range, direction):
    """Per-object slab dropout (`local_frustum_dropout_*`, reference :369-447):
    drops the in-box points beyond a per-object threshold along one axis."""
    owner, _ = points_box_assignment(points, gt_boxes)
    N = len(gt_boxes)
    if N == 0:
        return gt_boxes, points
    intensity = np.random.uniform(intensity_range[0], intensity_range[1], N)
    spec = {'top': (2, 5, +1), 'bottom': (2, 5, -1),
            'left': (1, 4, +1), 'right': (1, 4, -1)}[direction]
    ax, dax, sign = spec
    if sign > 0:
        thr = (gt_boxes[:, ax] + gt_boxes[:, dax] / 2) - intensity * gt_boxes[:, dax]
        drop_own = points[:, ax] >= np.concatenate([thr, [np.inf]])[owner]
    else:
        thr = (gt_boxes[:, ax] - gt_boxes[:, dax] / 2) + intensity * gt_boxes[:, dax]
        drop_own = points[:, ax] <= np.concatenate([thr, [-np.inf]])[owner]
    keep = ~((owner >= 0) & drop_own)
    return gt_boxes, points[keep]


# ---- SE-SSD pyramid augmentations (reference :469-657) ----------------------

_PYRAMID_ORDERS = np.array([
    [0, 1, 5, 4], [4, 5, 6, 7], [7, 6, 2, 3],
    [3, 2, 1, 0], [1, 2, 6, 5], [0, 4, 7, 3],
])


def _boxes_to_corners_3d_np(boxes):
    corners_norm = np.array([
        [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
        [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]], np.float32) / 2.0
    corners = corners_norm[None] * boxes[:, None, 3:6]
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    x = corners[..., 0] * c[:, None] - corners[..., 1] * s[:, None]
    y = corners[..., 0] * s[:, None] + corners[..., 1] * c[:, None]
    out = np.stack([x, y, corners[..., 2]], -1) + boxes[:, None, 0:3]
    return out


def get_pyramids(boxes):
    """(N, 7) -> (N, 6, 5, 3): apex (box center) + the 4 corners of each face
    (reference `get_pyramids:469-492`)."""
    corners = _boxes_to_corners_3d_np(boxes)          # (N, 8, 3)
    faces = corners[:, _PYRAMID_ORDERS]               # (N, 6, 4, 3)
    apex = np.broadcast_to(boxes[:, None, None, 0:3], (len(boxes), 6, 1, 3))
    return np.concatenate([apex, faces], axis=2)      # (N, 6, 5, 3)


def points_in_pyramids_mask(points, pyramids):
    """(M, 3+C) x (P, 5, 3) -> (M, P) bool membership in each square pyramid.
    Half-space test against the 5 faces (apex-to-edge sides + base), replacing
    the reference's scipy Delaunay `in_hull` per pyramid."""
    P = pyramids.shape[0]
    M = len(points)
    if P == 0:
        return np.zeros((M, 0), bool)
    flags = np.ones((M, P), bool)
    apex = pyramids[:, 0]
    base = pyramids[:, 1:5]                            # (P, 4, 3)
    centroid = pyramids.mean(1)                        # (P, 3)
    # 4 side faces (apex, base_i, base_{i+1}) + the base face
    tris = [(apex, base[:, i], base[:, (i + 1) % 4]) for i in range(4)]
    tris.append((base[:, 0], base[:, 1], base[:, 2]))
    pts = points[:, None, 0:3]
    for (a, b, c) in tris:
        n = np.cross(b - a, c - a)                     # (P, 3)
        # orient inward (towards centroid)
        sgn = np.sign(np.einsum('pc,pc->p', centroid - a, n))
        sgn = np.where(sgn == 0, 1.0, sgn)
        n = n * sgn[:, None]
        d = np.einsum('mpc,pc->mp', pts - a[None], n)
        flags &= d >= -1e-6
    return flags


def local_pyramid_dropout(gt_boxes, points, dropout_prob, pyramids=None):
    """Drop all points inside one random face-pyramid per selected box
    (reference :510-524)."""
    if pyramids is None:
        pyramids = get_pyramids(gt_boxes)
    if len(gt_boxes) == 0:
        return gt_boxes, points, pyramids
    which = np.random.randint(0, 6, len(pyramids))
    drop_box = np.random.uniform(0, 1, len(pyramids)) <= dropout_prob
    if drop_box.any():
        drops = pyramids[drop_box, which[drop_box]]    # (D, 5, 3)
        masks = points_in_pyramids_mask(points, drops)
        points = points[~masks.any(-1)]
    return gt_boxes, points, pyramids


def local_pyramid_sparsify(gt_boxes, points, prob, max_num_pts, pyramids=None):
    """Randomly subsample the points of one pyramid per selected box down to
    `max_num_pts` (reference :526-557)."""
    if pyramids is None:
        pyramids = get_pyramids(gt_boxes)
    if len(gt_boxes) == 0:
        return gt_boxes, points, pyramids
    which = np.random.randint(0, 6, len(pyramids))
    sel_box = np.random.uniform(0, 1, len(pyramids)) <= prob
    if sel_box.any():
        pyrs = pyramids[sel_box, which[sel_box]]
        masks = points_in_pyramids_mask(points, pyrs)   # (M, S)
        keep = np.ones(len(points), bool)
        for i in range(masks.shape[1]):
            idx = np.flatnonzero(masks[:, i])
            if len(idx) > max_num_pts:
                dropped = np.random.choice(idx, len(idx) - max_num_pts,
                                           replace=False)
                keep[dropped] = False
        points = points[keep]
    return gt_boxes, points, pyramids


def local_pyramid_swap(gt_boxes, points, prob, max_num_pts, pyramids=None):
    """Swap the surface points of matching pyramids between two boxes
    (reference :560-657): points are re-expressed in the source pyramid's
    (u, v, depth-ratio) frame and mapped to the target pyramid."""
    if pyramids is None:
        pyramids = get_pyramids(gt_boxes)
    N = len(gt_boxes)
    if N < 2:
        return gt_boxes, points
    which = np.random.randint(0, 6, N)
    sel = np.random.uniform(0, 1, N) <= prob
    idxs = np.flatnonzero(sel)
    if len(idxs) == 0:
        return gt_boxes, points
    keep = np.ones(len(points), bool)
    new_parts = []
    for i in idxs:
        # partner with the same face id from another box
        partners = [j for j in range(N) if j != i]
        j = np.random.choice(partners)
        face = which[i]
        pyr_i, pyr_j = pyramids[i, face], pyramids[j, face]
        m_i = points_in_pyramids_mask(points, pyr_i[None])[:, 0]
        m_j = points_in_pyramids_mask(points, pyr_j[None])[:, 0]
        if m_j.sum() == 0:
            continue
        # replace pyramid-i points with pyramid-j points mapped into frame i
        keep &= ~m_i
        src = points[m_j][:max_num_pts]
        mapped = _map_pyramid_points(src, pyr_j, pyr_i)
        new_parts.append(mapped)
    points = points[keep]
    if new_parts:
        points = np.concatenate([points] + new_parts, axis=0)
    return gt_boxes, points


def _map_pyramid_points(pts, src_pyr, dst_pyr):
    """Map points between pyramids via barycentric-ish (u, v, depth) coords:
    u, v locate the projection on the base quad (bilinear), depth is the
    fractional distance apex->base."""
    apex_s, base_s = src_pyr[0], src_pyr[1:5]
    apex_d, base_d = dst_pyr[0], dst_pyr[1:5]
    out = pts.copy()
    p = pts[:, 0:3]
    # depth along apex->base-centroid direction
    bc_s = base_s.mean(0)
    axis_s = bc_s - apex_s
    denom = np.dot(axis_s, axis_s) + 1e-9
    t = np.clip(((p - apex_s) @ axis_s) / denom, 1e-3, 1.0)  # (M,)
    # project to the base plane through the apex ray, get bilinear (u, v)
    ray = (p - apex_s) / t[:, None]
    q = apex_s + ray                                  # on base plane approx
    e_u = base_s[1] - base_s[0]
    e_v = base_s[3] - base_s[0]
    rel = q - base_s[0]
    uu = np.clip((rel @ e_u) / (np.dot(e_u, e_u) + 1e-9), 0, 1)
    vv = np.clip((rel @ e_v) / (np.dot(e_v, e_v) + 1e-9), 0, 1)
    # rebuild in the destination pyramid
    qd = (base_d[0] + uu[:, None] * (base_d[1] - base_d[0])
          + vv[:, None] * (base_d[3] - base_d[0]))
    out[:, 0:3] = apex_d + t[:, None] * (qd - apex_d)
    return out


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
