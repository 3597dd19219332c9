"""Synthetic mini-KITTI fabricator (copy of
`pdm_ssd_tpu/datasets/kitti/synthetic.py` that imports no JAX).

Builds a tiny, fully self-consistent KITTI-format dataset (velodyne bins,
label_2 txt in camera frame, calib, png images) for end-to-end pipeline
tests and CLI runs without the real KITTI download. Planted boxes are exactly
recoverable, so a short training run must reach recall ~1.0.

Two regimes:
  - default (`classes=('Car',)`): 3 cars per frame, the set of the fast unit
    tests;
  - rich (`classes=('Car','Pedestrian','Cyclist')`): a multi-class set with
    distance / occlusion / truncation spread so that the official KITTI
    difficulty bands (easy / moderate / hard, see `object3d.py`) all get
    populated, making AP R11/R40 a meaningful regression metric.

The same seed gives the same velodyne, label, calib and split files as the
JAX package's generator, and images of the same pixels (a row gradient plus
a texture seeded by the frame's number), written by `image_ops.write_png`
without PIL: their bytes differ from PIL's, their decoded pixels do not.
"""
from __future__ import annotations

import numpy as np

from .. import image_ops
from . import kitti_utils
from .calibration import Calibration

P2 = np.array([[700., 0., 600., 0.],
               [0., 700., 180., 0.],
               [0., 0., 1., 0.]], np.float32)
R0 = np.eye(3, dtype=np.float32)
V2C = np.array([[0., -1., 0., 0.],
                [0., 0., -1., 0.],
                [1., 0., 0., 0.]], np.float32)

IMG_H, IMG_W = 375, 1242

# per-class (l, w, h) prior dims + base point budget at reference distance
CLASS_SPECS = {
    'Car': ((3.9, 1.6, 1.56), 220),
    'Pedestrian': ((0.8, 0.6, 1.73), 130),
    'Cyclist': ((1.76, 0.6, 1.73), 150),
}


def write_calib(path):
    lines = [
        'P0: ' + ' '.join(map(str, P2.reshape(-1))),
        'P1: ' + ' '.join(map(str, P2.reshape(-1))),
        'P2: ' + ' '.join(map(str, P2.reshape(-1))),
        'P3: ' + ' '.join(map(str, P2.reshape(-1))),
        'R0_rect: ' + ' '.join(map(str, R0.reshape(-1))),
        'Tr_velo_to_cam: ' + ' '.join(map(str, V2C.reshape(-1))),
        'Tr_imu_to_velo: ' + ' '.join(map(str, V2C.reshape(-1))),
    ]
    path.write_text('\n'.join(lines) + '\n')


def image_pixels(seed: int, w: int = IMG_W, h: int = IMG_H) -> np.ndarray:
    """(h, w, 3) uint8: a grey row gradient from 60 to 140 plus a texture of
    integers in [0, 40) drawn from `np.random.RandomState(seed)`."""
    rng = np.random.RandomState(seed)
    rows = np.linspace(60, 140, h, dtype=np.float32)[:, None, None]
    img = rows + rng.randint(0, 40, (h, w, 3)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_image(path, seed: int, w: int = IMG_W, h: int = IMG_H):
    """A decodable 8-bit RGB PNG of `image_pixels(seed)`."""
    image_ops.write_png(path, image_pixels(seed, w, h))


def _camera_box(box):
    calib = Calibration({'P2': P2, 'P3': P2, 'R0': R0, 'Tr_velo2cam': V2C})
    cam = kitti_utils.boxes3d_lidar_to_kitti_camera(box[None, :7], calib)[0]
    raw = kitti_utils.boxes3d_kitti_camera_to_imageboxes(cam[None], calib)[0]
    return cam, raw


def truncation_of(box):
    """KITTI truncation = fraction of the (unclipped) 2D box outside the
    image. Returns (trunc, clipped_bbox) or (None, None) if fully outside."""
    _, raw = _camera_box(box)
    x1, y1, x2, y2 = raw
    cx1, cy1 = max(x1, 0.), max(y1, 0.)
    cx2, cy2 = min(x2, IMG_W - 1.), min(y2, IMG_H - 1.)
    if cx2 <= cx1 or cy2 <= cy1:
        return None, None
    raw_area = (x2 - x1) * (y2 - y1)
    clip_area = (cx2 - cx1) * (cy2 - cy1)
    trunc = float(np.clip(1.0 - clip_area / max(raw_area, 1e-6), 0., 1.))
    return trunc, np.array([cx1, cy1, cx2, cy2], np.float32)


def lidar_box_to_label(box, cls='Car', trunc=0.0, occl=0):
    """lidar (x,y,z_center,dx,dy,dz,heading) -> KITTI label line."""
    cam, _ = _camera_box(box)
    _, bbox = truncation_of(box)
    if bbox is None:
        bbox = np.zeros(4, np.float32)
    x, y, z, l, h, w, ry = cam
    alpha = -np.arctan2(-box[1], box[0]) + ry
    return (f'{cls} {trunc:.2f} {int(occl)} {alpha:.2f} {bbox[0]:.2f} '
            f'{bbox[1]:.2f} {bbox[2]:.2f} {bbox[3]:.2f} {h:.2f} {w:.2f} '
            f'{l:.2f} {x:.2f} {y:.2f} {z:.2f} {ry:.2f}')


def _sample_rich_objects(rng, classes):
    """Objects with distance / lateral / occlusion spread. Every frame gets
    >=1 Car; far + occluded + truncated objects populate the harder bands."""
    n_extra = rng.randint(3, 7)
    probs = {'Car': 0.45, 'Pedestrian': 0.3, 'Cyclist': 0.25}
    pool = [c for c in classes if c in probs]
    p = np.array([probs[c] for c in pool]); p /= p.sum()
    names = ['Car'] + [pool[rng.choice(len(pool), p=p)] for _ in range(n_extra)]
    objs, placed = [], []
    for cls in names:
        dims, base_pts = CLASS_SPECS[cls]
        diag = float(np.hypot(dims[0], dims[1]))
        x = y = None
        for _ in range(25):
            cx = rng.uniform(7, 55)
            if rng.rand() < 0.18:
                # near the FOV edge -> partially outside the image (truncated)
                cy = float(np.sign(rng.randn())) * rng.uniform(0.62, 0.80) * cx
            else:
                cy = rng.uniform(-0.45, 0.45) * cx
            if all(np.hypot(cx - px, cy - py) > (diag + pd) / 2 + 1.0
                   for px, py, pd in placed):
                x, y = cx, cy
                break
        if x is None:
            continue
        placed.append((x, y, diag))
        z = -1.6 + dims[2] / 2 + rng.uniform(-0.05, 0.05)
        box = np.array([x, y, z, *dims, rng.uniform(-np.pi, np.pi)],
                       np.float32)
        trunc, bbox = truncation_of(box)
        if trunc is None or trunc > 0.85:
            continue
        occl = int(rng.choice([0, 1, 2], p=[0.6, 0.25, 0.15]))
        # point budget falls with distance and occlusion, floor above the
        # GT-db min-points filter (5)
        n_pts = int(base_pts * min(1.0, (18.0 / x) ** 1.7)
                    * [1.0, 0.5, 0.28][occl])
        objs.append((cls, box, trunc, occl, max(n_pts, 8)))
    return objs


def _object_points(rng, box, n_pts):
    local = rng.uniform(-0.5, 0.5, (n_pts, 3)) * box[3:6] * 0.9
    c, s = np.cos(box[6]), np.sin(box[6])
    gx = local[:, 0] * c - local[:, 1] * s + box[0]
    gy = local[:, 0] * s + local[:, 1] * c + box[1]
    gz = local[:, 2] + box[2]
    return np.stack([gx, gy, gz, rng.rand(n_pts)], 1)


def make_mini_kitti(root, n_frames=3, seed=0, n_bg=2000, classes=('Car',)):
    rich = len(classes) > 1
    rng = np.random.RandomState(seed)
    (root / 'ImageSets').mkdir(parents=True)
    for sub in ['velodyne', 'label_2', 'calib', 'image_2']:
        (root / 'training' / sub).mkdir(parents=True)
    ids = [f'{i:06d}' for i in range(n_frames)]
    (root / 'ImageSets/train.txt').write_text('\n'.join(ids) + '\n')
    (root / 'ImageSets/val.txt').write_text('\n'.join(ids) + '\n')

    for fid in ids:
        if rich:
            objs = _sample_rich_objects(rng, classes)
        else:
            objs = []
            for _ in range(3):
                x = rng.uniform(8, 40)
                y = np.clip(rng.uniform(-0.5, 0.5) * x * 0.5, -15, 15)
                box = np.array([x, y, -0.8, 3.9, 1.6, 1.56,
                                rng.uniform(-1.5, 1.5)], np.float32)
                objs.append(('Car', box, 0.0, 0, 200))
        # background points in FOV + points inside each box
        bg_x = rng.uniform(3, 60, n_bg)
        bg = np.stack([bg_x, bg_x * rng.uniform(-0.4, 0.4, n_bg),
                       rng.uniform(-1.6, 0.5, n_bg), rng.rand(n_bg)], 1)
        pts = np.concatenate(
            [bg] + [_object_points(rng, box, n) for _, box, _, _, n in objs]
        ).astype(np.float32)
        pts.tofile(str(root / 'training/velodyne' / f'{fid}.bin'))
        labels = [lidar_box_to_label(box, cls, trunc, occl)
                  for cls, box, trunc, occl, _ in objs]
        (root / 'training/label_2' / f'{fid}.txt').write_text(
            '\n'.join(labels) + '\n')
        write_calib(root / 'training/calib' / f'{fid}.txt')
        write_image(root / 'training/image_2' / f'{fid}.png', seed=int(fid))
