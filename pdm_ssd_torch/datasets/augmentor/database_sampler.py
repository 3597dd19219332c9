"""GT-database sampling ("copy-paste") augmentation (host-side numpy): copy
of `pdm_ssd_tpu/datasets/augmentor/database_sampler.py` for LiDAR points.

Per-class round-robin sampling with epoch reshuffle, difficulty / min-points
filtering, BEV-IoU collision rejection against existing + already-placed
boxes (`utils/np_iou.py`), road-plane height snapping, scene-point carving
and object-point pasting; with IMG_AUG_TYPE 'kitti' the image copy-paste
(each sampled object's source-image crop pasted far to near into the
target image, its points and box moved through the target calibration,
the points a pasted crop hides dropped), with source images read by
`image_ops.read_png` and crops resized by `image_ops.resize` (PIL's bicubic
without PIL); with USE_SHARED_MEMORY the stacked database (DB_DATA_PATH)
copied once into SHARED_MEMORY_DIR and memory-mapped from there.
"""
from __future__ import annotations

import pickle
import shutil
from pathlib import Path

import numpy as np

from ...utils import np_iou
from .. import image_ops

# where USE_SHARED_MEMORY puts its one copy of the stacked database, shared by
# every loader worker through the page cache
SHARED_MEMORY_DIR = Path('/dev/shm')


class _RoundRobinPool:
    """Cycles through a list of db infos, reshuffling after each pass."""

    def __init__(self, infos):
        self.infos = infos
        self.order = np.arange(len(infos))
        self.cursor = len(infos)        # force an initial shuffle

    def draw(self, k: int):
        if not self.infos:
            return []
        if self.cursor >= len(self.infos):
            self.order = np.random.permutation(len(self.infos))
            self.cursor = 0
        picks = self.order[self.cursor:self.cursor + k]
        self.cursor += k
        return [self.infos[i] for i in picks]


def _in_box_mask(points, boxes):
    """(N,) True where a point lies in any rotated box (BEV rotation test +
    z-extent)."""
    if len(boxes) == 0 or len(points) == 0:
        return np.zeros(len(points), bool)
    rel = points[:, None, :3] - boxes[None, :, :3]
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    u = rel[..., 0] * c + rel[..., 1] * s
    v = -rel[..., 0] * s + rel[..., 1] * c
    inside = ((np.abs(u) < boxes[:, 3] / 2) & (np.abs(v) < boxes[:, 4] / 2)
              & (np.abs(rel[..., 2]) <= boxes[:, 5] / 2))
    return inside.any(axis=1)


class DataBaseSampler:
    def __init__(self, root_path, sampler_cfg, class_names, logger=None):
        self.root_path = Path(root_path)
        self.class_names = class_names
        self.sampler_cfg = sampler_cfg
        self.logger = logger
        self.use_road_plane = sampler_cfg.get('USE_ROAD_PLANE', False)
        self.limit_whole_scene = sampler_cfg.get('LIMIT_WHOLE_SCENE', False)
        self.img_aug_type = sampler_cfg.get('IMG_AUG_TYPE', None)
        self.db_data = None
        if sampler_cfg.get('USE_SHARED_MEMORY', False) and sampler_cfg.get('DB_DATA_PATH'):
            self.db_data = self._load_db_to_shared_memory(sampler_cfg.DB_DATA_PATH[0])

        by_class = {name: [] for name in class_names}
        for rel in sampler_cfg.DB_INFO_PATH:
            path = self.root_path.resolve() / rel
            if not path.exists():
                if logger is not None:
                    logger.warning(f'DB info not found: {path}')
                continue
            loaded = pickle.loads(path.read_bytes())
            for name in class_names:
                by_class[name] += loaded.get(name, [])

        for step, arg in sampler_cfg.get('PREPARE', {}).items():
            by_class = getattr(self, step)(by_class, arg)

        # 'Car:15' style group specs -> per-class pools + quotas
        self.quota = {}
        self.pools = {}
        for spec in sampler_cfg.SAMPLE_GROUPS:
            name, num = spec.split(':')
            if name in class_names:
                self.quota[name] = int(num)
                self.pools[name] = _RoundRobinPool(by_class[name])

    def _load_db_to_shared_memory(self, rel: str):
        """The stacked database `rel` (an .npy of (points, features) rows that
        the infos' 'global_data_offset' slice) copied once into
        SHARED_MEMORY_DIR and memory-mapped from there; mapped from the data
        root where the copy fails; None (and a warning) where it is missing."""
        src = self.root_path.resolve() / rel
        if not src.exists():
            if self.logger is not None:
                self.logger.warning(f'DB data not found: {src}')
            return None
        shm = SHARED_MEMORY_DIR / rel.replace('/', '_')
        try:
            if not shm.exists():
                shutil.copyfile(src, shm)
            arr = np.load(shm, mmap_mode='r')
        except OSError:
            arr = np.load(src, mmap_mode='r')
        if self.logger is not None:
            self.logger.info('GT database mapped from shared memory')
        return arr

    # ---- PREPARE filters (names are config keys) ----

    @staticmethod
    def filter_by_difficulty(by_class, removed):
        return {name: [i for i in infos if i['difficulty'] not in removed]
                for name, infos in by_class.items()}

    @staticmethod
    def filter_by_min_points(by_class, specs):
        floors = dict(s.split(':') for s in specs)
        return {name: [i for i in infos
                       if i['num_points_in_gt'] >= int(floors.get(name, 0))]
                for name, infos in by_class.items()}

    # ---- placement ----

    def _snap_to_road_plane(self, boxes, data_dict):
        """Moves each sampled box vertically so its bottom face touches the
        road plane (reference `database_sampler.py:149-167`). The plane lives
        in the rect camera frame: solve the plane for the camera height at
        each box center, map back to lidar, shift. Returns the per-box z
        shift applied (callers shift the object points by the same amount)."""
        calib, plane = data_dict['calib'], data_dict['road_plane']
        a, b, c, d = plane
        center_cam = calib.lidar_to_rect(boxes[:, :3])
        center_cam[:, 1] = (-d - a * center_cam[:, 0] - c * center_cam[:, 2]) / b
        road_z = calib.rect_to_lidar(center_cam)[:, 2]
        dz = (boxes[:, 2] - boxes[:, 5] / 2) - road_z   # bottom face -> plane
        boxes[:, 2] -= dz
        return dz

    # ---- image copy-paste (IMG_AUG_TYPE 'kitti') ----

    @staticmethod
    def _np_box_corners(box7):
        """(7,) -> (8, 3) corners in the order of `box_ops.boxes_to_corners_3d`."""
        t = np.array([[1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
                      [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]], np.float32) / 2.0
        c = t * box7[3:6]
        cos, sin = np.cos(box7[6]), np.sin(box7[6])
        rot = np.array([[cos, -sin, 0], [sin, cos, 0], [0, 0, 1]], np.float32)
        return c @ rot.T + box7[:3]

    @staticmethod
    def _np_corners_to_box(corners):
        """(8, 3) corners in that order -> the (7,) LiDAR box they fit: the
        centre their mean, the sizes and heading from the means of the
        parallel edges."""
        center = corners.mean(axis=0)
        ex = corners[[0, 1, 4, 5]].mean(0) - corners[[2, 3, 6, 7]].mean(0)
        ey = corners[[0, 3, 4, 7]].mean(0) - corners[[1, 2, 5, 6]].mean(0)
        ez = corners[4:].mean(0) - corners[:4].mean(0)
        return np.array([center[0], center[1], center[2], np.linalg.norm(ex[:2]),
                         np.linalg.norm(ey[:2]), abs(ez[2]), np.arctan2(ex[1], ex[0])],
                        np.float32)

    def _collect_image_crop(self, info, data_dict, obj_pts, box3d):
        """The sampled object's crop of its source image (its 'bbox'), and its
        points and box moved from the source camera through pixels and depth
        into the target frame's calibration, with the moved box's 2D box in
        the target image: (crop (h, w, 3) float32, box2d (4,), points, box),
        or None where the source image or calibration is missing or the crop
        is empty."""
        from ..kitti.calibration import Calibration
        img_path = self.root_path / 'training' / 'image_2' / f"{info['image_idx']}.png"
        calib_path = self.root_path / 'training' / 'calib' / f"{info['image_idx']}.txt"
        if not img_path.exists() or not calib_path.exists():
            return None
        src_img = image_ops.read_png(img_path).astype(np.float32) / 255.0
        src_calib = Calibration(calib_path)
        tgt_calib = data_dict['calib']
        pix, depth = src_calib.lidar_to_img(obj_pts[:, :3])
        rect = tgt_calib.img_to_rect(pix[:, 0], pix[:, 1], depth)
        obj_pts = obj_pts.copy()
        obj_pts[:, :3] = tgt_calib.rect_to_lidar(rect)
        corners = self._np_box_corners(box3d[:7])
        cpix, cdepth = src_calib.lidar_to_img(corners)
        crect = tgt_calib.img_to_rect(cpix[:, 0], cpix[:, 1], cdepth)
        new_box = self._np_corners_to_box(tgt_calib.rect_to_lidar(crect))
        bpix, _ = tgt_calib.lidar_to_img(self._np_box_corners(new_box))
        H, W = data_dict['images'].shape[:2]
        box2d = np.array([bpix[:, 0].min(), bpix[:, 1].min(),
                          bpix[:, 0].max(), bpix[:, 1].max()], np.float32)
        box2d[[0, 2]] = np.clip(box2d[[0, 2]], 0, W - 1)
        box2d[[1, 3]] = np.clip(box2d[[1, 3]], 0, H - 1)
        sb = np.round(np.asarray(info['bbox'], np.float32)).astype(np.int64)
        sb[[0, 2]] = np.clip(sb[[0, 2]], 0, src_img.shape[1] - 1)
        sb[[1, 3]] = np.clip(sb[[1, 3]], 0, src_img.shape[0] - 1)
        crop = src_img[sb[1]:sb[3], sb[0]:sb[2]]
        if crop.size == 0:
            return None
        return crop, box2d, obj_pts, new_box

    def _paste_to_image(self, data_dict, new_boxes3d, new_boxes2d, crops, obj_point_idx):
        """The crops pasted far to near (by x) into the target image, each
        resized to its 2D box; then the points kept that agree with what
        the image shows: a pasted object's points where its own crop is in
        front, a scene point inside an existing 2D box where no crop covers
        it, any other scene point where nothing was pasted."""
        image = np.array(data_dict['images'], np.float32)
        H, W = image.shape[:2]
        gt_number = len(data_dict['gt_boxes2d']) if 'gt_boxes2d' in data_dict else 0
        order = np.argsort(new_boxes3d[:, 0])[::-1]
        paste_mask = np.full((H, W), -255, np.int64)
        fg_mask = np.zeros((H, W), np.int64)
        if gt_number:
            for gi, b in enumerate(np.round(data_dict['gt_boxes2d']).astype(np.int64)):
                x1, y1, x2, y2 = (np.clip(b[0], 0, W - 1), np.clip(b[1], 0, H - 1),
                                  np.clip(b[2], 0, W - 1), np.clip(b[3], 0, H - 1))
                fg_mask[y1:y2, x1:x2] = 1
                paste_mask[y1:y2, x1:x2] = gi
        for oi in order:
            x1, y1, x2, y2 = np.round(new_boxes2d[oi]).astype(np.int64)
            if x2 <= x1 or y2 <= y1:
                continue
            pixels = (np.clip(crops[oi], 0, 1) * 255).astype(np.uint8)
            image[y1:y2, x1:x2] = image_ops.resize(pixels, (x2 - x1, y2 - y1)) \
                .astype(np.float32) / 255.0
            paste_mask[y1:y2, x1:x2] = gt_number + oi
        data_dict['images'] = image

        pts = data_dict['points']
        pix, _ = data_dict['calib'].lidar_to_img(pts[:, :3])
        u = np.clip(pix[:, 0], 0, W - 1).astype(np.int64)
        v = np.clip(pix[:, 1], 0, H - 1).astype(np.int64)
        cell = paste_mask[v, u]
        is_obj = obj_point_idx >= 0
        new_mask = is_obj & (cell == (obj_point_idx + gt_number))
        raw_fg = (fg_mask[v, u] == 1) & (cell >= 0) & (cell < gt_number)
        raw_bg = (fg_mask[v, u] == 0) & (cell < 0)
        data_dict['points'] = pts[new_mask | (~is_obj & (raw_fg | raw_bg))]
        return data_dict

    def _paste(self, data_dict, boxes, infos, dz):
        """Carve scene points inside the new boxes, read the stored object
        crops (box-centered; from the shared-memory database where it is
        mapped) and place them at their boxes; with IMG_AUG_TYPE 'kitti'
        each object's image crop moves its points and box into the target
        calibration first, then the crops are pasted (`_paste_to_image`) and
        their 2D boxes appended to 'gt_boxes2d'."""
        n_feat = self.sampler_cfg.NUM_POINT_FEATURES
        img_aug = (self.img_aug_type == 'kitti' and 'images' in data_dict
                   and data_dict.get('calib') is not None)
        crops, ok, img_crops, boxes2d = [], [], [], []
        for i, info in enumerate(infos):
            if self.db_data is not None and 'global_data_offset' in info:
                lo, hi = info['global_data_offset']
                pts = np.array(self.db_data[lo:hi], np.float32).reshape(-1, n_feat)
            else:
                path = self.root_path / info['path']
                if not path.exists():
                    ok.append(False)
                    continue
                pts = np.fromfile(str(path), dtype=np.float32).reshape(-1, n_feat).copy()
            pts[:, :3] += boxes[i, :3]
            if img_aug:
                got = self._collect_image_crop(info, data_dict, pts, boxes[i, :7].copy())
                if got is None:
                    ok.append(False)
                    continue
                crop2d, box2d, pts, new_box = got
                boxes[i, :7] = new_box
                img_crops.append(crop2d)
                boxes2d.append(box2d)
            pts[:, 2] -= dz[i]
            crops.append(pts)
            ok.append(True)
        if not crops:
            return data_dict
        ok = np.array(ok, bool)
        boxes = boxes[ok]
        names = np.array([i['name'] for i, k in zip(infos, ok) if k])

        scene = data_dict['points']
        scene = scene[~_in_box_mask(scene, boxes)]
        obj_pts = np.concatenate(crops, axis=0)[:, :scene.shape[1]]
        data_dict['points'] = np.concatenate([obj_pts, scene], axis=0)
        data_dict['gt_boxes'] = np.concatenate(
            [data_dict['gt_boxes'], boxes[:, :data_dict['gt_boxes'].shape[1]]])
        data_dict['gt_names'] = np.concatenate([data_dict['gt_names'], names])
        if img_aug:
            obj_idx = np.concatenate([np.full(len(c), oi, np.int64) for oi, c in enumerate(crops)]
                                     + [np.full(len(scene), -1, np.int64)])
            boxes2d = np.stack(boxes2d)
            data_dict = self._paste_to_image(data_dict, boxes[:, :7], boxes2d, img_crops, obj_idx)
            if 'gt_boxes2d' in data_dict:
                data_dict['gt_boxes2d'] = np.concatenate(
                    [np.asarray(data_dict['gt_boxes2d'], np.float32).reshape(-1, 4), boxes2d])
            else:
                data_dict['gt_boxes2d'] = boxes2d
        return data_dict

    def __call__(self, data_dict):
        scene_boxes = data_dict['gt_boxes']
        scene_names = data_dict['gt_names'].astype(str)
        placed = scene_boxes[:, :7].astype(np.float32)
        accepted_infos = []

        for name, pool in self.pools.items():
            want = self.quota[name]
            if self.limit_whole_scene:
                want = max(want - int((scene_names == name).sum()), 0)
            if want <= 0:
                continue
            cand_infos = pool.draw(want)
            if not cand_infos:
                continue
            cand = np.stack([i['box3d_lidar'] for i in cand_infos]
                            ).astype(np.float32)[:, :7]
            # reject any candidate overlapping the scene, earlier-accepted
            # boxes, or another candidate (pairwise, both orders)
            vs_placed = np_iou.boxes_bev_iou_cpu(cand, placed) \
                if len(placed) else np.zeros((len(cand), 1), np.float32)
            vs_self = np_iou.boxes_bev_iou_cpu(cand, cand)
            np.fill_diagonal(vs_self, 0.0)
            keep = (vs_placed.max(axis=1) == 0) & (vs_self.max(axis=1) == 0)
            placed = np.concatenate([placed, cand[keep]])
            accepted_infos += [i for i, k in zip(cand_infos, keep) if k]

        new_boxes = placed[len(scene_boxes):]
        if len(new_boxes):
            if self.use_road_plane and data_dict.get('road_plane') is not None:
                dz = self._snap_to_road_plane(new_boxes, data_dict)
            else:
                dz = np.zeros(len(new_boxes), np.float32)
            data_dict = self._paste(data_dict, new_boxes, accepted_infos, dz)
        data_dict.pop('road_plane', None)
        return data_dict
