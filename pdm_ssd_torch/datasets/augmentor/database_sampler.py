"""GT-database sampling ("copy-paste") augmentation (host-side numpy): copy
of `pdm_ssd_tpu/datasets/augmentor/database_sampler.py` for LiDAR points.

Per-class round-robin sampling with epoch reshuffle, difficulty / min-points
filtering, BEV-IoU collision rejection against existing + already-placed
boxes (`utils/np_iou.py`), road-plane height snapping, scene-point carving
and object-point pasting. The image copy-paste (`IMG_AUG_TYPE`) and the
shared-memory database (`USE_SHARED_MEMORY`) are not copied and raise.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ...utils import np_iou


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
        for key in ('IMG_AUG_TYPE', 'USE_SHARED_MEMORY'):
            if sampler_cfg.get(key):
                raise NotImplementedError(f'gt_sampling {key} is not ported yet (ROADMAP Queue 1 '
                                          'item 12, camera and temporal models)')

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

    def _paste(self, data_dict, boxes, infos, dz):
        """Carve scene points inside the new boxes, read the stored object
        crops (box-centered) and place them at their boxes."""
        n_feat = self.sampler_cfg.NUM_POINT_FEATURES
        crops, ok = [], []
        for i, info in enumerate(infos):
            path = self.root_path / info['path']
            if not path.exists():
                ok.append(False)
                continue
            pts = np.fromfile(str(path), dtype=np.float32).reshape(-1, n_feat).copy()
            pts[:, :3] += boxes[i, :3]
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
