"""KITTI dataset: info-pkl driven loading, GT database creation, KITTI eval
(copy of `pdm_ssd_tpu/datasets/kitti/kitti_dataset.py`).

The info / dbinfo pickle schema is the JAX package's, which is
interchangeable with reference-generated pickles. Labels are parsed into
columnar `LabelTable`s; the GT database writer and the prediction->KITTI-anno
converter are vectorized over objects. Frame info layout:

    {'point_cloud': {'num_features', 'lidar_idx'},
     'image': {'image_idx', 'image_shape'},
     'calib': {'P2' 4x4, 'R0_rect' 4x4, 'Tr_velo_to_cam' 4x4},
     'annos': {name, truncated, occluded, alpha, bbox, dimensions(lhw),
               location, rotation_y, score, difficulty, index,
               gt_boxes_lidar, num_points_in_gt}}

Image shapes come from the PNG header alone; `get_image` decodes the PNG
with `datasets/image_ops.read_png` (no PIL), to the JAX package's PIL read.
"""
from __future__ import annotations

import copy
import pickle
import struct
from pathlib import Path

import numpy as np

from .. import image_ops
from ..dataset import DatasetTemplate
from . import kitti_utils
from .calibration import Calibration, _homogenize
from .object3d import LabelTable


def _camera_annos_from_table(table: LabelTable) -> dict:
    """Columnar label table -> the reference 'annos' dict (camera frame).
    DontCare rows sort to the tail and get index -1."""
    care = table.name != 'DontCare'
    n_care = int(care.sum())
    order = np.argsort(~care, kind='stable')   # care rows first, stable
    index = np.full(len(table), -1, np.int32)
    index[:n_care] = np.arange(n_care)
    return {
        'name': table.name[order],
        'truncated': table.truncated[order].astype(np.float64),
        'occluded': table.occluded[order].astype(np.float64),
        'alpha': table.alpha[order].astype(np.float64),
        'bbox': table.bbox[order].astype(np.float64),
        'dimensions': table.dims[order].astype(np.float64),     # (l, h, w)
        'location': table.loc[order].astype(np.float64),
        'rotation_y': table.ry[order].astype(np.float64),
        'score': table.score[order].astype(np.float64),
        'difficulty': table.difficulty()[order],
        'index': index,
    }, n_care


def _lidar_boxes_from_annos(annos: dict, n_objects: int, calib: Calibration):
    """Camera-frame annos -> (n_objects, 7) lidar boxes [x y z l w h heading]."""
    loc = annos['location'][:n_objects].astype(np.float32)
    lhw = annos['dimensions'][:n_objects].astype(np.float32)
    ry = annos['rotation_y'][:n_objects].astype(np.float32)
    centers = calib.rect_to_lidar(loc)
    centers[:, 2] += lhw[:, 1] / 2          # bottom face -> volumetric center
    heading = -(np.pi / 2 + ry)
    return np.concatenate([
        centers, lhw[:, [0]], lhw[:, [2]], lhw[:, [1]], heading[:, None]],
        axis=1)


class KittiDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger)
        self.kitti_infos = []
        self.set_split(self.dataset_cfg.DATA_SPLIT[self.mode], reload_infos=False)
        self._load_infos()

    # ---- file access ----

    def set_split(self, split, reload_infos=True):
        self.split = split
        self.root_split_path = self.root_path / (
            'testing' if split == 'test' else 'training')
        ids_file = self.root_path / 'ImageSets' / f'{split}.txt'
        self.sample_id_list = ids_file.read_text().split() \
            if ids_file.exists() else None
        if reload_infos:
            self.kitti_infos = []
            self._load_infos()

    def _load_infos(self):
        if self.logger is not None:
            self.logger.info('Loading KITTI dataset')
        n0 = len(self.kitti_infos)
        for rel in self.dataset_cfg.INFO_PATH.get(self.mode, []):
            path = self.root_path / rel
            if path.exists():
                self.kitti_infos += pickle.loads(path.read_bytes())
        if self.logger is not None:
            self.logger.info('Total samples for KITTI dataset: %d'
                             % (len(self.kitti_infos) - n0))

    def get_lidar(self, idx):
        path = self.root_split_path / 'velodyne' / f'{idx}.bin'
        return np.fromfile(str(path), dtype=np.float32).reshape(-1, 4)

    def get_image(self, idx):
        """(H, W, 3) float32 in [0, 1]: the frame's PNG as RGB, over 255."""
        return image_ops.read_png(self.root_split_path / 'image_2' / f'{idx}.png') \
            .astype(np.float32) / 255.0

    def get_image_shape(self, idx):
        """(H, W) from the PNG IHDR header — no image library needed."""
        with open(self.root_split_path / 'image_2' / f'{idx}.png', 'rb') as f:
            header = f.read(26)
        w, h = struct.unpack('>II', header[16:24])
        return np.array([h, w], dtype=np.int32)

    def get_label(self, idx) -> LabelTable:
        return LabelTable.from_file(self.root_split_path / 'label_2' / f'{idx}.txt')

    def get_calib(self, idx) -> Calibration:
        return Calibration(str(self.root_split_path / 'calib' / f'{idx}.txt'))

    def get_road_plane(self, idx):
        """Road plane (a, b, c, d) normalized, normal pointing up in camera
        frame (-y); None when the optional planes/ dir is absent."""
        path = self.root_split_path / 'planes' / f'{idx}.txt'
        if not path.exists():
            return None
        coefs = np.array(path.read_text().splitlines()[3].split(), np.float64)
        if coefs[1] > 0:
            coefs = -coefs
        return coefs / np.linalg.norm(coefs[:3])

    @staticmethod
    def get_fov_flag(pts_rect, img_shape, calib):
        pix, depth = calib.rect_to_img(pts_rect)
        h, w = int(img_shape[0]), int(img_shape[1])
        return ((pix[:, 0] >= 0) & (pix[:, 0] < w)
                & (pix[:, 1] >= 0) & (pix[:, 1] < h) & (depth >= 0))

    # ---- offline info generation ----

    def get_infos(self, num_workers=4, has_label=True, count_inside_pts=True,
                  sample_id_list=None):
        from concurrent.futures import ThreadPoolExecutor

        def frame_info(sample_idx):
            calib = self.get_calib(sample_idx)
            image_shape = self.get_image_shape(sample_idx)
            info = {
                'point_cloud': {'num_features': 4, 'lidar_idx': sample_idx},
                'image': {'image_idx': sample_idx, 'image_shape': image_shape},
                'calib': {
                    'P2': np.vstack([calib.P2, [0., 0., 0., 1.]]),
                    'R0_rect': _homogenize(calib.R0),
                    'Tr_velo_to_cam': np.vstack([calib.V2C, [0., 0., 0., 1.]]),
                },
            }
            if not has_label:
                return info
            annos, n_obj = _camera_annos_from_table(self.get_label(sample_idx))
            annos['gt_boxes_lidar'] = _lidar_boxes_from_annos(annos, n_obj, calib)
            if count_inside_pts:
                points = self.get_lidar(sample_idx)
                fov = self.get_fov_flag(
                    calib.lidar_to_rect(points[:, :3]), image_shape, calib)
                inside = kitti_utils.points_in_boxes_cpu(
                    points[fov][:, :3], annos['gt_boxes_lidar'])
                counts = np.full(len(annos['name']), -1, np.int32)
                counts[:n_obj] = inside.sum(axis=1)
                annos['num_points_in_gt'] = counts
            info['annos'] = annos
            return info

        ids = sample_id_list if sample_id_list is not None else self.sample_id_list
        with ThreadPoolExecutor(num_workers) as pool:
            return list(pool.map(frame_info, ids))

    def create_groundtruth_database(self, info_path=None, used_classes=None,
                                    split='train'):
        """Crop per-object point clouds + write the dbinfos pickle feeding
        the GT sampler. Object points are stored box-centered."""
        db_dir = self.root_path / ('gt_database' if split == 'train'
                                   else f'gt_database_{split}')
        db_dir.mkdir(parents=True, exist_ok=True)
        infos = pickle.loads(Path(info_path).read_bytes())

        db_infos = {}
        for info in infos:
            sample_idx = info['point_cloud']['lidar_idx']
            annos = info['annos']
            boxes = annos['gt_boxes_lidar']
            if len(boxes) == 0:
                continue
            points = self.get_lidar(sample_idx)
            membership = kitti_utils.points_in_boxes_cpu(points[:, :3], boxes)
            for i, name in enumerate(annos['name'][:len(boxes)]):
                obj_points = points[membership[i] > 0] - np.pad(
                    boxes[i, :3], (0, points.shape[1] - 3))
                rel_path = db_dir.name + f'/{sample_idx}_{name}_{i}.bin'
                obj_points.astype(np.float32).tofile(str(self.root_path / rel_path))
                if used_classes is not None and name not in used_classes:
                    continue
                db_infos.setdefault(name, []).append({
                    'name': name, 'path': rel_path, 'image_idx': sample_idx,
                    'gt_idx': i, 'box3d_lidar': boxes[i],
                    'num_points_in_gt': int((membership[i] > 0).sum()),
                    'difficulty': annos['difficulty'][i], 'bbox': annos['bbox'][i],
                    'score': annos['score'][i],
                })
        for name, lst in db_infos.items():
            print(f'Database {name}: {len(lst)}')
        with open(self.root_path / f'kitti_dbinfos_{split}.pkl', 'wb') as f:
            pickle.dump(db_infos, f)

    # ---- predictions -> KITTI annos ----

    @staticmethod
    def generate_prediction_dicts(batch_dict, pred_dicts, class_names,
                                  output_path=None):
        """Fixed-shape device outputs -> per-frame KITTI camera annos.
        The `pred_mask` validity column from the jitted post-processing
        selects real detections; conversion is vectorized per frame."""
        annos = []
        for b, det in enumerate(pred_dicts):
            valid = np.asarray(det['pred_mask']).astype(bool)
            boxes = np.asarray(det['pred_boxes'])[valid]
            scores = np.asarray(det['pred_scores'])[valid]
            labels = np.asarray(det['pred_labels'])[valid].astype(np.int64)

            n = len(boxes)
            frame = {
                'frame_id': batch_dict['frame_id'][b],
                'name': np.zeros(n), 'truncated': np.zeros(n),
                'occluded': np.zeros(n), 'alpha': np.zeros(n),
                'bbox': np.zeros((n, 4)), 'dimensions': np.zeros((n, 3)),
                'location': np.zeros((n, 3)), 'rotation_y': np.zeros(n),
                'score': np.zeros(n), 'boxes_lidar': np.zeros((n, 7)),
            }
            if n:
                calib = batch_dict['calib'][b]
                cam = kitti_utils.boxes3d_lidar_to_kitti_camera(boxes, calib)
                frame.update(
                    name=np.array(class_names)[labels - 1],
                    alpha=cam[:, 6] - np.arctan2(-boxes[:, 1], boxes[:, 0]),
                    bbox=kitti_utils.boxes3d_kitti_camera_to_imageboxes(
                        cam, calib,
                        image_shape=np.asarray(batch_dict['image_shape'][b])),
                    dimensions=cam[:, 3:6], location=cam[:, 0:3],
                    rotation_y=cam[:, 6], score=scores, boxes_lidar=boxes,
                )
            annos.append(frame)
            if output_path is not None:
                _write_kitti_label(Path(output_path)
                                   / f"{frame['frame_id']}.txt", frame)
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        if 'annos' not in self.kitti_infos[0]:
            return None, {}
        from .eval import get_official_eval_result
        gt = [copy.deepcopy(info['annos']) for info in self.kitti_infos]
        return get_official_eval_result(gt, copy.deepcopy(det_annos), class_names)

    # ---- torch-style dataset protocol ----

    def __len__(self):
        n = len(self.kitti_infos)
        if self.dataset_cfg.get('MERGE_ALL_ITERS_TO_ONE_EPOCH', False):
            n *= self.total_epochs
        return n

    def __getitem__(self, index):
        index %= len(self.kitti_infos)
        info = self.kitti_infos[index]
        sample_idx = info['point_cloud']['lidar_idx']
        img_shape = info['image']['image_shape']
        calib = self.get_calib(sample_idx)

        input_dict = {'frame_id': sample_idx, 'calib': calib}
        if 'annos' in info:
            annos = info['annos']
            care = annos['name'] != 'DontCare'
            input_dict['gt_names'] = annos['name'][care]
            input_dict['gt_boxes'] = annos['gt_boxes_lidar'][
                care[:len(annos['gt_boxes_lidar'])]].copy()
            if self.training:
                plane = self.get_road_plane(sample_idx)
                if plane is not None:
                    input_dict['road_plane'] = plane

        get_item_list = self.dataset_cfg.get('GET_ITEM_LIST', ['points'])
        if 'points' in get_item_list:
            points = self.get_lidar(sample_idx)
            if self.dataset_cfg.get('FOV_POINTS_ONLY', False):
                fov = self.get_fov_flag(
                    calib.lidar_to_rect(points[:, :3]), img_shape, calib)
                points = points[fov]
            input_dict['points'] = points
        if 'images' in get_item_list:
            input_dict['images'] = self.get_image(sample_idx)
            if 'annos' in info and 'bbox' in info['annos']:
                input_dict['gt_boxes2d'] = np.asarray(
                    info['annos']['bbox'], np.float32).reshape(-1, 4)[
                        care[:len(info['annos']['bbox'])]]

        data_dict = self.prepare_data(data_dict=input_dict)
        if data_dict is None:   # augmentation left zero GT -> resample
            return self.__getitem__(np.random.randint(len(self)))
        data_dict['image_shape'] = img_shape
        return data_dict


def _write_kitti_label(path: Path, frame: dict):
    """One prediction frame -> official KITTI result txt."""
    cols = np.column_stack([
        frame['alpha'], frame['bbox'],
        frame['dimensions'][:, [1, 2, 0]],    # print order h, w, l
        frame['location'], frame['rotation_y'], frame['score'],
    ]) if len(frame['name']) else np.zeros((0, 13))
    with open(path, 'w') as f:
        for name, row in zip(frame['name'], cols):
            f.write(f"{name} -1 -1 " + ' '.join(f'{v:.4f}' for v in row) + '\n')


def create_kitti_infos(dataset_cfg, class_names, data_path, save_path, workers=4):
    """Offline info + GT-database generation for all splits
    (`kitti_dataset.create_kitti_infos` role)."""
    dataset = KittiDataset(dataset_cfg=dataset_cfg, class_names=class_names,
                           root_path=data_path, training=False)
    save_path = Path(save_path)
    print('---------------Start to generate data infos---------------')

    per_split = {}
    for split in ['train', 'val']:
        dataset.set_split(split, reload_infos=False)
        per_split[split] = dataset.get_infos(
            num_workers=workers, has_label=True, count_inside_pts=True)
        out = save_path / f'kitti_infos_{split}.pkl'
        out.write_bytes(pickle.dumps(per_split[split]))
        print(f'Kitti info {split} file is saved to {out}')
    (save_path / 'kitti_infos_trainval.pkl').write_bytes(
        pickle.dumps(per_split['train'] + per_split['val']))

    if (Path(data_path) / 'testing').exists():
        dataset.set_split('test', reload_infos=False)
        (save_path / 'kitti_infos_test.pkl').write_bytes(pickle.dumps(
            dataset.get_infos(num_workers=workers, has_label=False,
                              count_inside_pts=False)))

    print('---------------Start create groundtruth database for data augmentation---------------')
    dataset.set_split('train', reload_infos=False)
    dataset.create_groundtruth_database(
        save_path / 'kitti_infos_train.pkl', split='train')
    print('---------------Data preparation Done---------------')

