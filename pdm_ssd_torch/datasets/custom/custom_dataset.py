"""Custom dataset template (copy of
`pdm_ssd_tpu/datasets/custom/custom_dataset.py`, itself in the layout of
`pcdet/datasets/custom/custom_dataset.py`).

Expects the reference's custom layout:
    data/custom/
        ImageSets/{train,val}.txt
        points/*.npy          (N, 3+C) float32
        labels/*.txt          'x y z dx dy dz heading class_name' per line
Provides `__getitem__`, `get_infos`, `create_groundtruth_database`,
`generate_prediction_dicts` (lidar-frame output; no camera conversion) and a
lidar-frame evaluation: the recall at 3D IoU 0.3, 0.5 and 0.7, through the
port's `ops/iou3d.boxes_iou3d` on CPU tensors (the JAX package runs its jax
op there; the other evaluators run numpy on the host too).
"""
from __future__ import annotations

import copy
import pickle

import numpy as np
import torch

from ..dataset import DatasetTemplate
from ..kitti import kitti_utils


class CustomDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger)
        self.split = self.dataset_cfg.DATA_SPLIT[self.mode]
        split_file = self.root_path / 'ImageSets' / (self.split + '.txt')
        self.sample_id_list = [x.strip() for x in open(split_file).readlines()] \
            if split_file.exists() else []
        self.custom_infos = []
        self.include_data(self.mode)
        self.map_class_to_kitti = self.dataset_cfg.get('MAP_CLASS_TO_KITTI', None)

    def include_data(self, mode):
        infos = []
        for info_path in self.dataset_cfg.INFO_PATH[mode]:
            info_path = self.root_path / info_path
            if not info_path.exists():
                continue
            with open(info_path, 'rb') as f:
                infos.extend(pickle.load(f))
        self.custom_infos.extend(infos)
        if self.logger is not None:
            self.logger.info(f'Total samples for CUSTOM dataset: {len(infos)}')

    def get_lidar(self, idx):
        return np.load(self.root_path / 'points' / f'{idx}.npy')

    def get_label(self, idx):
        with open(self.root_path / 'labels' / f'{idx}.txt', 'r') as f:
            lines = f.readlines()
        gt_boxes, gt_names = [], []
        for line in lines:
            parts = line.strip().split(' ')
            gt_boxes.append([float(v) for v in parts[:7]])
            gt_names.append(parts[7])
        return np.array(gt_boxes, np.float32), np.array(gt_names)

    def __len__(self):
        return len(self.custom_infos)

    def __getitem__(self, index):
        info = copy.deepcopy(self.custom_infos[index])
        sample_idx = info['point_cloud']['lidar_idx']
        points = self.get_lidar(sample_idx)
        input_dict = {'frame_id': sample_idx, 'points': points}
        if 'annos' in info:
            annos = info['annos']
            input_dict.update({'gt_names': annos['name'],
                               'gt_boxes': annos['gt_boxes_lidar']})
        data_dict = self.prepare_data(data_dict=input_dict)
        if data_dict is None:
            return self.__getitem__(np.random.randint(len(self)))
        return data_dict

    @staticmethod
    def generate_prediction_dicts(batch_dict, pred_dicts, class_names, output_path=None):
        annos = []
        for index, box_dict in enumerate(pred_dicts):
            mask = np.asarray(box_dict.get('pred_mask'))
            boxes = np.asarray(box_dict['pred_boxes'])[mask]
            scores = np.asarray(box_dict['pred_scores'])[mask]
            labels = np.asarray(box_dict['pred_labels'])[mask].astype(np.int64)
            annos.append({
                'frame_id': batch_dict['frame_id'][index],
                'name': np.array(class_names)[np.clip(labels - 1, 0, len(class_names) - 1)],
                'boxes_lidar': boxes,
                'score': scores,
            })
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        """The share of GT boxes whose best detection (any class) overlaps
        them by more than 3D IoU 0.3, 0.5 and 0.7: {'recall_<t>': share}."""
        from ...ops import iou3d
        total = {0.3: 0, 0.5: 0, 0.7: 0}
        n_gt = 0
        for info, det in zip(self.custom_infos, det_annos):
            gts = info.get('annos', {}).get('gt_boxes_lidar', np.zeros((0, 7)))
            n_gt += len(gts)
            if len(gts) == 0 or len(det['boxes_lidar']) == 0:
                continue
            iou = iou3d.boxes_iou3d(
                torch.from_numpy(np.asarray(gts[:, :7], np.float32)),
                torch.from_numpy(np.asarray(det['boxes_lidar'][:, :7], np.float32))).numpy()
            best = iou.max(axis=1)
            for t in total:
                total[t] += int((best > t).sum())
        ret = {f'recall_{t}': total[t] / max(n_gt, 1) for t in total}
        return str(ret), ret

    def get_infos(self, class_names=None, num_workers=4, has_label=True,
                  sample_id_list=None):
        sample_id_list = sample_id_list or self.sample_id_list
        infos = []
        for sample_idx in sample_id_list:
            info = {'point_cloud': {'num_features': self.point_feature_encoder.num_point_features,
                                    'lidar_idx': sample_idx}}
            if has_label:
                gt_boxes, gt_names = self.get_label(sample_idx)
                info['annos'] = {'name': gt_names, 'gt_boxes_lidar': gt_boxes}
            infos.append(info)
        return infos

    def create_groundtruth_database(self, info_path, used_classes=None, split='train'):
        """Each GT box's points (relative to its centre) under
        `gt_database[_<split>]/<idx>_<name>_<i>.bin`, and their records in
        `custom_dbinfos_<split>.pkl`, for the GT sampler."""
        db_save = self.root_path / ('gt_database' if split == 'train'
                                    else f'gt_database_{split}')
        db_save.mkdir(parents=True, exist_ok=True)
        with open(info_path, 'rb') as f:
            infos = pickle.load(f)
        all_db_infos = {}
        for info in infos:
            idx = info['point_cloud']['lidar_idx']
            points = self.get_lidar(idx)
            annos = info.get('annos')
            if annos is None:
                continue
            gt_boxes = annos['gt_boxes_lidar']
            inside = kitti_utils.points_in_boxes_cpu(points[:, :3], gt_boxes)
            for i, name in enumerate(annos['name']):
                if used_classes and name not in used_classes:
                    continue
                pts = points[inside[i] > 0].copy()
                pts[:, :3] -= gt_boxes[i, :3]
                fp = db_save / f'{idx}_{name}_{i}.bin'
                pts.astype(np.float32).tofile(str(fp))
                all_db_infos.setdefault(name, []).append({
                    'name': name, 'path': str(fp.relative_to(self.root_path)),
                    'gt_idx': i, 'box3d_lidar': gt_boxes[i],
                    'num_points_in_gt': len(pts), 'difficulty': 0,
                })
        with open(self.root_path / f'custom_dbinfos_{split}.pkl', 'wb') as f:
            pickle.dump(all_db_infos, f)
