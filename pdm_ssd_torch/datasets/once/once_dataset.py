"""ONCE dataset (copy of `pdm_ssd_tpu/datasets/once/once_dataset.py`, in the
structure of `pcdet/datasets/once/once_dataset.py`).

Info-pickle driven loading of the ONCE LiDAR bins
(`data/<sequence>/lidar_roof/<frame>.bin`, 4 float32 columns), the split
lists under `ImageSets/`, prediction dicts in the ONCE format, and the ONCE
AP of `once_eval.py` (AP per class and distance bucket).
"""
from __future__ import annotations

import copy
import pickle

import numpy as np

from ..dataset import DatasetTemplate


class ONCEDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger)
        self.split = self.dataset_cfg.DATA_SPLIT[self.mode]
        split_file = self.root_path / 'ImageSets' / (self.split + '.txt')
        self.sample_seq_list = [x.strip() for x in open(split_file).readlines()] \
            if split_file.exists() else []
        self.once_infos = []
        self.include_once_data(self.mode)

    def include_once_data(self, mode):
        infos = []
        for info_path in self.dataset_cfg.INFO_PATH[mode]:
            info_path = self.root_path / info_path
            if not info_path.exists():
                continue
            with open(info_path, 'rb') as f:
                infos.extend(pickle.load(f))
        self.once_infos.extend(infos)
        if self.logger is not None:
            self.logger.info('Total samples for ONCE dataset: %d' % len(infos))

    def get_lidar(self, sequence_id, frame_id):
        bin_path = self.root_path / 'data' / sequence_id / 'lidar_roof' / f'{frame_id}.bin'
        return np.fromfile(str(bin_path), dtype=np.float32).reshape(-1, 4)

    def __len__(self):
        return len(self.once_infos)

    def __getitem__(self, index):
        info = copy.deepcopy(self.once_infos[index])
        frame_id = info['frame_id']
        seq_id = info['sequence_id']
        points = self.get_lidar(seq_id, frame_id)
        input_dict = {'points': points, 'frame_id': frame_id}
        if 'annos' in info:
            annos = info['annos']
            input_dict.update({'gt_names': annos['name'],
                               'gt_boxes': annos['boxes_3d']})
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
                'boxes_3d': boxes, 'score': scores,
            })
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        """The ONCE AP of `once_eval.get_evaluation_results` (the protocol of
        the reference's `once_eval/evaluation.py:26`) against the infos'
        annos, every class of `class_names` and the Vehicle superclass."""
        from .once_eval import get_evaluation_results
        gt_annos = []
        for info in self.once_infos:
            annos = info.get('annos', {})
            gt_annos.append({
                'name': np.asarray(annos.get('name', np.zeros(0, dtype='<U16'))),
                'boxes_3d': np.asarray(annos.get('boxes_3d', np.zeros((0, 7)))),
            })
        ret_str, ret_dict = get_evaluation_results(gt_annos, det_annos,
                                                   list(class_names))
        return ret_str, ret_dict
