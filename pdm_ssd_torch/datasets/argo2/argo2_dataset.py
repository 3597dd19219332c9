"""Argoverse 2 dataset (copy of `pdm_ssd_tpu/datasets/argo2/argo2_dataset.py`,
in the structure of `pcdet/datasets/argo2/argo2_dataset.py`).

Info pickles name each sweep: a `.npy` or `.bin` one reads without pandas, a
raw `.feather` one through `argo2_utils` (which needs pandas). The
evaluation is the CDS protocol of `argo2_eval.py` (center-distance AP over
{0.5, 1, 2, 4} m, ATE / ASE / AOE at 2 m); METRIC: nuscenes takes the port's
`nuscenes_eval.evaluate_nuscenes` (distance-matched mAP / NDS) instead.
"""
from __future__ import annotations

import copy
import pickle

import numpy as np

from ..dataset import DatasetTemplate


class Argo2Dataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger)
        self.infos = []
        for info_path in self.dataset_cfg.INFO_PATH[self.mode]:
            p = self.root_path / info_path
            if p.exists():
                with open(p, 'rb') as f:
                    self.infos.extend(pickle.load(f))
        if self.logger is not None:
            self.logger.info('Total samples for Argo2: %d' % len(self.infos))

    def __len__(self):
        return len(self.infos)

    def get_lidar(self, info):
        path = self.root_path / info['lidar_path']
        if path.suffix == '.npy':
            pts = np.load(str(path))
        elif path.suffix == '.feather':
            from .argo2_utils import read_lidar_sweep
            pts = read_lidar_sweep(path)
            if pts.shape[1] == 3:
                pts = np.concatenate(
                    [pts, np.zeros((len(pts), 1), np.float32)], 1)
        else:
            pts = np.fromfile(str(path), dtype=np.float32).reshape(-1, 4)
        return pts[:, :4].astype(np.float32)

    def __getitem__(self, index):
        info = copy.deepcopy(self.infos[index])
        input_dict = {'points': self.get_lidar(info),
                      'frame_id': info.get('frame_id', index)}
        if 'gt_boxes' in info:
            input_dict.update({'gt_names': info['gt_names'],
                               'gt_boxes': info['gt_boxes']})
        data_dict = self.prepare_data(data_dict=input_dict)
        if data_dict is None:
            return self.__getitem__(np.random.randint(len(self)))
        return data_dict

    @staticmethod
    def generate_prediction_dicts(batch_dict, pred_dicts, class_names,
                                  output_path=None):
        from ..lyft.lyft_dataset import LyftDataset
        return LyftDataset.generate_prediction_dicts(
            batch_dict, pred_dicts, class_names, output_path)

    def evaluation(self, det_annos, class_names, **kwargs):
        """Official Argo2 protocol (CDS) via the in-tree devkit-free
        implementation (`argo2_eval.py`); pass METRIC: nuscenes in the
        dataset config to fall back to the distance-matched mAP/NDS."""
        gt_annos = [{'name': np.asarray(i.get('gt_names', [])),
                     'boxes_3d': np.asarray(i.get('gt_boxes', np.zeros((0, 7))))}
                    for i in self.infos]
        if self.dataset_cfg.get('METRIC', 'argo2') == 'nuscenes':
            from ..nuscenes.nuscenes_eval import evaluate_nuscenes
            return evaluate_nuscenes(gt_annos, det_annos, list(class_names))
        from .argo2_eval import evaluate_argo2
        return evaluate_argo2(gt_annos, det_annos, list(class_names))
