"""Pandaset dataset (copy of
`pdm_ssd_tpu/datasets/pandaset/pandaset_dataset.py`, in the structure of
`pcdet/datasets/pandaset/pandaset_dataset.py`).

Infos carrying 'cuboids_path' take the reference's raw pipeline
(`pandaset_utils.py`: world -> ego via the lidar pose, the normative axis
remap, the TRAINING_CATEGORIES label map), which needs pandas; infos with
'gt_boxes' and a `.npy` or `.bin` 'lidar_path' need none. The reference
returns an empty evaluation ("no official one",
`pandaset_dataset.py:437-443`); here, as in the JAX package, the Lyft-style
IoU-averaged mAP (`lyft_dataset.lyft_map`).
"""
from __future__ import annotations

import copy
import pickle

import numpy as np

from ..dataset import DatasetTemplate


class PandasetDataset(DatasetTemplate):
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
            self.logger.info('Total samples for Pandaset: %d' % len(self.infos))

    def __len__(self):
        return len(self.infos)

    def get_lidar(self, info):
        path = self.root_path / info['lidar_path']
        if path.suffix == '.npy':
            pts = np.load(str(path))
        else:
            pts = np.fromfile(str(path), dtype=np.float32).reshape(-1, 4)
        return pts[:, :4].astype(np.float32)

    def _pose_of(self, info):
        from . import pandaset_utils as pu
        seq_dir = self.root_path / 'dataset' / info['sequence']
        poses = pu.load_poses(seq_dir)
        return poses[info['frame_idx']]

    def __getitem__(self, index):
        info = copy.deepcopy(self.infos[index])
        if 'cuboids_path' in info:      # raw pandaset pipeline
            from . import pandaset_utils as pu
            pose = self._pose_of(info)
            points = pu.load_lidar_frame(
                self.root_path / info['lidar_path'], pose,
                device=self.dataset_cfg.get('LIDAR_DEVICE', 0))
            boxes, names, zrot = pu.load_cuboids(
                self.root_path / info['cuboids_path'], pose,
                device=self.dataset_cfg.get('LIDAR_DEVICE', 0),
                training_categories=self.dataset_cfg.get(
                    'TRAINING_CATEGORIES', None))
            input_dict = {'points': points, 'gt_boxes': boxes,
                          'gt_names': names,
                          'frame_id': info.get('frame_id', index)}
        else:
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
        from ..lyft.lyft_dataset import lyft_map
        gt_annos = []
        for i in self.infos:
            if 'cuboids_path' in i:
                from . import pandaset_utils as pu
                pose = self._pose_of(i)
                boxes, names, _ = pu.load_cuboids(
                    self.root_path / i['cuboids_path'], pose,
                    device=self.dataset_cfg.get('LIDAR_DEVICE', 0),
                    training_categories=self.dataset_cfg.get(
                        'TRAINING_CATEGORIES', None))
                gt_annos.append({'name': names, 'boxes_3d': boxes})
            else:
                gt_annos.append({
                    'name': np.asarray(i.get('gt_names', [])),
                    'boxes_3d': np.asarray(i.get('gt_boxes',
                                                 np.zeros((0, 7))))})
        return lyft_map(gt_annos, det_annos, class_names)
