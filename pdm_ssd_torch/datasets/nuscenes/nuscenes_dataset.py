"""nuScenes dataset, LiDAR half (copy of
`pdm_ssd_tpu/datasets/nuscenes/nuscenes_dataset.py`).

Info-pkl driven; key frame plus past sweeps moved into the key frame's
LiDAR frame with a time-lag column; velocity-extended (9-dof) boxes whose
velocity columns are dropped unless PRED_VELOCITY; class-balanced resampling
(CBGS) in training; predictions turned into annos carrying each sample's
`metadata`; the devkit-free nuScenes metrics (`nuscenes_eval.py`). The draws
(CBGS, the sweeps taken) use the global `np.random`, as the JAX package
does, so one seed gives both packages the same samples. `CAMERA_CONFIG`
(the camera images and transforms) raises: ROADMAP Queue 1 item 12.
"""
from __future__ import annotations

import copy
import pickle
from pathlib import Path

import numpy as np

from ..dataset import DatasetTemplate
from .synthetic import CAMERA_ITEM


class NuScenesDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        if dataset_cfg.get('CAMERA_CONFIG', None) is not None:
            raise NotImplementedError(CAMERA_ITEM)
        root_path = (root_path if root_path is not None
                     else Path(dataset_cfg.DATA_PATH)) / dataset_cfg.VERSION \
            if dataset_cfg.get('VERSION') else root_path
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger)
        self.infos = []
        self.include_nuscenes_data(self.mode)
        if self.training and self.dataset_cfg.get('BALANCED_RESAMPLING', False):
            self.infos = self.balanced_infos_resampling(self.infos)

    def include_nuscenes_data(self, mode):
        n0 = len(self.infos)
        for rel in self.dataset_cfg.INFO_PATH[mode]:
            path = self.root_path / rel
            if path.exists():
                self.infos += pickle.loads(path.read_bytes())
        if self.logger is not None:
            self.logger.info('Total samples for NuScenes dataset: %d'
                             % (len(self.infos) - n0))

    def balanced_infos_resampling(self, infos):
        """Class-balanced resampling: each class present draws
        round(total / n_classes) of the frames that hold it, with
        replacement, where total counts (class, frame) pairs."""
        if not self.class_names:
            return infos
        frames_with = {name: np.array(
            [i for i, info in enumerate(infos) if name in set(info['gt_names'])],
            np.int64) for name in self.class_names}
        total = sum(len(v) for v in frames_with.values())
        if total == 0:
            return infos
        picked = []
        for name, idxs in frames_with.items():
            if len(idxs) == 0:
                continue
            n_take = int(round(total / len(self.class_names)))
            picked.append(np.random.choice(idxs, n_take, replace=True))
        order = np.concatenate(picked) if picked else np.arange(len(infos))
        return [infos[i] for i in order]

    def _read_sweep_points(self, rel_path) -> np.ndarray:
        """One sweep file -> (N, 4) xyzi (nuScenes stores 5 floats/point)."""
        raw = np.fromfile(str(self.root_path / rel_path), dtype=np.float32)
        return raw.reshape(-1, 5)[:, :4]

    def get_lidar_with_sweeps(self, index, max_sweeps=1) -> np.ndarray:
        """Key-frame points + up to max_sweeps-1 past sweeps (drawn without
        replacement), moved into the key frame by their `transform_matrix`,
        with a per-point time-lag channel appended -> (N, 5) float32."""
        info = self.infos[index]
        chunks = [self._read_sweep_points(info['lidar_path'])]
        lags = [0.0]
        n_extra = min(max_sweeps - 1, len(info['sweeps']))
        for k in np.random.choice(len(info['sweeps']), n_extra, replace=False):
            sweep = info['sweeps'][k]
            pts = self._read_sweep_points(sweep['lidar_path'])
            tm = sweep['transform_matrix']
            if tm is not None:
                pts[:, :3] = pts[:, :3] @ tm[:3, :3].T + tm[:3, 3]
            chunks.append(pts)
            lags.append(float(sweep['time_lag']))
        xyzi = np.concatenate(chunks, axis=0)
        time_col = np.repeat(np.array(lags, np.float32),
                             [len(c) for c in chunks])[:, None]
        return np.concatenate([xyzi, time_col], axis=1)

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, index):
        info = copy.deepcopy(self.infos[index])
        points = self.get_lidar_with_sweeps(
            index, max_sweeps=self.dataset_cfg.get('MAX_SWEEPS', 1))
        input_dict = {'points': points,
                      'frame_id': Path(info['lidar_path']).stem,
                      'metadata': {'token': info['token']}}
        if 'gt_boxes' in info:
            input_dict.update({'gt_names': info['gt_names'],
                               'gt_boxes': info['gt_boxes']})
        data_dict = self.prepare_data(data_dict=input_dict)
        if data_dict is None:
            return self.__getitem__(np.random.randint(len(self)))
        if self.dataset_cfg.get('SET_NAN_VELOCITY_TO_ZEROS', False) \
                and 'gt_boxes' in data_dict:
            gt = data_dict['gt_boxes']
            gt[np.isnan(gt)] = 0
            data_dict['gt_boxes'] = gt
        if not self.dataset_cfg.get('PRED_VELOCITY', False) \
                and 'gt_boxes' in data_dict \
                and data_dict['gt_boxes'].shape[-1] > 8:
            # drop the velocity columns, keep [x..heading, class]
            data_dict['gt_boxes'] = data_dict['gt_boxes'][
                :, [0, 1, 2, 3, 4, 5, 6, -1]]
        return data_dict

    @staticmethod
    def generate_prediction_dicts(batch_dict, pred_dicts, class_names, output_path=None):
        """One anno per sample: the kept detections' names, boxes and
        scores, with the sample's `frame_id` and `metadata`."""
        annos = []
        for index, box_dict in enumerate(pred_dicts):
            mask = np.asarray(box_dict.get('pred_mask'))
            boxes = np.asarray(box_dict['pred_boxes'])[mask]
            scores = np.asarray(box_dict['pred_scores'])[mask]
            labels = np.asarray(box_dict['pred_labels'])[mask].astype(np.int64)
            annos.append({
                'frame_id': batch_dict['frame_id'][index],
                'name': np.array(class_names)[np.clip(labels - 1, 0, len(class_names) - 1)],
                'boxes_lidar': boxes, 'score': scores,
                'metadata': batch_dict.get('metadata', [None] * (index + 1))[index],
            })
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        """nuScenes detection metrics (mAP, the TP errors, NDS) of
        `det_annos` against the infos' ground truth, by the devkit-free
        protocol of `nuscenes_eval.py`. Returns (report, metrics)."""
        from .nuscenes_eval import evaluate_nuscenes
        gt_annos = []
        for info in self.infos:
            names = np.asarray(info.get('gt_names', np.zeros(0, dtype='<U16')))
            boxes = np.asarray(info.get('gt_boxes', np.zeros((0, 7))))
            gt_annos.append({'name': names, 'boxes_3d': boxes})
        preds = []
        for a in det_annos:
            preds.append({'name': np.asarray(a.get('name', [])),
                          'boxes_3d': np.asarray(a.get(
                              'boxes_3d', a.get('boxes_lidar', np.zeros((0, 7))))),
                          'score': np.asarray(a.get('score', []))})
        return evaluate_nuscenes(gt_annos, preds, list(class_names))
