"""nuScenes dataset (copy of `pdm_ssd_tpu/datasets/nuscenes/nuscenes_dataset.py`).

Info-pkl driven; key frame plus past sweeps moved into the key frame's
LiDAR frame with a time-lag column; velocity-extended (9-dof) boxes whose
velocity columns are dropped unless PRED_VELOCITY; class-balanced resampling
(CBGS) in training; predictions turned into annos carrying each sample's
`metadata`; the devkit-free nuScenes metrics (`nuscenes_eval.py`). With
CAMERA_CONFIG (BEVFusion) each sample also holds its cameras' transforms
and images, read by `image_ops` (PNG only: the port carries no JPEG
decoder), resized and cropped to FINAL_DIM, each image's [resize, crop,
flip, rotate] recorded for `image_calibrate`. The draws (CBGS, the sweeps
taken, each image's resize and crop) use the global `np.random`, as the JAX
package does, so one seed gives both packages the same samples.
"""
from __future__ import annotations

import copy
import pickle
from pathlib import Path

import numpy as np

from .. import image_ops
from ..dataset import DatasetTemplate


class NuScenesDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        root_path = (root_path if root_path is not None
                     else Path(dataset_cfg.DATA_PATH)) / dataset_cfg.VERSION \
            if dataset_cfg.get('VERSION') else root_path
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger)
        self.infos = []
        self.camera_config = self.dataset_cfg.get('CAMERA_CONFIG', None)
        if self.camera_config is not None:
            self.use_camera = self.camera_config.get('USE_CAMERA', True)
            self.camera_image_config = self.camera_config.IMAGE
        else:
            self.use_camera = False
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

    def crop_image(self, input_dict):
        """Each image resized by a factor (training: `np.random.uniform(
        *RESIZE_LIM_TRAIN)`; test: the mean of RESIZE_LIM_TEST) and cropped to
        FINAL_DIM at the bottom (training: at a `np.random.uniform` column;
        test: centred); the draws an image in that order. Records
        `img_process_infos` [resize, crop, False, 0] an image."""
        W, H = input_dict['ori_shape']
        img_process_infos, crop_images = [], []
        fH, fW = self.camera_image_config.FINAL_DIM
        for img in input_dict['camera_imgs']:
            if self.training:
                resize = float(np.random.uniform(*self.camera_image_config.RESIZE_LIM_TRAIN))
                newW, newH = int(W * resize), int(H * resize)
                crop_h = newH - fH
                crop_w = int(np.random.uniform(0, max(0, newW - fW)))
            else:
                resize = float(np.mean(self.camera_image_config.RESIZE_LIM_TEST))
                newW, newH = int(W * resize), int(H * resize)
                crop_h = newH - fH
                crop_w = int(max(0, newW - fW) / 2)
            crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
            crop_images.append(image_ops.crop(image_ops.resize(img, (newW, newH)), crop))
            img_process_infos.append([resize, crop, False, 0])
        input_dict['img_process_infos'] = img_process_infos
        input_dict['camera_imgs'] = crop_images
        return input_dict

    @staticmethod
    def _quat_to_rotmat(q):
        """(w, x, y, z) quaternion -> (3, 3) rotation matrix."""
        w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])

    def load_camera_info(self, input_dict, info):
        """Each camera's transforms as (N_cam, 4, 4) float32 ('lidar2camera',
        'lidar2image', 'camera2ego', 'camera_intrinsics', 'camera2lidar'), its
        'image_paths', and its image (`image_ops.read_image`, uint8 RGB)
        resized and cropped by `crop_image`."""
        keys = ['image_paths', 'lidar2camera', 'lidar2image', 'camera2ego',
                'camera_intrinsics', 'camera2lidar']
        for k in keys:
            input_dict[k] = []
        for _, camera_info in info['cams'].items():
            input_dict['image_paths'].append(camera_info['data_path'])
            l2c_r = np.linalg.inv(camera_info['sensor2lidar_rotation'])
            l2c_t = camera_info['sensor2lidar_translation'] @ l2c_r.T
            l2c = np.eye(4, dtype=np.float32)
            l2c[:3, :3] = l2c_r.T
            l2c[3, :3] = -l2c_t
            input_dict['lidar2camera'].append(l2c.T)
            intr = np.eye(4, dtype=np.float32)
            intr[:3, :3] = camera_info['camera_intrinsics']
            input_dict['camera_intrinsics'].append(intr)
            input_dict['lidar2image'].append(intr @ l2c.T)
            c2e = np.eye(4, dtype=np.float32)
            c2e[:3, :3] = self._quat_to_rotmat(camera_info['sensor2ego_rotation'])
            c2e[:3, 3] = camera_info['sensor2ego_translation']
            input_dict['camera2ego'].append(c2e)
            c2l = np.eye(4, dtype=np.float32)
            c2l[:3, :3] = camera_info['sensor2lidar_rotation']
            c2l[:3, 3] = camera_info['sensor2lidar_translation']
            input_dict['camera2lidar'].append(c2l)
        for k in keys[1:]:
            input_dict[k] = np.stack(input_dict[k]).astype(np.float32)
        images = [image_ops.read_image(self.root_path / name)
                  for name in input_dict['image_paths']]
        input_dict['camera_imgs'] = images
        input_dict['ori_shape'] = (images[0].shape[1], images[0].shape[0])
        return self.crop_image(input_dict)

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
        if self.use_camera:
            input_dict = self.load_camera_info(input_dict, info)
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
