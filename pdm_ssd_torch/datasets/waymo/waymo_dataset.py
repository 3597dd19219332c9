"""Waymo Open Dataset, the sequence data path (copy of
`pdm_ssd_tpu/datasets/waymo/waymo_dataset.py`).

Info-pkl driven loading of pre-extracted per-frame lidar `.npy` files
(`%s/%04d.npy` under `waymo_processed_data`), sampled-interval splits, the
multi-frame sequence path of MPPNet (pose composition, the timestamp
column, offline stage-1 proposals in fixed (T, R, 11) slots, the
fixed-shape frame stack), prediction dicts, the devkit-free AP/APH
evaluation (`waymo_eval.py`) and the GT database. Every draw from
`np.random` is the JAX package's, in its order, so one seed gives the same
samples in both packages.
"""
from __future__ import annotations

import copy
import pickle
from pathlib import Path

import numpy as np

from ..dataset import DatasetTemplate


class WaymoDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger)
        self.data_path = self.root_path / self.dataset_cfg.get(
            'PROCESSED_DATA_TAG', 'waymo_processed_data')
        self.split = self.dataset_cfg.DATA_SPLIT[self.mode]
        split_file = self.root_path / 'ImageSets' / (self.split + '.txt')
        self.sample_sequence_list = [x.strip() for x in open(split_file).readlines()] \
            if split_file.exists() else []
        self.infos = []
        self.seq_name_to_infos = self.include_waymo_data(self.mode)
        if self.dataset_cfg.get('USE_PREDBOX', False):
            self.pred_boxes_dict = self.load_pred_boxes_to_dict(
                self.dataset_cfg.ROI_BOXES_PATH[self.mode])
        else:
            self.pred_boxes_dict = {}

    @property
    def _seq_cfg(self):
        cfg = self.dataset_cfg.get('SEQUENCE_CONFIG', None)
        return cfg if cfg is not None and cfg.get('ENABLED', False) else None

    def include_waymo_data(self, mode):
        waymo_infos = []
        seq_name_to_infos = {}
        for seq_name in self.sample_sequence_list:
            info_path = self.data_path / seq_name / (f'{seq_name}.pkl')
            if not info_path.exists():
                continue
            with open(info_path, 'rb') as f:
                infos = pickle.load(f)
            waymo_infos.extend(infos)
            if infos:
                # full per-sequence index (pre interval-sampling) so the
                # sequence path can resolve any previous frame
                seq_name_to_infos[
                    infos[0]['point_cloud']['lidar_sequence']] = infos
        interval = self.dataset_cfg.get('SAMPLED_INTERVAL', {}).get(
            'train' if mode == 'train' else 'test', 1)
        if interval > 1:
            waymo_infos = waymo_infos[::interval]
        self.infos.extend(waymo_infos)
        if self.logger is not None:
            self.logger.info('Total samples for Waymo dataset: %d' % len(waymo_infos))
        return seq_name_to_infos if self._seq_cfg is not None else None

    def load_pred_boxes_to_dict(self, pred_boxes_path):
        """Offline stage-1 proposals, reorganized {seq: {sample_idx: (N, 11)
        [x,y,z,dx,dy,dz,heading,vx,vy,score,label]}} (reference
        `waymo_dataset.py:94-112`)."""
        with open(pred_boxes_path, 'rb') as f:
            pred_dicts = pickle.load(f)
        out = {}
        for box_dict in pred_dicts:
            seq_name = box_dict['frame_id'][:-4].replace(
                'training_', '').replace('validation_', '')
            sample_idx = int(box_dict['frame_id'][-3:])
            labels = np.array([self.class_names.index(n) + 1
                               for n in box_dict['name']], np.float32)
            boxes = np.concatenate(
                [box_dict['boxes_lidar'][:, :9],
                 np.asarray(box_dict['score'], np.float32)[:, None],
                 labels[:, None]], axis=-1)
            out.setdefault(seq_name, {})[sample_idx] = boxes
        if self.logger is not None:
            self.logger.info(
                f'Loaded pred boxes for {len(out)} sequences '
                f'from {pred_boxes_path}')
        return out

    @staticmethod
    def transform_prebox_to_current(pred_boxes3d, pose_pre, pose_cur):
        """Re-express previous-frame boxes (N, 9|11) in the current ego
        frame: centers through pose_pre then inv(pose_cur); velocities by
        the rotation parts; heading by the yaw delta (reference
        `waymo_dataset.py:211-239`)."""
        assert pred_boxes3d.shape[-1] in (9, 11)
        out = pred_boxes3d.copy()
        ones = np.ones((len(out), 1))
        centers_global = (np.concatenate([out[:, :3], ones], -1)
                          @ pose_pre.T)[:, :3]
        out[:, :3] = (np.concatenate([centers_global, ones], -1)
                      @ np.linalg.inv(pose_cur.T))[:, :3]
        if out.shape[-1] == 11:
            vel3 = np.concatenate([out[:, 7:9], np.zeros((len(out), 1))], -1)
            vel_global = vel3 @ pose_pre[:3, :3].T
            out[:, 7:9] = (vel_global
                           @ np.linalg.inv(pose_cur[:3, :3].T))[:, :2]
        out[:, 6] += np.arctan2(pose_pre[1, 0], pose_pre[0, 0])
        out[:, 6] -= np.arctan2(pose_cur[1, 0], pose_cur[0, 0])
        return out

    def get_sequence_data(self, info, points, sequence_name, sample_idx,
                          sequence_cfg, load_pred_boxes=False):
        """Pose-compose SAMPLE_OFFSET previous frames into the current ego
        frame with a trailing timestamp feature (0.1 s per frame), remove
        ego-radius points, and (optionally) stack per-frame offline
        proposals into FIXED (T, R, 11) slots (reference
        `waymo_dataset.py:250-337`; the reference returns ragged
        concatenations + counts — here raggedness is handled downstream by
        the fixed-shape frame split, see `_stack_frames_fixed`)."""
        def remove_ego_points(pts, center_radius=1.0):
            return pts[~((np.abs(pts[:, 0]) < center_radius)
                         & (np.abs(pts[:, 1]) < center_radius))]

        pose_cur = np.asarray(info['pose']).reshape(4, 4)
        off0, off1 = sequence_cfg.SAMPLE_OFFSET
        sample_idx_pre_list = np.clip(
            sample_idx + np.arange(off0, off1), 0, 0x7FFFFFFF)[::-1]
        num_pts_cur = points.shape[0]
        points = np.hstack(
            [points, np.zeros((num_pts_cur, 1), points.dtype)])
        seq_infos = self.seq_name_to_infos[sequence_name]

        def load_pred(idx):
            boxes = self.pred_boxes_dict[
                sequence_name.replace('training_', '').replace(
                    'validation_', '')][idx].copy()
            # speed -> negative motion from t to t-1 (reference :266-272)
            boxes[:, 7:9] = -0.1 * boxes[:, 7:9]
            return boxes

        points_pre_all, num_points_pre, pose_all = [], [], [pose_cur]
        pred_boxes_all = [load_pred(sample_idx)] if load_pred_boxes else []
        for idx_offset, sample_idx_pre in enumerate(sample_idx_pre_list):
            points_pre = self.get_lidar(sequence_name, int(sample_idx_pre))
            pose_pre = np.asarray(
                seq_infos[int(sample_idx_pre)]['pose']).reshape(4, 4)
            ones = np.ones((len(points_pre), 1))
            xyz_global = (np.concatenate([points_pre[:, :3], ones], -1)
                          @ pose_pre.T)[:, :3]
            xyz_cur = (np.concatenate([xyz_global, ones], -1)
                       @ np.linalg.inv(pose_cur.T))[:, :3]
            ts = 0.1 * (sample_idx - sample_idx_pre)
            points_pre = np.concatenate(
                [xyz_cur, points_pre[:, 3:],
                 np.full((len(points_pre), 1), ts, points_pre.dtype)], -1)
            points_pre = remove_ego_points(points_pre, 1.0)
            points_pre_all.append(points_pre)
            num_points_pre.append(len(points_pre))
            pose_all.append(pose_pre)
            if load_pred_boxes:
                pred_boxes_all.append(self.transform_prebox_to_current(
                    load_pred(int(sample_idx_pre)), pose_pre, pose_cur))

        points = np.concatenate([points] + points_pre_all,
                                axis=0).astype(np.float32)
        num_points_all = np.array([num_pts_cur] + num_points_pre, np.int32)
        poses = np.stack(pose_all, axis=0).astype(np.float32)  # (T, 4, 4)

        if load_pred_boxes:
            R = int(sequence_cfg.get('MAX_PRED_BOXES', 96))
            T = len(pred_boxes_all)
            stacked = np.zeros((T, R, 11), np.float32)
            for t, pb in enumerate(pred_boxes_all):
                n = min(len(pb), R)
                stacked[t, :n] = pb[:n]
            pred_boxes = stacked[:, :, 0:9]
            pred_scores = stacked[:, :, 9]
            pred_labels = stacked[:, :, 10]
        else:
            pred_boxes = pred_scores = pred_labels = None
        return (points, num_points_all, sample_idx_pre_list, poses,
                pred_boxes, pred_scores, pred_labels)

    @staticmethod
    def _stack_frames_fixed(points, timestamps, n_per_frame, training):
        """Fixed-shape (T, N_f, C) frame stack from the processed
        concatenated cloud: frame t = points whose trailing timestamp equals
        timestamps[t], subsampled (train: random, eval: first-N) or
        duplicated up to N_f. Frames with zero surviving points get a far
        sentinel so box crops never see them. Fixed-shape replacement for the
        reference's ragged (points, num_points_all) pair."""
        ts_col = points[:, -1]
        C = points.shape[-1]
        out = np.zeros((len(timestamps), n_per_frame, C), np.float32)
        for t, ts in enumerate(timestamps):
            sel = points[np.abs(ts_col - ts) < 0.05]
            n = len(sel)
            if n == 0:
                out[t, :, :3] = 1e4
                continue
            if n >= n_per_frame:
                idx = (np.random.choice(n, n_per_frame, replace=False)
                       if training else np.arange(n_per_frame))
            else:
                idx = np.concatenate([np.arange(n), np.random.choice(
                    n, n_per_frame - n, replace=True)])
            out[t] = sel[idx]
        return out

    def get_lidar(self, sequence_name, sample_idx):
        lidar_file = self.data_path / sequence_name / ('%04d.npy' % sample_idx)
        point_features = np.load(lidar_file)  # (N, 6): x, y, z, intensity, elongation, NLZ
        points_all, NLZ_flag = point_features[:, 0:5], point_features[:, 5]
        if not self.dataset_cfg.get('DISABLE_NLZ_FLAG_ON_POINTS', False):
            points_all = points_all[NLZ_flag == -1]
        points_all[:, 3] = np.tanh(points_all[:, 3])  # intensity normalization
        return points_all

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, index):
        info = copy.deepcopy(self.infos[index])
        pc_info = info['point_cloud']
        sequence_name = pc_info['lidar_sequence']
        sample_idx = pc_info['sample_idx']
        points = self.get_lidar(sequence_name, sample_idx)
        input_dict = {'points': points,
                      'frame_id': info.get('frame_id', f'{sequence_name}_{sample_idx}')}
        seq_cfg = self._seq_cfg
        use_predbox = bool(self.dataset_cfg.get('USE_PREDBOX', False))
        sample_idx_pre_list = None
        if seq_cfg is not None:
            (points, num_points_all, sample_idx_pre_list, poses, pred_boxes,
             pred_scores, pred_labels) = self.get_sequence_data(
                info, points, sequence_name, sample_idx, seq_cfg,
                load_pred_boxes=use_predbox)
            input_dict['points'] = points
            input_dict['poses'] = poses
            if use_predbox:
                input_dict.update({'roi_boxes': pred_boxes,
                                   'roi_scores': pred_scores,
                                   'roi_labels': pred_labels})
        if 'annos' in info:
            annos = info['annos']
            mask = annos['name'] != 'unknown' if 'name' in annos else None
            gt_boxes = annos['gt_boxes_lidar']
            gt_names = annos['name']
            if mask is not None:
                gt_boxes = gt_boxes[mask]
                gt_names = gt_names[mask]
            if gt_boxes.shape[-1] == 9 and not self.dataset_cfg.get('USE_VELOCITY', False):
                gt_boxes = gt_boxes[:, 0:7]
            input_dict.update({'gt_names': gt_names, 'gt_boxes': gt_boxes})
        data_dict = self.prepare_data(data_dict=input_dict)
        if data_dict is None:
            return self.__getitem__(np.random.randint(len(self)))
        if seq_cfg is not None:
            # frame split AFTER prepare_data so world augmentations apply to
            # the concatenated cloud once and every frame stays consistent.
            # Actual timestamps (clipped early-sequence frames repeat the
            # oldest one) — bucketed by the trailing ts feature.
            timestamps = [0.0] + [0.1 * (sample_idx - int(p))
                                  for p in sample_idx_pre_list]
            T = len(timestamps)
            n_f = int(seq_cfg.get(
                'NUM_POINTS_PER_FRAME',
                max(1, len(data_dict['points']) // T)))
            data_dict['points_multi_frame'] = self._stack_frames_fixed(
                data_dict['points'], timestamps, n_f, self.training)
        data_dict['metadata'] = info.get('metadata', {})
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
                'boxes_lidar': boxes, 'score': scores,
                'metadata': batch_dict.get('metadata', [{}] * (index + 1))[index],
            })
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        """Waymo-protocol AP/APH at LEVEL_1/LEVEL_2 via the devkit-free
        implementation (`waymo_eval.py`); the reference defers to the Waymo
        TF op (`pcdet/datasets/waymo/waymo_eval.py:23`), absent here."""
        from .waymo_eval import evaluate_waymo
        gt_annos = []
        for info in self.infos:
            annos = info.get('annos', {})
            gt_annos.append({
                'name': np.asarray(annos.get('name', np.zeros(0, dtype='<U16'))),
                'boxes_3d': np.asarray(annos.get(
                    'gt_boxes_lidar', np.zeros((0, 7))))[:, :7],
                'num_points_in_gt': np.asarray(annos.get(
                    'num_points_in_gt', np.zeros(0, np.int64))),
            })
        preds = [{'name': np.asarray(a.get('name', [])),
                  'boxes_3d': np.asarray(a.get(
                      'boxes_3d', a.get('boxes_lidar', np.zeros((0, 7)))))[:, :7],
                  'score': np.asarray(a.get('score', []))}
                 for a in det_annos]
        return evaluate_waymo(gt_annos, preds, list(class_names))

    # ---- the GT database (`pcdet/datasets/waymo/waymo_dataset.py:400-560`) ----

    def create_groundtruth_database(self, info_path, save_path,
                                    used_classes=None, split='train'):
        """Per-object point crops + dbinfos pkl for GT sampling
        (`waymo_dataset.py:create_groundtruth_database`); devkit-free (runs
        on extracted npy data)."""
        from ..kitti import kitti_utils
        save_path = Path(save_path)
        db_save_path = save_path / f'gt_database_{split}'
        db_info_save_path = save_path / f'waymo_dbinfos_{split}.pkl'
        db_save_path.mkdir(parents=True, exist_ok=True)
        with open(info_path, 'rb') as f:
            infos = pickle.load(f)
        all_db_infos = {}
        for k, info in enumerate(infos):
            pc = info['point_cloud']
            seq, idx = pc['lidar_sequence'], pc['sample_idx']
            points = self.get_lidar(seq, idx)
            annos = info.get('annos')
            if annos is None or len(annos['name']) == 0:
                continue
            boxes = annos['gt_boxes_lidar'][:, :7]
            inside = kitti_utils.points_in_boxes_cpu(
                points[:, :3], boxes).T.astype(bool)
            for i, name in enumerate(annos['name']):
                if used_classes is not None and name not in used_classes:
                    continue
                gt_pts = points[inside[:, i]]
                gt_pts = gt_pts.copy()
                gt_pts[:, :3] -= boxes[i, :3]
                fname = f'{seq}_{idx:04d}_{name}_{i}.bin'
                gt_pts.astype(np.float32).tofile(db_save_path / fname)
                db_info = {'name': name,
                           'path': str(Path(db_save_path.name) / fname),
                           'sequence_name': seq, 'sample_idx': idx,
                           'gt_idx': i, 'box3d_lidar': boxes[i],
                           'num_points_in_gt': int(inside[:, i].sum()),
                           'difficulty': int(annos['difficulty'][i])
                           if 'difficulty' in annos else 0}
                all_db_infos.setdefault(name, []).append(db_info)
        with open(db_info_save_path, 'wb') as f:
            pickle.dump(all_db_infos, f)
        return all_db_infos

