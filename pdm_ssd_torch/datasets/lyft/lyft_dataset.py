"""Lyft Level-5 dataset (copy of `pdm_ssd_tpu/datasets/lyft/lyft_dataset.py`,
in the structure of `pcdet/datasets/lyft/lyft_dataset.py`).

Info-pickle driven loading (`lyft_utils.create_lyft_infos` writes the
pickles from the raw JSON tables without the devkit). The evaluation is the
Lyft competition metric: per-class AP averaged over the 3D-IoU thresholds
0.5:0.05:0.95 with greedy score-ordered matching (the reference wraps
`lyft_mAP_eval/lyft_eval.py`).
"""
from __future__ import annotations

import copy
import pickle

import numpy as np

from ..dataset import DatasetTemplate
from ...utils import np_iou


class LyftDataset(DatasetTemplate):
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
            self.logger.info('Total samples for Lyft dataset: %d' % len(self.infos))

    def __len__(self):
        return len(self.infos)

    def get_lidar(self, info):
        path = self.root_path / info['lidar_path']
        points = np.fromfile(str(path), dtype=np.float32).reshape(-1, 5)
        return points[:, :4]

    def __getitem__(self, index):
        info = copy.deepcopy(self.infos[index])
        input_dict = {'points': self.get_lidar(info),
                      'frame_id': info.get('token', index)}
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
        annos = []
        for index, box_dict in enumerate(pred_dicts):
            mask = np.asarray(box_dict.get('pred_mask'))
            boxes = np.asarray(box_dict['pred_boxes'])[mask]
            scores = np.asarray(box_dict['pred_scores'])[mask]
            labels = np.asarray(box_dict['pred_labels'])[mask].astype(np.int64)
            annos.append({
                'frame_id': batch_dict['frame_id'][index],
                'name': np.array(class_names)[
                    np.clip(labels - 1, 0, len(class_names) - 1)],
                'boxes_3d': boxes, 'score': scores})
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        gt_annos = [{'name': np.asarray(i.get('gt_names', [])),
                     'boxes_3d': np.asarray(i.get('gt_boxes', np.zeros((0, 7))))}
                    for i in self.infos]
        return lyft_map(gt_annos, det_annos, class_names)


def lyft_map(gt_annos, pred_annos, class_names,
             iou_thresholds=tuple(np.arange(0.5, 1.0, 0.05))):
    """Lyft competition mAP: AP averaged over 3D-IoU thresholds per class."""
    metrics = {}
    for cls in class_names:
        aps = []
        for thr in iou_thresholds:
            tp_fp = []
            n_gt = 0
            for g, p in zip(gt_annos, pred_annos):
                gmask = np.asarray(g['name']) == cls
                gb = np.asarray(g['boxes_3d'])[gmask]
                n_gt += len(gb)
                pmask = np.asarray(p['name']) == cls
                pb = np.asarray(p['boxes_3d'])[pmask]
                ps = np.asarray(p['score'])[pmask]
                if len(pb) == 0:
                    continue
                iou = _iou3d(gb, pb) if len(gb) else np.zeros((0, len(pb)))
                taken = np.zeros(len(gb), bool)
                for j in np.argsort(-ps):
                    best = -1
                    if iou.shape[0]:
                        cand = np.where(~taken, iou[:, j], -1.0)
                        best = int(cand.argmax())
                        if cand[best] <= thr:
                            best = -1
                    if best >= 0:
                        taken[best] = True
                        tp_fp.append((ps[j], 1))
                    else:
                        tp_fp.append((ps[j], 0))
            if n_gt == 0:
                continue
            tp_fp.sort(key=lambda t: -t[0])
            flags = np.asarray([t[1] for t in tp_fp])
            tp = np.cumsum(flags)
            rec = tp / n_gt
            prec = tp / np.arange(1, len(flags) + 1)
            # standard 101-pt interpolated AP
            ap = 0.0
            for r in np.linspace(0, 1, 101):
                pr = prec[rec >= r]
                ap += (pr.max() if len(pr) else 0.0) / 101
            aps.append(ap)
        metrics[f'{cls}_AP'] = float(np.mean(aps)) if aps else 0.0
    metrics['mAP'] = float(np.mean([metrics[f'{c}_AP'] for c in class_names]))
    return '\n'.join(f'{k}: {v:.4f}' for k, v in metrics.items()), metrics


def _iou3d(gt, pred):
    """Plain 3D IoU (no heading gate — the Lyft metric matches by overlap
    only): rotated-BEV overlap x height overlap / union."""
    gt = np.asarray(gt, np.float64)
    pred = np.asarray(pred, np.float64)
    inter_2d = np_iou.rect_overlap_cpu(gt[:, [0, 1, 3, 4, 6]],
                                       pred[:, [0, 1, 3, 4, 6]])
    g_hi, g_lo = gt[:, [2]] + gt[:, [5]] / 2, gt[:, [2]] - gt[:, [5]] / 2
    p_hi, p_lo = pred[:, [2]] + pred[:, [5]] / 2, pred[:, [2]] - pred[:, [5]] / 2
    ih = np.clip(np.minimum(g_hi, p_hi.T) - np.maximum(g_lo, p_lo.T), 0, None)
    inter = inter_2d * ih
    vg = (gt[:, 3] * gt[:, 4] * gt[:, 5])[:, None]
    vp = (pred[:, 3] * pred[:, 4] * pred[:, 5])[None, :]
    return inter / np.clip(vg + vp - inter, 1e-9, None)
