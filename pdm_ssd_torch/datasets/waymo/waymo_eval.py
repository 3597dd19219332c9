"""Waymo-protocol detection metrics (AP / APH, LEVEL_1 / LEVEL_2), devkit-free
(copy of `pdm_ssd_tpu/datasets/waymo/waymo_eval.py`).

The published protocol, as the JAX package implements it:

- per-class 3D IoU thresholds (Vehicle 0.7, Pedestrian/Cyclist 0.5);
- LEVEL_1 = ground truths with > 5 lidar points, LEVEL_2 = >= 1 point
  (LEVEL_2 metrics count every GT; L1-only predictions are shared);
- per-frame Hungarian matching maximizing total IoU among pairs above the
  threshold (scipy linear_sum_assignment);
- AP from the score-ordered PR curve with 101-point interpolation;
- APH: true positives weighted by heading accuracy
  1 - |wrap(theta_p - theta_g)| / pi.
"""
from __future__ import annotations

import numpy as np

from ...utils import np_iou

IOU_THRESHOLD = {'Vehicle': 0.7, 'Car': 0.7, 'Pedestrian': 0.5,
                 'Cyclist': 0.5, 'Sign': 0.5}


def _iou3d(gt, pred):
    """Plain 3D IoU (no heading gate): rotated-BEV overlap x height overlap
    / union, in float64 (a copy of the JAX package's Lyft `_iou3d`, on the
    port's `rect_overlap_cpu`, which the KITTI evaluator also uses)."""
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


def _wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def _match_frame(gt_boxes, pred_boxes, iou_thr):
    """Hungarian matching maximizing total IoU over pairs above threshold.
    Returns list of (gt_i, pred_j, iou)."""
    if len(gt_boxes) == 0 or len(pred_boxes) == 0:
        return []
    from scipy.optimize import linear_sum_assignment
    iou = _iou3d(gt_boxes, pred_boxes)
    cost = np.where(iou > iou_thr, -iou, 0.0)
    rows, cols = linear_sum_assignment(cost)
    return [(i, j, iou[i, j]) for i, j in zip(rows, cols)
            if iou[i, j] > iou_thr]


def evaluate_waymo(gt_annos, pred_annos, class_names):
    """gt_annos: per sample {'name', 'boxes_3d' (N, 7), 'num_points_in_gt'};
    pred_annos: {'name', 'boxes_3d', 'score'}. Returns (str, dict) with
    AP/APH at LEVEL_1 and LEVEL_2 per class."""
    metrics = {}
    for cls in class_names:
        thr = IOU_THRESHOLD.get(cls, 0.5)
        for level in (1, 2):
            records = []          # (score, is_tp, heading_acc)
            n_gt = 0
            for g, p in zip(gt_annos, pred_annos):
                gmask = np.asarray(g['name']) == cls
                gb = np.asarray(g['boxes_3d'], np.float64)[gmask]
                if 'num_points_in_gt' in g:
                    npts = np.asarray(g['num_points_in_gt'])[gmask]
                else:  # unknown point counts: treat every gt as LEVEL_1
                    npts = np.full(int(gmask.sum()), 6)
                in_level = npts > 5 if level == 1 else npts >= 1
                n_gt += int(in_level.sum())

                pmask = np.asarray(p['name']) == cls
                pb = np.asarray(p['boxes_3d'], np.float64)[pmask]
                ps = np.asarray(p['score'])[pmask]
                matches = _match_frame(gb, pb, thr)
                matched_pred = {j for _i, j, _ in matches}
                for (i, j, iou) in matches:
                    if in_level[i]:
                        ha = 1.0 - abs(_wrap(pb[j, 6] - gb[i, 6])) / np.pi
                        records.append((ps[j], 1, ha))
                    # match to an out-of-level gt: ignored (neither TP nor FP)
                for j in range(len(pb)):
                    if j not in matched_pred:
                        records.append((ps[j], 0, 0.0))

            key = f'{cls}_L{level}'
            if n_gt == 0 or not records:
                metrics[f'{key}_AP'] = 0.0
                metrics[f'{key}_APH'] = 0.0
                continue
            records.sort(key=lambda r: -r[0])
            tp = np.cumsum([r[1] for r in records])
            tph = np.cumsum([r[1] * r[2] for r in records])
            fp = np.cumsum([1 - r[1] for r in records])
            rec = tp / n_gt
            prec = tp / np.maximum(tp + fp, 1)
            prec_h = tph / np.maximum(tp + fp, 1)

            def interp_ap(r, p_vals):
                ap = 0.0
                for rr in np.linspace(0, 1, 101):
                    sel = p_vals[r >= rr]
                    ap += (sel.max() if len(sel) else 0.0) / 101
                return float(ap)

            metrics[f'{key}_AP'] = interp_ap(rec, prec)
            metrics[f'{key}_APH'] = interp_ap(rec, prec_h)
    for level in (1, 2):
        for kind in ('AP', 'APH'):
            vals = [metrics[f'{c}_L{level}_{kind}'] for c in class_names]
            metrics[f'mean_L{level}_{kind}'] = float(np.mean(vals))
    return '\n'.join(f'{k}: {v:.4f}' for k, v in metrics.items()), metrics
