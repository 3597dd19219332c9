"""Official ONCE AP, numba-free (copy of
`pdm_ssd_tpu/datasets/once/once_eval.py`, numpy only).

Protocol of `pcdet/datasets/once/once_eval/evaluation.py:26-419` (the ONCE
benchmark server's evaluation): rotated-BEV x height 3D IoU with the
heading gate, per-class IoU thresholds (superclass merging of Car/Bus/Truck
into 'Vehicle'), 'Overall&Distance' difficulty buckets, the 50-point
interpolated PR curve with the reference's threshold selection, and the same
greedy highest-score / highest-IoU matcher.

The threshold axis is vectorized: one pass over the GT list per sample
carries all 51 score thresholds at once as (T, num_pred) state, and the IoU
matrix comes from the host rotated IoU (`utils/np_iou.py`). The JAX
package's copy is the only reference the port's is held to (the CUDA
reference's evaluator is absent from the test machines).
"""
from __future__ import annotations

import numpy as np

from ...utils import np_iou

IOU_THRESHOLD = {'Car': 0.7, 'Bus': 0.7, 'Truck': 0.7,
                 'Pedestrian': 0.3, 'Cyclist': 0.5}
SUPER_IOU_THRESHOLD = {'Vehicle': 0.7, 'Pedestrian': 0.3, 'Cyclist': 0.5}


def iou3d_with_heading(gt_boxes: np.ndarray, pred_boxes: np.ndarray) -> np.ndarray:
    """(N, 7) x (M, 7) -> (N, M); reference `iou3d_kernel_with_heading:346-382`
    (3D IoU with intersection-over-*union* BEV criterion, zeroed when the
    heading difference exceeds pi/2)."""
    if len(gt_boxes) == 0 or len(pred_boxes) == 0:
        return np.zeros((len(gt_boxes), len(pred_boxes)))
    inter_2d = np_iou.rect_overlap_cpu(gt_boxes[:, [0, 1, 3, 4, 6]],
                                       pred_boxes[:, [0, 1, 3, 4, 6]])
    gt_max = gt_boxes[:, [2]] + gt_boxes[:, [5]] * 0.5
    gt_min = gt_boxes[:, [2]] - gt_boxes[:, [5]] * 0.5
    pr_max = pred_boxes[:, [2]] + pred_boxes[:, [5]] * 0.5
    pr_min = pred_boxes[:, [2]] - pred_boxes[:, [5]] * 0.5
    inter_h = np.clip(np.minimum(gt_max, pr_max.T) - np.maximum(gt_min, pr_min.T),
                      0, None)
    inter_3d = inter_2d * inter_h
    vol_g = (gt_boxes[:, 3] * gt_boxes[:, 4] * gt_boxes[:, 5])[:, None]
    vol_p = (pred_boxes[:, 3] * pred_boxes[:, 4] * pred_boxes[:, 5])[None, :]
    iou = inter_3d / (vol_g + vol_p - inter_3d)
    diff = np.abs(gt_boxes[:, [6]] - pred_boxes[:, [6]].T)
    diff = np.where(diff >= np.pi, 2 * np.pi - diff, diff)
    iou[diff > np.pi / 2] = 0.0
    return iou


def _filter_flags(names, boxes, class_name, difficulty_mode, level,
                  use_superclass):
    """-1 rejected (other class), 1 ignored (difficulty), 0 accepted
    (reference `filter_data:258-313`)."""
    names = np.asarray(names)
    flag = np.zeros(len(names), np.int64)
    if use_superclass and class_name == 'Vehicle':
        reject = (names == 'Pedestrian') | (names == 'Cyclist')
    else:
        reject = names != class_name
    flag[reject] = -1
    dist = np.sqrt(np.sum(boxes[:, 0:3] ** 2, axis=1)) if len(boxes) else \
        np.zeros(0)
    if difficulty_mode == 'Overall':
        keep = np.ones(len(names), bool)
    elif difficulty_mode == 'Distance':
        keep = [dist < 30, (dist >= 30) & (dist < 50), dist >= 50][level]
    else:  # Overall&Distance
        keep = [np.ones(len(names), bool), dist < 30,
                (dist >= 30) & (dist < 50), dist >= 50][level]
    flag[~keep & ~reject] = 1
    return flag


def _accumulate_scores(iou, pred_scores, gt_flag, pred_flag, iou_threshold):
    """Scores of true positives under greedy highest-score matching
    (reference `accumulate_scores:177-209`): per GT (in order) pick the
    unassigned same-class prediction with highest SCORE among IoU > thr."""
    assigned = np.zeros(len(pred_scores), bool)
    out = []
    cand_ok = pred_flag != -1
    for i in range(iou.shape[0]):
        if gt_flag[i] == -1:
            continue
        ok = cand_ok & ~assigned & (iou[i] > iou_threshold)
        if not ok.any():
            continue
        j = np.flatnonzero(ok)[np.argmax(pred_scores[ok])]
        if gt_flag[i] == 1 or pred_flag[j] == 1:
            assigned[j] = True
        else:
            out.append(pred_scores[j])
            assigned[j] = True
    return np.asarray(out)


def _get_thresholds(scores, num_gt, num_pr_points):
    """Reference `get_thresholds:153-174` verbatim protocol."""
    eps = 1e-6
    scores = np.sort(scores)[::-1]
    recall_level = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if (r_recall + l_recall < 2 * recall_level) and i < len(scores) - 1:
            continue
        thresholds.append(score)
        recall_level += 1 / num_pr_points
        while r_recall + l_recall + eps > 2 * recall_level:
            thresholds.append(score)
            recall_level += 1 / num_pr_points
    return thresholds


def _statistics_all_thresholds(iou, pred_scores, gt_flag, pred_flag,
                               thresholds, iou_threshold):
    """tp/fp/fn for ALL score thresholds at once (vectorized re-design of
    `compute_statistics:211-256`; the T-axis replaces the outer threshold
    loop — state `assigned` is (T, num_pred))."""
    T = len(thresholds)
    num_pred = len(pred_scores)
    thr = np.asarray(thresholds)[:, None]                 # (T, 1)
    under = pred_scores[None, :] < thr                    # (T, P)
    assigned = np.zeros((T, num_pred), bool)
    tp = np.zeros(T, np.int64)
    fp = np.zeros(T, np.int64)
    fn = np.zeros(T, np.int64)
    same = pred_flag != -1
    ignore_pred = pred_flag == 1
    for i in range(iou.shape[0]):
        if gt_flag[i] == -1:
            continue
        cand = same[None, :] & ~assigned & ~under & (iou[i][None, :] > iou_threshold)
        strict = cand & ~ignore_pred[None, :]
        has_strict = strict.any(1)
        # prefer the highest-IoU non-ignored match; else first ignored match
        iou_row = np.where(strict, iou[i][None, :], -1.0)
        j_strict = iou_row.argmax(1)
        ign = cand & ignore_pred[None, :]
        has_ign = ign.any(1)
        j_ign = ign.argmax(1)
        detected = has_strict | has_ign
        j = np.where(has_strict, j_strict, j_ign)
        matched_ignore = (gt_flag[i] == 1) | (~has_strict & has_ign)
        is_tp = detected & ~matched_ignore
        if gt_flag[i] == 0:
            fn += (~detected).astype(np.int64)
            tp += is_tp.astype(np.int64)
        assigned[np.arange(T), j] |= detected
    leftover = (~assigned & same[None, :] & ~ignore_pred[None, :] & ~under)
    fp = leftover.sum(1)
    return tp, fp, fn


def get_evaluation_results(gt_annos, pred_annos, classes, use_superclass=True,
                           iou_thresholds=None, num_pr_points=50,
                           difficulty_mode='Overall&Distance',
                           ap_with_heading=True):
    """Same API and output dict as the reference `get_evaluation_results:26`."""
    if iou_thresholds is None:
        iou_thresholds = SUPER_IOU_THRESHOLD if use_superclass else IOU_THRESHOLD
    assert len(gt_annos) == len(pred_annos)
    if use_superclass:
        classes = [c for c in classes if c not in ('Car', 'Bus', 'Truck')]
        classes.insert(0, 'Vehicle')

    ious = [iou3d_with_heading(np.asarray(g['boxes_3d'], np.float64),
                               np.asarray(p['boxes_3d'], np.float64))
            for g, p in zip(gt_annos, pred_annos)]

    if difficulty_mode == 'Distance':
        difficulty_types = ['0-30m', '30-50m', '50m-inf']
    elif difficulty_mode == 'Overall':
        difficulty_types = ['overall']
    else:
        difficulty_types = ['overall', '0-30m', '30-50m', '50m-inf']
    nd = len(difficulty_types)

    AP = np.zeros((len(classes), nd))
    ret = {}
    for ci, cls in enumerate(classes):
        iou_thr = iou_thresholds[cls]
        for di in range(nd):
            flags = [( _filter_flags(g['name'], np.asarray(g['boxes_3d']),
                                     cls, difficulty_mode, di, use_superclass),
                       _filter_flags(p['name'], np.asarray(p['boxes_3d']),
                                     cls, difficulty_mode, di, use_superclass))
                     for g, p in zip(gt_annos, pred_annos)]
            num_valid_gt = sum(int((gf == 0).sum()) for gf, _ in flags)
            if num_valid_gt == 0:
                continue
            accum = [
                _accumulate_scores(ious[s], np.asarray(pred_annos[s]['score']),
                                   flags[s][0], flags[s][1], iou_thr)
                for s in range(len(gt_annos))]
            all_scores = np.concatenate(accum) if accum else np.zeros(0)
            thresholds = _get_thresholds(all_scores.copy(), num_valid_gt,
                                         num_pr_points)
            if not thresholds:
                continue
            T = len(thresholds)
            tps = np.zeros(T, np.int64)
            fps = np.zeros(T, np.int64)
            fns = np.zeros(T, np.int64)
            for s in range(len(gt_annos)):
                tp, fp, fn = _statistics_all_thresholds(
                    ious[s], np.asarray(pred_annos[s]['score']),
                    flags[s][0], flags[s][1], thresholds, iou_thr)
                tps += tp
                fps += fp
                fns += fn
            prec = np.zeros(num_pr_points + 1)
            prec[:T] = tps / np.maximum(tps + fps, 1)
            # right-max interpolation (reference :139-143)
            for t in range(num_pr_points + 1):
                prec[t] = prec[t:].max() if t < len(prec) else 0.0
            AP[ci, di] = prec[1:].sum() / num_pr_points * 100

    for ci, cls in enumerate(classes):
        for di, dt in enumerate(difficulty_types):
            ret[f'AP_{cls}/{dt}'] = AP[ci, di]
    for di, dt in enumerate(difficulty_types):
        ret[f'AP_mean/{dt}'] = AP[:, di].mean()
    ret_str = '\n'.join(f'{k}: {v:.2f}' for k, v in ret.items())
    return ret_str, ret
