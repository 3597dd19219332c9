"""Argoverse 2 detection protocol (Composite Detection Score) without the
devkit (copy of `pdm_ssd_tpu/datasets/argo2/argo2_eval.py`).

The av2 devkit evaluation the reference wraps
(`pcdet/datasets/argo2/argo2_dataset.py:416-520`: av2
`evaluation.detection.eval.evaluate` + `DetectionCfg`), as published:

- matching: per frame and class, detections in score order greedily claim
  the nearest unmatched GT by 3D center euclidean distance, under each
  affinity threshold in {0.5, 1.0, 2.0, 4.0} m;
- AP: 100-sample interpolated precision/recall per threshold, averaged over
  thresholds;
- true-positive errors at the 2.0 m threshold: ATE (3D center distance, m),
  ASE (1 - aligned-axis IoU of co-centered boxes), AOE (wrapped absolute
  yaw difference, rad);
- CDS = AP * mean(1 - ATE/2, 1 - ASE, 1 - AOE/pi), errors clipped to their
  normalization bounds; classes with no true positives take the maximum
  error (the devkit's convention);
- GT and detections outside `max_range_m` (ego-centered) are dropped.
"""
from __future__ import annotations

import numpy as np

AFFINITY_THRESHOLDS_M = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD_M = 2.0
MAX_SCALE_ERROR = 1.0
MAX_YAW_ERROR = np.pi
MAX_RANGE_M = 150.0
N_RECALL_SAMPLES = 100


def _wrap_yaw(d):
    d = np.abs(d) % (2 * np.pi)
    return np.minimum(d, 2 * np.pi - d)


def _aligned_iou(dims_a, dims_b):
    """IoU of axis-aligned, co-centered boxes: (N, 3) dims each."""
    inter = np.prod(np.minimum(dims_a, dims_b), axis=-1)
    union = np.prod(dims_a, -1) + np.prod(dims_b, -1) - inter
    return inter / np.maximum(union, 1e-9)


def _match_frame(dt_boxes, dt_scores, gt_boxes, thresh):
    """Greedy score-ordered matching under one affinity threshold.

    Returns (tp flags per det in input order, matched gt index or -1)."""
    nd, ng = len(dt_boxes), len(gt_boxes)
    tp = np.zeros(nd, bool)
    match = np.full(nd, -1, np.int64)
    if nd == 0 or ng == 0:
        return tp, match
    dist = np.linalg.norm(dt_boxes[:, None, :3] - gt_boxes[None, :, :3],
                          axis=-1)                     # (nd, ng)
    taken = np.zeros(ng, bool)
    for i in np.argsort(-dt_scores, kind='stable'):
        d = np.where(taken, np.inf, dist[i])
        j = int(np.argmin(d))
        if d[j] < thresh:
            tp[i] = True
            match[i] = j
            taken[j] = True
    return tp, match


def _average_precision(scores, tp, n_gt):
    """av2-style 100-sample interpolated AP (recall grid linspace(0, 1))."""
    if n_gt == 0:
        return np.nan
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-scores, kind='stable')
    tp = tp[order].astype(np.float64)
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(1.0 - tp)
    recall = cum_tp / n_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-9)
    # monotone precision envelope (interpolated precision)
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    r_grid = np.linspace(0.0, 1.0, N_RECALL_SAMPLES)
    idx = np.searchsorted(recall, r_grid - 1e-12, side='left')
    p = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)],
                 0.0)
    return float(np.mean(p))


def evaluate_argo2(gt_annos, det_annos, class_names,
                   affinity_thresholds=AFFINITY_THRESHOLDS_M,
                   tp_threshold=TP_THRESHOLD_M, max_range=MAX_RANGE_M):
    """gt_annos / det_annos: one dict per frame, aligned.

    gt: {'name': (G,) str, 'boxes_3d': (G, 7+) [x y z dx dy dz yaw ...]}
    det: {'name': (D,), 'boxes_3d'|'boxes_lidar': (D, 7+), 'score': (D,)}
    Returns (result_str, result_dict) with per-class AP/ATE/ASE/AOE/CDS and
    the mAP/mCDS composites.
    """
    assert len(gt_annos) == len(det_annos), (len(gt_annos), len(det_annos))
    per_class = {}
    for cls in class_names:
        scores_all, tps = [], {t: [] for t in affinity_thresholds}
        ate_all, ase_all, aoe_all = [], [], []
        n_gt = 0
        for gt, det in zip(gt_annos, det_annos):
            g_names = np.asarray(gt.get('name', []), dtype=object)
            g_boxes = np.asarray(gt.get('boxes_3d', np.zeros((0, 7))),
                                 np.float64)
            if g_boxes.ndim != 2:
                g_boxes = g_boxes.reshape(-1, 7)
            d_boxes = det.get('boxes_3d', det.get('boxes_lidar',
                                                  np.zeros((0, 7))))
            d_boxes = np.asarray(d_boxes, np.float64)
            if d_boxes.ndim != 2:
                d_boxes = d_boxes.reshape(-1, 7)
            d_names = np.asarray(det.get('name', []), dtype=object)
            d_scores = np.asarray(det.get('score', []), np.float64)
            if len(d_scores) != len(d_boxes):
                d_scores = np.zeros(len(d_boxes))

            gm = np.asarray([n == cls for n in g_names], bool) \
                if len(g_names) else np.zeros(0, bool)
            dm = np.asarray([n == cls for n in d_names], bool) \
                if len(d_names) else np.zeros(0, bool)
            g = g_boxes[gm] if len(g_boxes) else np.zeros((0, 7))
            d = d_boxes[dm] if len(d_boxes) else np.zeros((0, 7))
            s = d_scores[dm] if len(d_scores) else np.zeros(0)
            if len(g):
                g = g[np.linalg.norm(g[:, :3], axis=-1) <= max_range]
            if len(d):
                keep = np.linalg.norm(d[:, :3], axis=-1) <= max_range
                d, s = d[keep], s[keep]
            n_gt += len(g)
            scores_all.append(s)
            for t in affinity_thresholds:
                tp, match = _match_frame(d, s, g, t)
                tps[t].append(tp)
                if t == tp_threshold:
                    for i in np.nonzero(tp)[0]:
                        j = match[i]
                        ate_all.append(
                            np.linalg.norm(d[i, :3] - g[j, :3]))
                        ase_all.append(
                            1.0 - _aligned_iou(d[i, 3:6], g[j, 3:6]))
                        aoe_all.append(_wrap_yaw(d[i, 6] - g[j, 6]))
        scores_all = np.concatenate(scores_all) if scores_all else np.zeros(0)
        aps = [_average_precision(scores_all, np.concatenate(tps[t])
                                  if tps[t] else np.zeros(0, bool), n_gt)
               for t in affinity_thresholds]
        ap = float(np.nanmean(aps)) if n_gt > 0 else np.nan
        if ate_all:
            ate = float(np.mean(np.minimum(ate_all, tp_threshold)))
            ase = float(np.mean(np.minimum(ase_all, MAX_SCALE_ERROR)))
            aoe = float(np.mean(np.minimum(aoe_all, MAX_YAW_ERROR)))
        else:                       # no TPs: devkit assigns maximum error
            ate, ase, aoe = tp_threshold, MAX_SCALE_ERROR, MAX_YAW_ERROR
        if np.isnan(ap):
            cds = np.nan
        else:
            cds = ap * np.mean([1 - ate / tp_threshold,
                                1 - ase / MAX_SCALE_ERROR,
                                1 - aoe / MAX_YAW_ERROR])
        per_class[cls] = {'AP': ap, 'ATE': ate, 'ASE': ase, 'AOE': aoe,
                          'CDS': cds, 'num_gt': n_gt}

    evaluated = [c for c in class_names
                 if not np.isnan(per_class[c]['AP'])]
    result = {}
    lines = ['Argoverse 2 detection (CDS protocol, in-tree devkit-free)']
    for c in class_names:
        m = per_class[c]
        lines.append(
            f'{c:24s} AP {m["AP"]:.4f}  ATE {m["ATE"]:.3f}  '
            f'ASE {m["ASE"]:.3f}  AOE {m["AOE"]:.3f}  CDS {m["CDS"]:.4f}  '
            f'({m["num_gt"]} gt)'
            if not np.isnan(m['AP']) else f'{c:24s} (no gt)')
        for k in ('AP', 'ATE', 'ASE', 'AOE', 'CDS'):
            result[f'{c}/{k}'] = m[k]
    result['mAP'] = float(np.mean([per_class[c]['AP'] for c in evaluated])) \
        if evaluated else 0.0
    result['mCDS'] = float(np.mean([per_class[c]['CDS'] for c in evaluated])) \
        if evaluated else 0.0
    lines.append(f"mAP {result['mAP']:.4f}  mCDS {result['mCDS']:.4f}")
    return '\n'.join(lines), result
