"""nuScenes detection metrics (mAP / TP errors / NDS), devkit-free (copy of
`pdm_ssd_tpu/datasets/nuscenes/nuscenes_eval.py`, numpy only).

An implementation of the published nuScenes detection protocol (the
reference delegates to the nuscenes-devkit, from
`pcdet/datasets/nuscenes/nuscenes_dataset.py.evaluation`):

- matching by BEV center distance at thresholds {0.5, 1, 2, 4} m, greedy in
  global score order, one GT per prediction, per class;
- AP = normalized area under the interpolated 101-point PR curve with the
  10% recall/precision floors: mean(clip(P - 0.1, 0)) / 0.9 over R > 0.1;
- TP metrics at the 2 m threshold averaged over the recall range above 10%:
  ATE (2D center distance), ASE (1 - aligned IoU = 1 - min-ratio volume
  overlap of translation/rotation-aligned boxes), AOE (absolute yaw delta,
  period 2pi), and when velocities are present AVE (L2);
- NDS = (5 * mAP + sum_tp (1 - min(1, tp_err))) / (5 + n_tp_metrics).
"""
from __future__ import annotations

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
N_INTERP = 101


def _aligned_iou3d(gt, pr):
    """Scale similarity of translation/rotation-aligned boxes: IoU of two
    axis-aligned boxes sharing a corner (the devkit's scale_iou)."""
    inter = np.prod(np.minimum(gt[3:6], pr[3:6]))
    union = np.prod(gt[3:6]) + np.prod(pr[3:6]) - inter
    return inter / max(union, 1e-9)


def _yaw_diff(a, b):
    d = np.abs(a - b) % (2 * np.pi)
    return min(d, 2 * np.pi - d)


def _match_class(gts_per_sample, preds, dist_th):
    """preds: list of (sample_idx, score, box[, vel]); returns per-pred
    (is_tp, tp_errs dict | None) in score order plus total gt count."""
    order = sorted(range(len(preds)), key=lambda i: -preds[i][1])
    taken = [set() for _ in gts_per_sample]
    results = []
    for pi in order:
        s_idx, score, box = preds[pi][:3]
        gts = gts_per_sample[s_idx]
        best, best_d = -1, float(dist_th)
        for gi, g in enumerate(gts):
            if gi in taken[s_idx]:
                continue
            d = np.hypot(box[0] - g[0], box[1] - g[1])
            if d < best_d:
                best, best_d = gi, d
        if best >= 0:
            taken[s_idx].add(best)
            g = gts[best]
            errs = {'trans': best_d,
                    'scale': 1.0 - _aligned_iou3d(np.asarray(g), np.asarray(box)),
                    'orient': _yaw_diff(box[6], g[6])}
            if len(box) > 7 and len(g) > 7:
                errs['vel'] = float(np.hypot(box[7] - g[7], box[8] - g[8]))
            results.append((score, True, errs))
        else:
            results.append((score, False, None))
    return results


def _calc_ap(results, n_gt):
    """Devkit `calc_ap`: 101-point interpolation with the 10% floors."""
    if n_gt == 0 or not results:
        return 0.0, np.zeros(0), []
    tp = np.cumsum([r[1] for r in results])
    fp = np.cumsum([not r[1] for r in results])
    rec = tp / n_gt
    prec = tp / np.maximum(tp + fp, 1)
    rec_interp = np.linspace(0, 1, N_INTERP)
    prec_i = np.interp(rec_interp, rec, prec, right=0)
    clipped = prec_i[int(round(100 * MIN_RECALL)) + 1:] - MIN_PRECISION
    clipped[clipped < 0] = 0
    return float(np.mean(clipped) / (1 - MIN_PRECISION)), rec, prec


def _calc_tp(results, n_gt, key):
    """Devkit `calc_tp`: mean error over the recall range above MIN_RECALL,
    cumulative-mean interpolated on the 101-point recall grid."""
    tps = [(r[0], r[2]) for r in results if r[1] and r[2] is not None
           and key in r[2]]
    if n_gt == 0 or not tps:
        return 1.0
    errs = np.asarray([e[1][key] for e in tps])
    tp_cum = np.arange(1, len(errs) + 1)
    rec = tp_cum / n_gt
    cummean = np.cumsum(errs) / tp_cum
    rec_interp = np.linspace(0, 1, N_INTERP)
    err_i = np.interp(rec_interp, rec, cummean, right=cummean[-1]
                      if len(cummean) else 1.0)
    lo = int(round(100 * MIN_RECALL)) + 1
    hi = int(round(100 * min(rec.max(), 1.0))) + 1
    if hi <= lo:
        return 1.0
    return float(np.mean(err_i[lo:hi]))


def evaluate_nuscenes(gt_annos, pred_annos, class_names):
    """gt_annos/pred_annos: per sample dicts {'name' (N,), 'boxes_3d' (N,7+)}
    (+ 'score' for preds). Returns (report_str, metrics dict incl. NDS)."""
    n = len(gt_annos)
    assert n == len(pred_annos)
    metrics = {}
    ap_all, tp_all = [], {'trans': [], 'scale': [], 'orient': []}
    has_vel = any(np.asarray(p.get('boxes_3d', np.zeros((0, 7)))).shape[-1] > 7
                  for p in pred_annos)
    if has_vel:
        tp_all['vel'] = []

    for cls in class_names:
        gts_per_sample = []
        preds = []
        for s in range(n):
            g = gt_annos[s]
            names = np.asarray(g['name'])
            boxes = np.asarray(g['boxes_3d'])
            gts_per_sample.append([boxes[i] for i in range(len(names))
                                   if names[i] == cls])
            p = pred_annos[s]
            pn = np.asarray(p['name'])
            pb = np.asarray(p['boxes_3d'])
            ps = np.asarray(p['score'])
            for i in range(len(pn)):
                if pn[i] == cls:
                    preds.append((s, float(ps[i]), pb[i]))
        n_gt = sum(len(g) for g in gts_per_sample)

        aps = []
        for th in DIST_THRESHOLDS:
            results = _match_class(gts_per_sample, preds, th)
            ap, _, _ = _calc_ap(results, n_gt)
            aps.append(ap)
            if th == TP_THRESHOLD:
                for key in tp_all:
                    metrics[f'{cls}_{key}_err'] = _calc_tp(results, n_gt, key)
        metrics[f'{cls}_AP'] = float(np.mean(aps))
        ap_all.append(np.mean(aps))
        for key in tp_all:
            tp_all[key].append(metrics[f'{cls}_{key}_err'])

    m_ap = float(np.mean(ap_all)) if ap_all else 0.0
    metrics['mAP'] = m_ap
    tp_scores = []
    for key, vals in tp_all.items():
        m = float(np.mean(vals)) if vals else 1.0
        metrics[f'm{key.upper()}E'] = m
        tp_scores.append(max(0.0, 1.0 - min(1.0, m)))
    metrics['NDS'] = (5 * m_ap + sum(tp_scores)) / (5 + len(tp_scores))
    lines = [f'{k}: {v:.4f}' for k, v in sorted(metrics.items())]
    return '\n'.join(lines), metrics
