"""Official KITTI AP evaluation, batch-vectorized numpy (copy of
`pdm_ssd_tpu/datasets/kitti/eval.py`).

The community-standard protocol (`kitti_object_eval_python/eval.py`): R11 +
R40 precision sampling, easy/moderate/hard difficulty gating by bbox height /
occlusion / truncation, ignored-class handling (Van~Car,
Person_sitting~Pedestrian), DontCare suppression, metrics bbox/BEV/3D/AOS,
class IoU thresholds 0.7/0.5. The greedy per-ground-truth assignment runs as
a python loop only over padded GT slots with all images batched in numpy.
Rotated overlaps use the polygon clipping of `utils/np_iou.py`.
"""
from __future__ import annotations

import io as sysio

import numpy as np

from ...utils import np_iou

CLASS_NAMES = ['car', 'pedestrian', 'cyclist', 'van', 'person_sitting', 'truck']
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
N_SAMPLE_PTS = 41


def get_thresholds(scores: np.ndarray, num_gt, num_sample_pts=41):
    """(reference eval.py:10-27.)"""
    scores = np.sort(scores)[::-1]
    current_recall = 0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < (len(scores) - 1) else l_recall
        if (((r_recall - current_recall) < (current_recall - l_recall))
                and (i < (len(scores) - 1))):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return np.array(thresholds)


def clean_data(gt_anno, dt_anno, current_class, difficulty):
    """(reference eval.py:30-85.) Returns num_valid_gt, ignored_gt, ignored_dt,
    dc_bboxes with identical semantics."""
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    current_cls_name = CLASS_NAMES[current_class].lower()
    num_gt = len(gt_anno['name'])
    num_dt = len(dt_anno['name'])
    num_valid_gt = 0
    for i in range(num_gt):
        bbox = gt_anno['bbox'][i]
        gt_name = str(gt_anno['name'][i]).lower()
        height = bbox[3] - bbox[1]
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == 'pedestrian' and gt_name == 'person_sitting':
            valid_class = 0
        elif current_cls_name == 'car' and gt_name == 'van':
            valid_class = 0
        else:
            valid_class = -1
        ignore = bool(
            gt_anno['occluded'][i] > MAX_OCCLUSION[difficulty]
            or gt_anno['truncated'][i] > MAX_TRUNCATION[difficulty]
            or height <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if str(gt_anno['name'][i]) == 'DontCare':
            dc_bboxes.append(gt_anno['bbox'][i])
    for i in range(num_dt):
        height = abs(dt_anno['bbox'][i, 3] - dt_anno['bbox'][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif str(dt_anno['name'][i]).lower() == current_cls_name:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def image_box_overlap(boxes, query_boxes, criterion=-1):
    """Vectorized 2D box overlap (reference eval.py:88-114)."""
    N, K = boxes.shape[0], query_boxes.shape[0]
    if N == 0 or K == 0:
        return np.zeros((N, K))
    iw = (np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]))
    ih = (np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]))
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area_b = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))[:, None]
    area_q = ((query_boxes[:, 2] - query_boxes[:, 0])
              * (query_boxes[:, 3] - query_boxes[:, 1]))[None, :]
    if criterion == -1:
        ua = area_b + area_q - inter
    elif criterion == 0:
        ua = np.broadcast_to(area_b, inter.shape)
    elif criterion == 1:
        ua = np.broadcast_to(area_q, inter.shape)
    else:
        ua = np.ones_like(inter)
    return np.where((iw > 0) & (ih > 0), inter / ua, 0.0)


def bev_box_overlap(boxes, qboxes, criterion=-1):
    """Camera-frame BEV rotated IoU. boxes: (N, 5) [x, z, l, w, ry]."""
    inter = np_iou.rect_overlap_cpu(boxes.astype(np.float32), qboxes.astype(np.float32))
    area_b = (boxes[:, 2] * boxes[:, 3])[:, None]
    area_q = (qboxes[:, 2] * qboxes[:, 3])[None, :]
    if criterion == -1:
        ua = np.clip(area_b + area_q - inter, 1e-8, None)
    else:
        ua = np.ones_like(inter)
    return inter / ua


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """Camera-frame 3D IoU. boxes: (N, 7) [x, y, z, l, h, w, ry]; y is the box
    bottom in camera coords (reference d3_box_overlap, eval.py:120-155)."""
    rinc = np_iou.rect_overlap_cpu(
        boxes[:, [0, 2, 3, 5, 6]].astype(np.float32),
        qboxes[:, [0, 2, 3, 5, 6]].astype(np.float32))
    iw = (np.minimum(boxes[:, None, 1], qboxes[None, :, 1])
          - np.maximum(boxes[:, None, 1] - boxes[:, None, 4],
                       qboxes[None, :, 1] - qboxes[None, :, 4]))
    vol_b = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    vol_q = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    inc = np.clip(iw, 0, None) * rinc
    if criterion == -1:
        ua = np.clip(vol_b + vol_q - inc, 1e-8, None)
    else:
        ua = np.ones_like(inc)
    return np.where(iw > 0, inc / ua, 0.0)


# ---------------------------------------------------------------------------
# batched greedy matcher
# ---------------------------------------------------------------------------

def _pad_batch(per_image_arrays, pad_val, dtype):
    """list of (n_i, ...) -> (B, Nmax, ...) padded array."""
    B = len(per_image_arrays)
    Nmax = max([len(a) for a in per_image_arrays] + [1])
    trailing = per_image_arrays[0].shape[1:] if per_image_arrays[0].ndim > 1 else ()
    out = np.full((B, Nmax) + trailing, pad_val, dtype)
    for i, a in enumerate(per_image_arrays):
        if len(a):
            out[i, :len(a)] = a
    return out


def _batched_match(ov, gt_ig, dt_ig, dt_scores, min_overlap, thresh,
                   compute_fp, gt_alpha=None, dt_alpha=None):
    """Vectorized port of `compute_statistics_jit` (eval.py:158-275).

    Args (all padded):
        ov: (B, D, G) overlaps (dt x gt). gt_ig: (B, G) in {-1, 0, 1; -2 pad}.
        dt_ig: (B, D) in {-1, 0, 1; -2 pad}. dt_scores: (B, D).
        thresh: scalar or (B,) score threshold.
    Returns dict with tp/fp/fn/similarity (B,), and for the threshold stage the
    (B, G) matched-score matrix + tp mask.
    """
    B, D, G = ov.shape
    thresh = np.broadcast_to(np.asarray(thresh, np.float32), (B,))
    ig_thresh = compute_fp & (dt_scores < thresh[:, None])  # (B, D)

    assigned = np.zeros((B, D), bool)
    tp = np.zeros(B, np.int64)
    fn = np.zeros(B, np.int64)
    tp_score = np.full((B, G), -np.inf, np.float32)
    tp_mask = np.zeros((B, G), bool)
    delta_sum_terms = np.zeros((B, G), np.float32)
    has_delta = np.zeros((B, G), bool)

    big_neg = -np.inf
    for i in range(G):
        gi = gt_ig[:, i]                      # (B,)
        active = gi >= 0                      # skip -1 / padding
        ov_i = ov[:, :, i]                    # (B, D)
        cand = (dt_ig >= 0) & ~assigned & ~ig_thresh & (ov_i > min_overlap)
        if not compute_fp:
            # pick candidate with max score (ties -> lowest j)
            score_key = np.where(cand, dt_scores, big_neg)
            det_idx = np.argmax(score_key, axis=1)              # (B,)
            found = np.take_along_axis(score_key, det_idx[:, None], 1)[:, 0] > big_neg
        else:
            cand0 = cand & (dt_ig == 0)
            ov_key = np.where(cand0, ov_i, big_neg)
            det0 = np.argmax(ov_key, axis=1)
            found0 = np.take_along_axis(ov_key, det0[:, None], 1)[:, 0] > big_neg
            cand1 = cand & (dt_ig == 1)
            # first det1 in j order
            j_key = np.where(cand1, np.arange(D)[None, :], D)
            det1 = np.argmin(j_key, axis=1)
            found1 = np.take_along_axis(j_key, det1[:, None], 1)[:, 0] < D
            det_idx = np.where(found0, det0, det1)
            found = found0 | found1

        found = found & active
        det_ig_sel = np.take_along_axis(
            np.where(dt_ig == -2, -2, dt_ig), det_idx[:, None], 1)[:, 0]
        # outcomes
        is_fn = active & ~found & (gi == 0)
        assign_only = found & ((gi == 1) | (det_ig_sel == 1))
        is_tp = found & ~assign_only

        fn += is_fn
        tp += is_tp
        sel_scores = np.take_along_axis(dt_scores, det_idx[:, None], 1)[:, 0]
        tp_score[:, i] = np.where(is_tp, sel_scores, -np.inf)
        tp_mask[:, i] = is_tp
        if gt_alpha is not None:
            sel_alpha = np.take_along_axis(dt_alpha, det_idx[:, None], 1)[:, 0]
            delta_sum_terms[:, i] = np.where(
                is_tp, (1.0 + np.cos(gt_alpha[:, i] - sel_alpha)) / 2.0, 0.0)
            has_delta[:, i] = is_tp
        # mark assignment
        do_assign = found & (assign_only | is_tp)
        row = np.arange(B)
        assigned[row, det_idx] = assigned[row, det_idx] | do_assign

    out = {'tp': tp, 'fn': fn, 'assigned': assigned, 'ig_thresh': ig_thresh,
           'tp_score': tp_score, 'tp_mask': tp_mask,
           'delta_terms': delta_sum_terms}
    if compute_fp:
        fp = np.sum((~assigned) & (dt_ig == 0) & ~ig_thresh, axis=1)
        out['fp'] = fp
    return out


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False):
    """(reference eval.py:448-553.) Returns recall/precision/aos arrays of shape
    [num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS]."""
    assert len(gt_annos) == len(dt_annos)
    num_examples = len(gt_annos)

    # ---- per-image overlap matrices (dt x gt), computed once per metric ----
    overlaps = []
    for i in range(num_examples):
        gt, dt = gt_annos[i], dt_annos[i]
        if metric == 0:
            ov = image_box_overlap(np.asarray(dt['bbox']).reshape(-1, 4),
                                   np.asarray(gt['bbox']).reshape(-1, 4))
        elif metric == 1:
            def bev5(a):
                loc = np.asarray(a['location']).reshape(-1, 3)[:, [0, 2]]
                dims = np.asarray(a['dimensions']).reshape(-1, 3)[:, [0, 2]]
                rots = np.asarray(a['rotation_y']).reshape(-1, 1)
                return np.concatenate([loc, dims, rots], axis=1)
            ov = bev_box_overlap(bev5(dt), bev5(gt))
        else:
            def cam7(a):
                loc = np.asarray(a['location']).reshape(-1, 3)
                dims = np.asarray(a['dimensions']).reshape(-1, 3)
                rots = np.asarray(a['rotation_y']).reshape(-1, 1)
                return np.concatenate([loc, dims, rots], axis=1)
            ov = d3_box_overlap(cam7(dt), cam7(gt))
        overlaps.append(ov.astype(np.float32))

    num_minoverlap = len(min_overlaps)
    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    precision = np.zeros([num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS])
    recall = np.zeros([num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS])
    aos = np.zeros([num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS])

    for m, current_class in enumerate(current_classes):
        for ld, difficulty in enumerate(difficultys):
            gt_igs, dt_igs, dcs = [], [], []
            total_num_valid_gt = 0
            for i in range(num_examples):
                nv, ig_gt, ig_dt, dc = clean_data(
                    gt_annos[i], dt_annos[i], current_class, difficulty)
                total_num_valid_gt += nv
                gt_igs.append(np.array(ig_gt, np.int64))
                dt_igs.append(np.array(ig_dt, np.int64))
                dcs.append(np.array(dc, np.float64).reshape(-1, 4))

            gt_ig = _pad_batch(gt_igs, -2, np.int64)      # (B, G)
            dt_ig = _pad_batch(dt_igs, -2, np.int64)      # (B, D)
            B, G = gt_ig.shape
            D = dt_ig.shape[1]
            ov = np.zeros((B, D, G), np.float32)
            for i in range(B):
                d, g = overlaps[i].shape
                ov[i, :d, :g] = overlaps[i]
            dt_scores = _pad_batch(
                [np.asarray(a['score'], np.float32) for a in dt_annos], -1e9, np.float32)
            gt_alpha = _pad_batch(
                [np.asarray(a['alpha'], np.float32) for a in gt_annos], 0, np.float32)
            dt_alpha = _pad_batch(
                [np.asarray(a['alpha'], np.float32) for a in dt_annos], 0, np.float32)
            # DontCare suppression (metric 0 only): dt vs dc image overlap crit 0
            dt_dc_hits = []  # (B, D) bool: det overlaps any dc box
            for i in range(B):
                bbox = np.asarray(dt_annos[i]['bbox']).reshape(-1, 4)
                if len(dcs[i]) and len(bbox) and metric == 0:
                    o = image_box_overlap(bbox, dcs[i], 0)
                    dt_dc_hits.append(o)
                else:
                    dt_dc_hits.append(np.zeros((len(bbox), len(dcs[i]))))

            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                # stage 1: thresholds from all TP scores at thresh=0
                r1 = _batched_match(ov, gt_ig, dt_ig, dt_scores, min_overlap,
                                    0.0, compute_fp=False)
                all_scores = r1['tp_score'][r1['tp_mask']]
                if total_num_valid_gt == 0:
                    continue
                thresholds = get_thresholds(all_scores, total_num_valid_gt)
                if len(thresholds) == 0:
                    continue
                pr = np.zeros([len(thresholds), 4])
                for t, thr in enumerate(thresholds):
                    r = _batched_match(
                        ov, gt_ig, dt_ig, dt_scores, min_overlap, thr,
                        compute_fp=True,
                        gt_alpha=gt_alpha if compute_aos else None,
                        dt_alpha=dt_alpha if compute_aos else None)
                    fp = r['fp'].astype(np.int64)
                    # subtract dets absorbed by DontCare regions
                    if metric == 0:
                        for i in range(B):
                            hits = dt_dc_hits[i]
                            if hits.size == 0:
                                continue
                            d = hits.shape[0]
                            unassigned = (~r['assigned'][i, :d]) \
                                & (dt_ig[i, :d] == 0) & (~r['ig_thresh'][i, :d])
                            nstuff = np.sum(unassigned & (hits > min_overlap).any(axis=1))
                            fp[i] -= nstuff
                    pr[t, 0] = r['tp'].sum()
                    pr[t, 1] = fp.sum()
                    pr[t, 2] = r['fn'].sum()
                    if compute_aos:
                        pr[t, 3] = r['delta_terms'].sum()
                for i in range(len(thresholds)):
                    recall[m, ld, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 2])
                    precision[m, ld, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
                    if compute_aos:
                        aos[m, ld, k, i] = pr[i, 3] / (pr[i, 0] + pr[i, 1])
                for i in range(len(thresholds)):
                    precision[m, ld, k, i] = np.max(precision[m, ld, k, i:], axis=-1)
                    recall[m, ld, k, i] = np.max(recall[m, ld, k, i:], axis=-1)
                    if compute_aos:
                        aos[m, ld, k, i] = np.max(aos[m, ld, k, i:], axis=-1)
    return {'recall': recall, 'precision': precision, 'orientation': aos}


def get_mAP(prec):
    sums = 0
    for i in range(0, prec.shape[-1], 4):
        sums = sums + prec[..., i]
    return sums / 11 * 100


def get_mAP_R40(prec):
    sums = 0
    for i in range(1, prec.shape[-1]):
        sums = sums + prec[..., i]
    return sums / 40 * 100


def print_str(value, *arg, sstream=None):
    if sstream is None:
        sstream = sysio.StringIO()
    sstream.truncate(0)
    sstream.seek(0)
    print(value, *arg, file=sstream)
    return sstream.getvalue()


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps, compute_aos=False):
    difficultys = [0, 1, 2]
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 0,
                     min_overlaps, compute_aos)
    mAP_bbox = get_mAP(ret['precision'])
    mAP_bbox_R40 = get_mAP_R40(ret['precision'])
    mAP_aos = mAP_aos_R40 = None
    if compute_aos:
        mAP_aos = get_mAP(ret['orientation'])
        mAP_aos_R40 = get_mAP_R40(ret['orientation'])
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1, min_overlaps)
    mAP_bev = get_mAP(ret['precision'])
    mAP_bev_R40 = get_mAP_R40(ret['precision'])
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2, min_overlaps)
    mAP_3d = get_mAP(ret['precision'])
    mAP_3d_R40 = get_mAP_R40(ret['precision'])
    return (mAP_bbox, mAP_bev, mAP_3d, mAP_aos,
            mAP_bbox_R40, mAP_bev_R40, mAP_3d_R40, mAP_aos_R40)


def get_official_eval_result(gt_annos, dt_annos, current_classes):
    """(reference eval.py:639-808.) Same thresholds table and output dict keys."""
    overlap_0_7 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.7],
                            [0.7, 0.5, 0.5, 0.7, 0.5, 0.7],
                            [0.7, 0.5, 0.5, 0.7, 0.5, 0.7]])
    overlap_0_5 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5]])
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], axis=0)  # [2, 3, 6]
    class_to_name = {0: 'Car', 1: 'Pedestrian', 2: 'Cyclist', 3: 'Van',
                     4: 'Person_sitting', 5: 'Truck'}
    name_to_class = {v: n for n, v in class_to_name.items()}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [name_to_class[c] if isinstance(c, str) else c
                       for c in current_classes]
    min_overlaps = min_overlaps[:, :, current_classes]
    result = ''
    compute_aos = False
    for anno in dt_annos:
        if anno['alpha'].shape[0] != 0:
            if anno['alpha'][0] != -10:
                compute_aos = True
            break
    (mAPbbox, mAPbev, mAP3d, mAPaos, mAPbbox_R40, mAPbev_R40, mAP3d_R40,
     mAPaos_R40) = do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
                           compute_aos)

    ret_dict = {}
    for j, curcls in enumerate(current_classes):
        cls_name = class_to_name[curcls]
        for i in range(min_overlaps.shape[0]):
            result += print_str(
                f"{cls_name} AP@{min_overlaps[i, 0, j]:.2f}, "
                f"{min_overlaps[i, 1, j]:.2f}, {min_overlaps[i, 2, j]:.2f}:")
            result += print_str(
                f"bbox AP:{mAPbbox[j, 0, i]:.4f}, {mAPbbox[j, 1, i]:.4f}, {mAPbbox[j, 2, i]:.4f}")
            result += print_str(
                f"bev  AP:{mAPbev[j, 0, i]:.4f}, {mAPbev[j, 1, i]:.4f}, {mAPbev[j, 2, i]:.4f}")
            result += print_str(
                f"3d   AP:{mAP3d[j, 0, i]:.4f}, {mAP3d[j, 1, i]:.4f}, {mAP3d[j, 2, i]:.4f}")
            if compute_aos:
                result += print_str(
                    f"aos  AP:{mAPaos[j, 0, i]:.2f}, {mAPaos[j, 1, i]:.2f}, {mAPaos[j, 2, i]:.2f}")
            result += print_str(
                f"{cls_name} AP_R40@{min_overlaps[i, 0, j]:.2f}, "
                f"{min_overlaps[i, 1, j]:.2f}, {min_overlaps[i, 2, j]:.2f}:")
            result += print_str(
                f"bbox AP:{mAPbbox_R40[j, 0, i]:.4f}, {mAPbbox_R40[j, 1, i]:.4f}, {mAPbbox_R40[j, 2, i]:.4f}")
            result += print_str(
                f"bev  AP:{mAPbev_R40[j, 0, i]:.4f}, {mAPbev_R40[j, 1, i]:.4f}, {mAPbev_R40[j, 2, i]:.4f}")
            result += print_str(
                f"3d   AP:{mAP3d_R40[j, 0, i]:.4f}, {mAP3d_R40[j, 1, i]:.4f}, {mAP3d_R40[j, 2, i]:.4f}")
            if compute_aos:
                result += print_str(
                    f"aos  AP:{mAPaos_R40[j, 0, i]:.2f}, {mAPaos_R40[j, 1, i]:.2f}, {mAPaos_R40[j, 2, i]:.2f}")
                if i == 0:
                    ret_dict[f'{cls_name}_aos/easy_R40'] = mAPaos_R40[j, 0, 0]
                    ret_dict[f'{cls_name}_aos/moderate_R40'] = mAPaos_R40[j, 1, 0]
                    ret_dict[f'{cls_name}_aos/hard_R40'] = mAPaos_R40[j, 2, 0]
            if i == 0:
                ret_dict[f'{cls_name}_3d/easy_R40'] = mAP3d_R40[j, 0, 0]
                ret_dict[f'{cls_name}_3d/moderate_R40'] = mAP3d_R40[j, 1, 0]
                ret_dict[f'{cls_name}_3d/hard_R40'] = mAP3d_R40[j, 2, 0]
                ret_dict[f'{cls_name}_bev/easy_R40'] = mAPbev_R40[j, 0, 0]
                ret_dict[f'{cls_name}_bev/moderate_R40'] = mAPbev_R40[j, 1, 0]
                ret_dict[f'{cls_name}_bev/hard_R40'] = mAPbev_R40[j, 2, 0]
                ret_dict[f'{cls_name}_image/easy_R40'] = mAPbbox_R40[j, 0, 0]
                ret_dict[f'{cls_name}_image/moderate_R40'] = mAPbbox_R40[j, 1, 0]
                ret_dict[f'{cls_name}_image/hard_R40'] = mAPbbox_R40[j, 2, 0]
    return result, ret_dict
