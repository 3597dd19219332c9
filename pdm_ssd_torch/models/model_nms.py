"""Post-processing NMS (counterpart of `pdm_ssd_tpu/models/model_nms.py`),
batched over the first axis. Every kind returns (boxes, scores, labels
(1-based), keep) with a fixed number of slots:

- `class_agnostic_nms`: one NMS over all candidates, rotated (`nms_bev`) or
  by center distance (`circle_nms`); NMS_POST_MAXSIZE slots;
- `multi_classes_nms`: one rotated NMS per class column of the scores;
  the classes' NMS_POST_MAXSIZE slots side by side;
- `class_specific_nms`: one rotated NMS per class over the candidates
  labelled with it, with per-class thresholds; likewise.

NMS_THRESH, NMS_PRE_MAXSIZE and NMS_POST_MAXSIZE of the per-class kinds are
a number for every class or a list of one per class.
"""
from __future__ import annotations

import torch

from ..ops import iou3d
from ..ops.selection import two_stage_topk


def take_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, A, ...), idx (B, P) -> (B, P, ...)."""
    return torch.gather(t, 1, idx.reshape(idx.shape + (1,) * (t.dim() - 2))
                        .expand(*idx.shape, *t.shape[2:]))


def _as_list(v, n):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n


def class_agnostic_nms(boxes, scores, labels, valid, nms_cfg):
    """boxes (B, A, 7), scores/labels/valid (B, A) -> (boxes, scores, labels,
    keep), each with NMS_POST_MAXSIZE slots."""
    if nms_cfg.get('NMS_TYPE', 'nms_bev') == 'circle_nms':
        idx, keep = iou3d.circle_nms(boxes, scores, nms_cfg.get('NMS_RADIUS', 1.0),
                                     pre_maxsize=nms_cfg.NMS_PRE_MAXSIZE,
                                     post_maxsize=nms_cfg.NMS_POST_MAXSIZE, valid=valid)
    else:
        idx, keep = iou3d.nms_bev(boxes, scores, nms_cfg.NMS_THRESH,
                                  pre_maxsize=nms_cfg.NMS_PRE_MAXSIZE,
                                  post_maxsize=nms_cfg.NMS_POST_MAXSIZE, valid=valid)
    return (take_rows(boxes, idx), take_rows(scores, idx) * keep, take_rows(labels, idx) * keep, keep)


def _stack(parts):
    return tuple(torch.cat([p[i] for p in parts], dim=1) for i in range(4))


def multi_classes_nms(cls_probs, boxes, nms_cfg, score_thresh=None):
    """Per-class column NMS (`model_nms_utils.multi_classes_nms:28-67`).
    cls_probs (B, A, C) sigmoid scores, boxes (B, A, 7). Class k takes its
    top 2 * NMS_PRE_MAXSIZE[k] anchors by `two_stage_topk` (scores below
    `score_thresh` at -1), then a rotated NMS over those scoring above
    `score_thresh` (above 0 without one); label k + 1."""
    num_class = cls_probs.shape[-1]
    threshs = _as_list(nms_cfg.NMS_THRESH, num_class)
    pres = _as_list(nms_cfg.NMS_PRE_MAXSIZE, num_class)
    posts = _as_list(nms_cfg.NMS_POST_MAXSIZE, num_class)
    parts = []
    for k in range(num_class):
        s = cls_probs[..., k]
        if score_thresh is not None:
            s = torch.where(s >= score_thresh, s, -1.0)
        top_s, sel = two_stage_topk(s, min(pres[k] * 2, s.shape[-1]))
        b = take_rows(boxes, sel)
        vv = top_s > (0.0 if score_thresh is None else score_thresh)
        idx, keep = iou3d.nms_bev(b, top_s, threshs[k], pre_maxsize=pres[k],
                                  post_maxsize=posts[k], valid=vv)
        parts.append((take_rows(b, idx), take_rows(top_s, idx) * keep, (k + 1) * keep.long(),
                      keep))
    return _stack(parts)


def class_specific_nms(boxes, scores, labels, valid, nms_cfg, num_class, score_thresh=None):
    """Per-class NMS over labelled candidates
    (`model_nms_utils.class_specific_nms:69-108`): class k's rotated NMS
    runs over the valid candidates labelled k + 1 (1-based) that score
    above its `score_thresh` (a number or one per class)."""
    threshs = _as_list(nms_cfg.NMS_THRESH, num_class)
    pres = _as_list(nms_cfg.NMS_PRE_MAXSIZE, num_class)
    posts = _as_list(nms_cfg.NMS_POST_MAXSIZE, num_class)
    sth = _as_list(score_thresh, num_class) if score_thresh is not None else None
    parts = []
    for k in range(num_class):
        v = valid & (labels == k + 1)
        if sth is not None:
            v = v & (scores > sth[k])
        idx, keep = iou3d.nms_bev(boxes, scores, threshs[k], pre_maxsize=pres[k],
                                  post_maxsize=posts[k], valid=v)
        parts.append((take_rows(boxes, idx), take_rows(scores, idx) * keep,
                      (k + 1) * keep.long(), keep))
    return _stack(parts)


def dispatch_nms(boxes, scores, labels, valid, nms_cfg, num_class, cls_probs=None,
                 score_thresh=None):
    """The NMS kind NMS_TYPE names: 'multi_classes_nms' (which needs
    `cls_probs`), 'class_specific_nms', else the class-agnostic NMS."""
    nms_type = nms_cfg.get('NMS_TYPE', 'nms_bev')
    if nms_type == 'multi_classes_nms':
        if cls_probs is None:
            raise ValueError('multi_classes_nms needs the per-class scores of an anchor head')
        return multi_classes_nms(cls_probs, boxes, nms_cfg, score_thresh)
    if nms_type == 'class_specific_nms':
        return class_specific_nms(boxes, scores, labels, valid, nms_cfg, num_class,
                                  score_thresh)
    return class_agnostic_nms(boxes, scores, labels, valid, nms_cfg)
