"""Post-processing NMS (counterpart of `pdm_ssd_tpu/models/model_nms.py`),
batched over the first axis. The class-agnostic NMS is ported, rotated
(`nms_bev`) and by center distance (`circle_nms`); the per-class kinds are
not."""
from __future__ import annotations

import torch

from ..ops import iou3d


def take_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, A, ...), idx (B, P) -> (B, P, ...)."""
    return torch.gather(t, 1, idx.reshape(idx.shape + (1,) * (t.dim() - 2))
                        .expand(*idx.shape, *t.shape[2:]))


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


def dispatch_nms(boxes, scores, labels, valid, nms_cfg, num_class, score_thresh=None):
    nms_type = nms_cfg.get('NMS_TYPE', 'nms_bev')
    if nms_type not in ('nms_bev', 'circle_nms'):
        raise NotImplementedError(
            f'NMS_TYPE {nms_type} is not ported yet (ROADMAP Queue 1 item 8b, '
            'pdm_ssd_nuscenes.yaml: multi_classes_nms and class_specific_nms)')
    return class_agnostic_nms(boxes, scores, labels, valid, nms_cfg)
