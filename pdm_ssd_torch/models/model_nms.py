"""Post-processing NMS (counterpart of `pdm_ssd_tpu/models/model_nms.py`),
batched over the first axis. Only the class-agnostic rotated NMS of the
flagship is ported."""
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
    idx, keep = iou3d.nms_bev(boxes, scores, nms_cfg.NMS_THRESH,
                              pre_maxsize=nms_cfg.NMS_PRE_MAXSIZE,
                              post_maxsize=nms_cfg.NMS_POST_MAXSIZE, valid=valid)
    return (take_rows(boxes, idx), take_rows(scores, idx) * keep, take_rows(labels, idx) * keep, keep)


def dispatch_nms(boxes, scores, labels, valid, nms_cfg, num_class, score_thresh=None):
    nms_type = nms_cfg.get('NMS_TYPE', 'nms_bev')
    if nms_type != 'nms_bev':
        raise NotImplementedError(
            f'NMS_TYPE {nms_type} is not ported yet (ROADMAP Queue 1 item 11 for '
            'circle_nms; item 2 for multi_classes_nms / class_specific_nms)')
    return class_agnostic_nms(boxes, scores, labels, valid, nms_cfg)
