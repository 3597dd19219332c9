"""Loss functions (counterpart of `pdm_ssd_tpu/ops/losses.py`): the ones the
flagship, SECOND, the two-stage heads and the CenterHead's IoU branches
train with. `weighted_l1` of the JAX package is not ported: no ported model
uses it.
"""
from __future__ import annotations

import math

import torch

from . import box_ops
from ..parallel import ddp


def sigmoid_bce_with_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """max(x, 0) - x*z + log1p(exp(-|x|))."""
    return logits.clamp(min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits: torch.Tensor, target: torch.Tensor, weights: torch.Tensor,
                       gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """Weighted sigmoid focal loss, no reduction. logits and target (..., C);
    weights (...,) broadcast over the class axis."""
    pred_sigmoid = torch.sigmoid(logits)
    alpha_weight = target * alpha + (1 - target) * (1 - alpha)
    pt = target * (1.0 - pred_sigmoid) + (1.0 - target) * pred_sigmoid
    loss = alpha_weight * torch.pow(pt, gamma) * sigmoid_bce_with_logits(logits, target)
    if weights.dim() == loss.dim() - 1:
        weights = weights[..., None]
    return loss * weights


def smooth_l1(diff: torch.Tensor, beta: float) -> torch.Tensor:
    n = diff.abs()
    if beta < 1e-5:
        return n
    return torch.where(n < beta, 0.5 * n ** 2 / beta, n - 0.5 * beta)


def weighted_smooth_l1(pred: torch.Tensor, target: torch.Tensor,
                       weights: torch.Tensor | None = None, beta: float = 1.0 / 9.0,
                       code_weights=None) -> torch.Tensor:
    """(..., codes) smooth L1 with per-code weights; NaN targets are ignored."""
    target = torch.where(torch.isnan(target), pred, target)
    diff = pred - target
    if code_weights is not None:
        diff = diff * torch.as_tensor(code_weights, dtype=pred.dtype, device=pred.device)
    loss = smooth_l1(diff, beta)
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


def weighted_cross_entropy(logits: torch.Tensor, one_hot: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy over the last axis, weighted per row, no
    reduction."""
    return -(one_hot * torch.log_softmax(logits, dim=-1)).sum(dim=-1) * weights


def centernet_focal_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Penalty-reduced focal loss on sigmoided heatmaps of matching shape.
    Returns a scalar normalised by the number of positives of the global
    batch (`parallel.global_sum`), as every normaliser here."""
    pos_inds = (gt == 1.0).to(pred.dtype)
    neg_inds = (gt < 1.0).to(pred.dtype)
    neg_weights = torch.pow(1 - gt, 4)
    pos_sum = (torch.log(pred) * torch.pow(1 - pred, 2) * pos_inds).sum()
    neg_sum = (torch.log(1 - pred) * torch.pow(pred, 2) * neg_weights * neg_inds).sum()
    num_pos = ddp.global_sum(pos_inds.sum())
    return torch.where(num_pos == 0, -neg_sum, -(pos_sum + neg_sum) / num_pos.clamp(min=1.0))


def gather_feat(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """feat (B, HW, C), ind (B, K) -> (B, K, C)."""
    return torch.gather(feat, 1, ind.long()[..., None].expand(-1, -1, feat.shape[-1]))


def centernet_reg_loss(pred: torch.Tensor, mask: torch.Tensor,
                       target: torch.Tensor) -> torch.Tensor:
    """Masked L1 over gathered object slots. pred and target (B, K, D), mask
    (B, K) -> (D,): summed over batch and objects, divided by max(sum(mask), 1)."""
    num = ddp.global_sum(mask.to(pred.dtype).sum())
    m = mask[..., None].to(pred.dtype) * (~torch.isnan(target)).to(pred.dtype)
    target = torch.nan_to_num(target)
    loss = (pred * m - target * m).abs().sum(dim=(0, 1))
    return loss / num.clamp(min=1.0)


def corner_loss_lidar(pred_boxes: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    """Smooth L1 (beta 1) of the distances between the 8 corners of each
    predicted box and those of its ground truth, the smaller of the two
    distances to the ground truth and to it turned by pi, averaged over the
    corners. pred and gt (N, 7) -> (N,). The norm adds 1e-12 under its root,
    so coincident corners give a bounded gradient."""
    pred_corners = box_ops.boxes_to_corners_3d(pred_boxes)
    gt_corners = box_ops.boxes_to_corners_3d(gt_boxes)
    gt_flip = gt_boxes.clone()
    gt_flip[:, 6] = gt_flip[:, 6] + math.pi
    gt_corners_flip = box_ops.boxes_to_corners_3d(gt_flip)

    def safe_norm(d):
        return torch.sqrt((d * d).sum(dim=-1) + 1e-12)

    dist = torch.minimum(safe_norm(pred_corners - gt_corners),
                         safe_norm(pred_corners - gt_corners_flip))         # (N, 8)
    return smooth_l1(dist, beta=1.0).mean(dim=1)


def centerhead_iou_loss(iou_preds: torch.Tensor, decoded_boxes: torch.Tensor,
                        mask: torch.Tensor, gt_boxes_src: torch.Tensor) -> torch.Tensor:
    """IoU-prediction regression (`loss_utils.calculate_iou_loss_centerhead`,
    `pcdet/utils/loss_utils.py:610-634`): masked L1 between the predicted
    IoU channel, gathered at the target cells (B, K), and the aligned 3D IoU
    of the decoded boxes with the raw ground truth mapped from [0, 1] to
    [-1, 1]; no gradient flows through the boxes or the target.
    decoded_boxes and gt_boxes_src (B, K, 7+), mask (B, K)."""
    from . import iou3d
    B, K = iou_preds.shape
    flat_p = decoded_boxes[..., :7].detach().reshape(B * K, 7)
    flat_g = gt_boxes_src[..., :7].reshape(B * K, 7)
    iou_target = iou3d.boxes_aligned_iou3d(flat_p, flat_g).reshape(B, K) * 2.0 - 1.0
    m = mask.to(torch.float32)
    err = (iou_preds - iou_target.detach()).abs() * m
    return err.sum() / ddp.global_sum(m.sum()).clamp(min=1e-4)


def centerhead_iou_reg_loss(decoded_boxes: torch.Tensor, mask: torch.Tensor,
                            gt_boxes_src: torch.Tensor) -> torch.Tensor:
    """DIoU box regression (`loss_utils.calculate_iou_reg_loss_centerhead`,
    `pcdet/utils/loss_utils.py:637-648`): the mean of 1 - DIoU over the valid
    slots. decoded_boxes and gt_boxes_src (B, K, 7+), mask (B, K)."""
    from . import iou3d
    B, K = decoded_boxes.shape[:2]
    diou = iou3d.bbox3d_overlaps_diou(decoded_boxes[..., :7].reshape(B * K, 7),
                                      gt_boxes_src[..., :7].reshape(B * K, 7))
    m = mask.to(torch.float32).reshape(B * K)
    return ((1.0 - diou) * m).sum() / ddp.global_sum(m.sum()).clamp(min=1e-4)
