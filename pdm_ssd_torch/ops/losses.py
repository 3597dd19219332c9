"""Loss functions (counterpart of `pdm_ssd_tpu/ops/losses.py`): the ones the
flagship trains with. `corner_loss_lidar`, the IoU losses and the
cross-entropy of the JAX package are not ported yet.
"""
from __future__ import annotations

import torch


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


def centernet_focal_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Penalty-reduced focal loss on sigmoided heatmaps of matching shape.
    Returns a scalar normalised by the number of positives."""
    pos_inds = (gt == 1.0).to(pred.dtype)
    neg_inds = (gt < 1.0).to(pred.dtype)
    neg_weights = torch.pow(1 - gt, 4)
    pos_sum = (torch.log(pred) * torch.pow(1 - pred, 2) * pos_inds).sum()
    neg_sum = (torch.log(1 - pred) * torch.pow(pred, 2) * neg_weights * neg_inds).sum()
    num_pos = pos_inds.sum()
    return torch.where(num_pos == 0, -neg_sum, -(pos_sum + neg_sum) / num_pos.clamp(min=1.0))


def gather_feat(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """feat (B, HW, C), ind (B, K) -> (B, K, C)."""
    return torch.gather(feat, 1, ind.long()[..., None].expand(-1, -1, feat.shape[-1]))


def centernet_reg_loss(pred: torch.Tensor, mask: torch.Tensor,
                       target: torch.Tensor) -> torch.Tensor:
    """Masked L1 over gathered object slots. pred and target (B, K, D), mask
    (B, K) -> (D,): summed over batch and objects, divided by max(sum(mask), 1)."""
    num = mask.to(pred.dtype).sum()
    m = mask[..., None].to(pred.dtype) * (~torch.isnan(target)).to(pred.dtype)
    target = torch.nan_to_num(target)
    loss = (pred * m - target * m).abs().sum(dim=(0, 1))
    return loss / num.clamp(min=1.0)
