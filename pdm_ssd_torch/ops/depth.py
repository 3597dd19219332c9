"""Categorical-depth supervision for CaDDN (counterpart of
`pdm_ssd_tpu/ops/depth.py`): the depth discretizations (UD, LID, SID), the
foreground mask of the 2D ground-truth boxes and the DDN loss, a focal loss
over D+1 depth bins with the foreground / background balancer.

Plain PyTorch on every device: small elementwise passes over (B, H, W, D+1).
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F


def bin_depths(depth_map: torch.Tensor, mode: str = 'LID', depth_min: float = 2.0,
               depth_max: float = 46.8, num_bins: int = 80, target: bool = False) -> torch.Tensor:
    """Depths -> fractional bin indices. With `target`, a depth out of range
    or not finite takes the index `num_bins` (the "beyond range" class) and
    the result is int64 (the JAX package's is int32)."""
    if mode == 'UD':
        bin_size = (depth_max - depth_min) / num_bins
        indices = (depth_map - depth_min) / bin_size
    elif mode == 'LID':
        bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
        indices = -0.5 + 0.5 * torch.sqrt(torch.clamp(1 + 8 * (depth_map - depth_min) / bin_size,
                                                      min=0.0))
    elif mode == 'SID':
        indices = num_bins * (torch.log(1 + depth_map) - math.log(1 + depth_min)) \
            / (math.log(1 + depth_max) - math.log(1 + depth_min))
    else:
        raise NotImplementedError(mode)
    if target:
        bad = (indices < 0) | (indices > num_bins) | ~torch.isfinite(indices) \
            | (depth_map < depth_min)
        # float32 -> int truncates toward zero, as XLA's convert does
        return torch.where(bad, torch.full_like(indices, num_bins), indices).long()
    return indices


def compute_fg_mask(gt_boxes2d: torch.Tensor, shape: tuple, downsample_factor: int = 1,
                    box_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(B, H, W) bool: the cells inside any 2D box (B, N, 4) [u1, v1, u2, v2]
    of full-image pixels, the boxes divided by `downsample_factor`, floored
    at their low edges and ceiled at their high ones. `box_mask` (B, N)
    names the real boxes (default: those not all zero)."""
    B, H, W = shape
    boxes = gt_boxes2d / downsample_factor
    u1, v1 = torch.floor(boxes[..., 0]), torch.floor(boxes[..., 1])
    u2, v2 = torch.ceil(boxes[..., 2]), torch.ceil(boxes[..., 3])
    if box_mask is None:
        box_mask = (gt_boxes2d != 0).any(dim=-1)
    dev = gt_boxes2d.device
    uu = torch.arange(W, device=dev)[None, None, :, None]
    vv = torch.arange(H, device=dev)[None, :, None, None]
    inside = (uu >= u1[:, None, None, :]) & (uu < u2[:, None, None, :]) \
        & (vv >= v1[:, None, None, :]) & (vv < v2[:, None, None, :]) \
        & box_mask[:, None, None, :]
    return inside.any(dim=-1)


def ddn_loss(depth_logits: torch.Tensor, depth_maps: torch.Tensor, gt_boxes2d: torch.Tensor,
             box_mask: torch.Tensor | None = None, weight: float = 3.0, alpha: float = 0.25,
             gamma: float = 2.0, fg_weight: float = 13.0, bg_weight: float = 1.0,
             downsample_factor: int = 1, disc_cfg: dict | None = None) -> tuple:
    """The focal loss -alpha (1 - p_t)^gamma log p_t over D+1 depth bins,
    weighted `fg_weight` inside the 2D boxes and `bg_weight` outside, each
    part summed and divided by the cell count, their sum times `weight`.

    depth_logits (B, H, W, D+1); depth_maps (B, H, W) metres at the logits'
    resolution; gt_boxes2d (B, N, 4) in full-image pixels. Returns (loss,
    {'ddn_loss', 'ddn_fg_loss', 'ddn_bg_loss'})."""
    disc_cfg = disc_cfg or {}
    num_bins = depth_logits.shape[-1] - 1
    target = bin_depths(depth_maps, mode=disc_cfg.get('mode', 'LID'),
                        depth_min=disc_cfg.get('depth_min', 2.0),
                        depth_max=disc_cfg.get('depth_max', 46.8), num_bins=num_bins,
                        target=True)
    logp = F.log_softmax(depth_logits, dim=-1)
    logp_t = torch.gather(logp, -1, target[..., None])[..., 0]
    p_t = torch.exp(logp_t)
    loss = -alpha * torch.pow(1.0 - p_t, gamma) * logp_t                  # (B, H, W)
    fg = compute_fg_mask(gt_boxes2d, tuple(loss.shape), downsample_factor, box_mask)
    weights = torch.where(fg, fg_weight, bg_weight)
    num_pixels = float(loss.numel())
    fg_loss = torch.where(fg, loss * weights, 0.0).sum() / num_pixels
    bg_loss = torch.where(fg, 0.0, loss * weights).sum() / num_pixels
    total = (fg_loss + bg_loss) * weight
    return total, {'ddn_loss': total, 'ddn_fg_loss': fg_loss, 'ddn_bg_loss': bg_loss}
