"""Seeded synthetic inputs and random models for smoke and profile runs on
the card, where there is no dataset and no trained checkpoint."""
from __future__ import annotations

import numpy as np
import torch


def kitti_points(B: int, N: int, seed: int) -> np.ndarray:
    """Uniform clouds over the KITTI range, (B, N, 4) float32: x, y, z, intensity."""
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(0, 70.4, (B, N)), rng.uniform(-40, 40, (B, N)),
                     rng.uniform(-3, 1, (B, N)), rng.rand(B, N)], axis=-1).astype(np.float32)


def kitti_batch(B: int, N: int, M: int = 8, seed: int = 0) -> dict:
    """A training batch: 'points' as `kitti_points`, 'gt_boxes' (B, M, 8) of
    car-sized boxes with a uniform heading and a class in 1..3 last, and
    'gt_mask' (B, M) all true. The same numbers from the same seed as the JAX
    package's dry-run batch."""
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.uniform(0, 70.4, (B, N)), rng.uniform(-40, 40, (B, N)),
                    rng.uniform(-3, 1, (B, N)), rng.rand(B, N)], axis=-1).astype(np.float32)
    gt = np.zeros((B, M, 8), np.float32)
    gt[:, :, 0] = rng.uniform(5, 60, (B, M))
    gt[:, :, 1] = rng.uniform(-30, 30, (B, M))
    gt[:, :, 2] = -1.0
    gt[:, :, 3:6] = [3.9, 1.6, 1.56]
    gt[:, :, 6] = rng.uniform(-np.pi, np.pi, (B, M))
    gt[:, :, 7] = rng.randint(1, 4, (B, M))
    return {'points': pts, 'gt_boxes': gt, 'gt_mask': np.ones((B, M), bool)}


def tiny_flagship_cfg(cfg):
    """Shrink the flagship config in place to the dry run's size: the same
    path (fused SA, PDM neck, hybrid head), narrow and shallow."""
    sa = cfg.MODEL.BACKBONE_3D.SA_CONFIG
    sa.NPOINTS = [256, 64, 32]
    sa.MLPS = [[[8, 8, 16], [8, 8, 16]], [[16, 16, 32], [16, 16, 32]],
               [[32, 32, 64], [32, 32, 64]]]
    neck = cfg.MODEL.PDM_NECK
    neck.BEV_SIZE = [44, 50]
    neck.VOXEL_SIZE = [1.6, 1.6, 1.0]
    neck.NUM_BEV_FEATURES = 16
    nms = cfg.MODEL.POST_PROCESSING.NMS_CONFIG
    nms.NMS_PRE_MAXSIZE = 64
    nms.NMS_POST_MAXSIZE = 32
    cfg.MODEL.DENSE_HEAD.POST_PROCESSING.MAX_OBJ_PER_SAMPLE = 32
    return cfg


def tiny_pointrcnn_cfg(cfg):
    """Shrink `configs/kitti_models/pointrcnn.yaml` in place to the dry run's
    size: the same path (non-fused SA with three sampling methods, FP modules,
    point head, proposal NMS, canonical ROI head), narrow and with few points.
    The FP list keeps its length."""
    bb = cfg.MODEL.BACKBONE_3D
    bb.SA_CONFIG.NPOINTS = [128, 48, 16]
    bb.SA_CONFIG.NSAMPLE = [[6, 8], [6, 8], [6, 8]]
    bb.SA_CONFIG.RADIUS = [[2.0, 4.0], [4.0, 8.0], [8.0, 16.0]]
    bb.SA_CONFIG.MLPS = [[[8, 8], [8, 12]], [[12, 16], [12, 16]], [[16, 24], [16, 24]]]
    bb.FP_MLPS = [[12, 12], [16, 16], [16, 16]][:len(bb.FP_MLPS)]
    cfg.MODEL.POINT_HEAD.CLS_FC = [16]
    cfg.MODEL.POINT_HEAD.REG_FC = [16]
    roi = cfg.MODEL.ROI_HEAD
    roi.ROI_POINT_POOL.NUM_SAMPLED_POINTS = 32
    roi.XYZ_UP_LAYER = [16, 8]
    roi.SA_CONFIG.NPOINTS = [16, 8, -1]
    roi.SA_CONFIG.RADIUS = [0.5, 1.0, 100]
    roi.SA_CONFIG.NSAMPLE = [8, 8, 8]
    roi.SA_CONFIG.MLPS = [[16, 16], [16, 16], [16, 32]]
    roi.CLS_FC = [16]
    roi.REG_FC = [16]
    for mode in ('TRAIN', 'TEST'):
        roi.NMS_CONFIG[mode].NMS_PRE_MAXSIZE = 64
        roi.NMS_CONFIG[mode].NMS_POST_MAXSIZE = 16
    nms = cfg.MODEL.POST_PROCESSING.NMS_CONFIG
    nms.NMS_PRE_MAXSIZE = 16
    nms.NMS_POST_MAXSIZE = 16
    return cfg


# the dry run's shrink of each model that has one, by `MODEL.NAME`
TINY_CFGS = {'PDMSSD': tiny_flagship_cfg, 'PointRCNN': tiny_pointrcnn_cfg}


def pointrcnn_fp3(cfg):
    """Make the FP list of `configs/kitti_models/pointrcnn.yaml` whole, in
    place: the file has three SA levels and two `FP_MLPS`, so its backbone
    never propagates to the densest level and hands the heads the raw
    1-channel input features. With a third entry the 128-channel features
    reach every input point, as `num_point_features` of the JAX package's
    backbone assumes. All other widths stay the file's."""
    from .config import cfg_from_list
    cfg_from_list(['MODEL.BACKBONE_3D.FP_MLPS', '[[128, 128], [256, 256], [256, 256]]'], cfg)
    return cfg


def randomize_bn(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Draw every BatchNorm's scale, shift and running statistics (fresh
    statistics of mean 0 and variance 1 would hide eps and layout errors)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(n, generator=gen) * 0.2)
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.3)
                m.running_var.copy_(torch.rand(n, generator=gen) * 1.7 + 0.3)


def random_model(cfg, device=None, seed: int = 0) -> torch.nn.Module:
    """The detector of a full config (`MODEL`, `CLASS_NAMES`, `DATA_CONFIG`)
    with seeded weights and BatchNorm statistics, in eval mode."""
    from ..models import build_network
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device=device,
                        seed=seed)
    randomize_bn(net, torch.Generator().manual_seed(seed + 1))
    return net
