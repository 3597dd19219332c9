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


LARGE_RANGE = (-75.2, -75.2, -3.0, 75.2, 75.2, 3.0)


def large_scene_points(B: int, N: int, seed: int) -> np.ndarray:
    """Uniform clouds over the range of `configs/kitti_models/pdm_ssd_large.yaml`
    (+-75.2 m around the sensor, z in [-3, 1)), (B, N, 4) float32: x, y, z,
    intensity."""
    rng = np.random.RandomState(seed)
    x0, y0, _, x1, y1, _ = LARGE_RANGE
    return np.stack([rng.uniform(x0, x1, (B, N)), rng.uniform(y0, y1, (B, N)),
                     rng.uniform(-3, 1, (B, N)), rng.rand(B, N)], axis=-1).astype(np.float32)


def lidar_points(B: int, N: int, seed: int,
                 pc_range=(0.0, -40.0, -3.0, 70.4, 40.0, 1.0)) -> np.ndarray:
    """Clouds that look like a LiDAR scan to a voxel grid, (B, N, 4) float32:
    65% of the points on a ground plane 1.73 m below the sensor, dense near it
    (range 2.5 m plus an exponential of mean 4 m, over 120 degrees), 30% on
    two vertical faces of 40 car-sized boxes, shared by 1 / range^2, and 5%
    scattered over the whole range. Surfaces voxelize to sheets, which a
    strided sparse conv shrinks, while scattered voxels each grow into up to 8
    output sites: at 0.05 m voxels 50000 such points fill about 35000 cells
    and every stage of the KITTI ladder stays inside the capacities of
    `configs/kitti_models/second_sparse.yaml` (a uniform cloud overflows
    them, and the overflow is silently dropped)."""
    rng = np.random.RandomState(seed)
    x0, y0, _, x1, y1, _ = (float(v) for v in pc_range)
    n_boxes = 40
    out = np.zeros((B, N, 4), np.float32)
    for b in range(B):
        n_far, n_box = int(N * 0.05), int(N * 0.3)
        n_ground = N - n_far - n_box
        r = 2.5 + 4.0 * rng.exponential(1.0, n_ground)
        th = rng.uniform(-np.pi / 3, np.pi / 3, n_ground)
        ground = np.stack([r * np.cos(th), r * np.sin(th),
                           -1.73 + 0.02 * rng.randn(n_ground)], -1)
        far = np.stack([rng.uniform(x0, x1, n_far), rng.uniform(y0, y1, n_far),
                        rng.uniform(-2.0, 0.5, n_far)], -1)
        centers = np.stack([rng.uniform(x0 + 4, x1 - 10, n_boxes),
                            rng.uniform(0.75 * y0, 0.75 * y1, n_boxes)], -1)
        share = 1.0 / (centers ** 2).sum(-1)
        which = rng.choice(n_boxes, n_box, p=share / share.sum())
        yaw = rng.uniform(-np.pi, np.pi, n_boxes)[which]
        u, v = rng.uniform(-0.5, 0.5, n_box), rng.uniform(0, 1, n_box)
        long_face = rng.rand(n_box) < 0.5
        lx = np.where(long_face, u * 3.9, -1.95)
        ly = np.where(long_face, -0.8, u * 1.6)
        box = np.stack([centers[which, 0] + lx * np.cos(yaw) - ly * np.sin(yaw),
                        centers[which, 1] + lx * np.sin(yaw) + ly * np.cos(yaw),
                        -1.73 + v * 1.56], -1)
        pts = np.concatenate([ground, far, box])
        out[b, :, :3] = pts[rng.permutation(N)]
        out[b, :, 3] = rng.rand(N)
    return out


def voxel_processor(cfg):
    """The `transform_points_to_voxels` entry of a config's DATA_PROCESSOR."""
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.get('NAME') == 'transform_points_to_voxels':
            return proc
    raise ValueError('the config voxelizes no points')


def voxel_batch(B: int, N: int, cfg, seed: int = 0, device='cpu') -> dict:
    """A serving batch of a voxel model: seeded `lidar_points` on `device`,
    voxelized there as the config's processor says (its test-time voxel cap):
    'points', 'voxels', 'voxel_coords', 'voxel_num_points', 'voxel_mask'."""
    from ..ops.voxelize import voxelize_batch
    proc = voxel_processor(cfg)
    pc_range = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
    pts = torch.from_numpy(lidar_points(B, N, seed, pc_range)).to(device)
    batch = voxelize_batch(pts, pc_range, list(proc.VOXEL_SIZE), int(proc.MAX_POINTS_PER_VOXEL),
                           int(proc.MAX_NUMBER_OF_VOXELS['test']))
    batch['points'] = pts
    return batch


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


def tiny_grid_cfg(cfg):
    """Shrink `configs/kitti_models/pdm_ssd.yaml` in place to the size of the
    JAX package's flip-TTA test (`tests/test_tta_flip.py`): the same path
    (pillarize, GridPointBackbone, PDMNeckConv, CenterHead, circle NMS) on a
    44 x 50 grid of 1.6 m cells, whose levels are 44 x 50, 22 x 25 and
    11 x 13 (odd sizes under stride 2), narrow."""
    bb = cfg.MODEL.BACKBONE_3D
    bb.CELL_SIZE = 1.6
    bb.GRID_SIZE = [44, 50]
    bb.NUM_FILTERS = [8, 8, 16]
    neck = cfg.MODEL.PDM_NECK
    neck.BEV_SIZE = [22, 25]
    neck.VOXEL_SIZE = [3.2, 3.2, 1.0]
    neck.NUM_BEV_FEATURES = 8
    nms = cfg.MODEL.POST_PROCESSING.NMS_CONFIG
    nms.NMS_PRE_MAXSIZE = 64
    nms.NMS_POST_MAXSIZE = 16
    cfg.MODEL.DENSE_HEAD.POST_PROCESSING.MAX_OBJ_PER_SAMPLE = 16
    return cfg


def tiny_large_cfg(cfg):
    """Shrink `configs/kitti_models/pdm_ssd_large.yaml` in place as
    `tiny_grid_cfg` shrinks its base, over the file's +-75.2 m range: a
    47 x 47 grid of 3.2 m cells (levels 47, 24 and 12 cells a side)."""
    tiny_grid_cfg(cfg)
    cfg.MODEL.BACKBONE_3D.CELL_SIZE = 3.2
    cfg.MODEL.BACKBONE_3D.GRID_SIZE = [47, 47]
    cfg.MODEL.PDM_NECK.BEV_SIZE = [24, 24]
    cfg.MODEL.PDM_NECK.VOXEL_SIZE = [6.4, 6.4, 1.5]
    return cfg


def tiny_pdmssd_cfg(cfg):
    """The shrink of a PDMSSD config: the grid family's by its range, the
    point-exact one's (`tiny_flagship_cfg`) otherwise."""
    if cfg.MODEL.BACKBONE_3D.get('NAME') != 'GridPointBackbone':
        return tiny_flagship_cfg(cfg)
    if cfg.DATA_CONFIG.POINT_CLOUD_RANGE[0] < 0:
        return tiny_large_cfg(cfg)
    return tiny_grid_cfg(cfg)


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


def tiny_second_cfg(cfg):
    """Shrink `configs/kitti_models/second_sparse.yaml` in place to the dry
    run's size: the same path (MeanVFE, the sparse ladder with its 12 layers,
    BEV convs, anchor head) on a 64 x 64 x 40 grid of 256 voxel slots (two z
    layers reach the BEV map, as at full size), narrow and shallow. The ladder's capacities become the defaults for 256 slots."""
    ds = cfg.DATA_CONFIG
    ds.POINT_CLOUD_RANGE = [0, -16, -3, 32, 16, 1]
    proc = voxel_processor(cfg)
    proc.VOXEL_SIZE = [0.5, 0.5, 0.1]
    proc.MAX_NUMBER_OF_VOXELS = {'train': 256, 'test': 256}
    bb = cfg.MODEL.BACKBONE_3D
    bb.NUM_FILTERS = [4, 8, 8, 8]
    bb.OUT_FEATURES = 8
    bb.pop('ACTIVE_CAPS', None)
    b2 = cfg.MODEL.BACKBONE_2D
    b2.LAYER_NUMS = [1, 1]
    b2.NUM_FILTERS = [16, 32]
    b2.NUM_UPSAMPLE_FILTERS = [16, 16]
    nms = cfg.MODEL.POST_PROCESSING.NMS_CONFIG
    nms.NMS_PRE_MAXSIZE = 32
    nms.NMS_POST_MAXSIZE = 16
    return cfg


# the dry run's shrink of each model that has one, by `MODEL.NAME`
TINY_CFGS = {'PDMSSD': tiny_pdmssd_cfg, 'PointRCNN': tiny_pointrcnn_cfg,
             'SECONDNet': tiny_second_cfg}


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


def open_score_gate(net: torch.nn.Module) -> torch.nn.Module:
    """Set the classification bias of a model's dense head to 0, in place:
    an anchor head's (it starts at -log(99), as in the JAX package, so a
    seeded model scores every anchor near 0.01, below any SCORE_THRESH, and
    its NMS sees no candidate) or a heatmap head's (it starts at -2.19,
    scores near 0.1, at the SCORE_THRESH of the PDM configs). At 0 the
    scores spread around 0.5 and post-processing does the work it does for a
    trained model."""
    head = net.dense_head
    with torch.no_grad():
        (head.conv_cls if hasattr(head, 'conv_cls') else head.head.hm_out).bias.zero_()
    return net


def random_model(cfg, device=None, seed: int = 0) -> torch.nn.Module:
    """The detector of a full config (`MODEL`, `CLASS_NAMES`, `DATA_CONFIG`)
    with seeded weights and BatchNorm statistics, in eval mode."""
    from ..models import build_network
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device=device,
                        seed=seed)
    randomize_bn(net, torch.Generator().manual_seed(seed + 1))
    return net
