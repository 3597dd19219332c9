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


NUSCENES_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
NUSCENES_CLASSES = ('car', 'truck', 'construction_vehicle', 'bus', 'trailer', 'barrier',
                    'motorcycle', 'bicycle', 'pedestrian', 'traffic_cone')
# (dx, dy, dz) in metres of a box of each nuScenes class, 1-indexed in
# NUSCENES_CLASSES order: sizes near the class means of the nuScenes train
# split (rounded)
NUSCENES_SIZES = {1: (4.63, 1.97, 1.74), 2: (6.93, 2.51, 2.84), 3: (6.37, 2.85, 3.19),
                  4: (10.5, 2.94, 3.47), 5: (12.29, 2.90, 3.87), 6: (0.50, 2.53, 0.98),
                  7: (2.11, 0.77, 1.47), 8: (1.70, 0.60, 1.28), 9: (0.73, 0.67, 1.77),
                  10: (0.41, 0.41, 1.07)}


def nuscenes_points(B: int, N: int, seed: int, sweeps: int = 10) -> np.ndarray:
    """Clouds like a 10-sweep nuScenes LiDAR scan over +-51.2 m, (B, N, 5)
    float32: x, y, z, intensity and the time lag of the sweep a point came
    from (0 to 0.45 s in steps of 0.05 s). 60% of the points on a ground
    plane 1.84 m below the sensor, all round it (range 1 m plus an
    exponential of mean 12 m), 30% on two vertical faces of 60 car-sized
    boxes, 10% scattered over the range."""
    rng = np.random.RandomState(seed)
    x0, y0, _, x1, y1, _ = NUSCENES_RANGE
    out = np.zeros((B, N, 5), np.float32)
    n_boxes = 60
    for b in range(B):
        n_far, n_box = int(N * 0.1), int(N * 0.3)
        n_ground = N - n_far - n_box
        r = np.minimum(1.0 + 12.0 * rng.exponential(1.0, n_ground), 70.0)
        th = rng.uniform(-np.pi, np.pi, n_ground)
        ground = np.stack([r * np.cos(th), r * np.sin(th),
                           -1.84 + 0.03 * rng.randn(n_ground)], -1)
        far = np.stack([rng.uniform(x0, x1, n_far), rng.uniform(y0, y1, n_far),
                        rng.uniform(-2.0, 1.0, n_far)], -1)
        centers = np.stack([rng.uniform(x0 + 5, x1 - 5, n_boxes),
                            rng.uniform(y0 + 5, y1 - 5, n_boxes)], -1)
        which = rng.randint(0, n_boxes, n_box)
        yaw = rng.uniform(-np.pi, np.pi, n_boxes)[which]
        u, v = rng.uniform(-0.5, 0.5, n_box), rng.uniform(0, 1, n_box)
        long_face = rng.rand(n_box) < 0.5
        lx = np.where(long_face, u * 4.6, -2.3)
        ly = np.where(long_face, -1.0, u * 2.0)
        box = np.stack([centers[which, 0] + lx * np.cos(yaw) - ly * np.sin(yaw),
                        centers[which, 1] + lx * np.sin(yaw) + ly * np.cos(yaw),
                        -1.84 + v * 1.74], -1)
        pts = np.concatenate([ground, far, box])
        out[b, :, :3] = pts[rng.permutation(N)]
        out[b, :, 3] = rng.rand(N)
        out[b, :, 4] = rng.randint(0, sweeps, N) * 0.05
    return out


def nuscenes_batch(B: int, N: int, M: int = 8, seed: int = 0, velocity: bool = False) -> dict:
    """A training batch of a nuScenes config: `nuscenes_points` and M boxes a
    cloud of the 10 classes in turn, at their mean sizes, within +-40 m;
    with `velocity` the boxes carry vx, vy (m/s) before the class, as
    PRED_VELOCITY keeps them. Numpy."""
    rng = np.random.RandomState(seed + 1)
    E = 2 if velocity else 0
    gt = np.zeros((B, M, 8 + E), np.float32)
    gt[..., 0:2] = rng.uniform(-40, 40, (B, M, 2))
    cls = (np.arange(B * M).reshape(B, M) % 10) + 1
    gt[..., 3:6] = np.array([NUSCENES_SIZES[c] for c in cls.ravel()]).reshape(B, M, 3)
    gt[..., 2] = -1.84 + gt[..., 5] / 2
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (B, M))
    if velocity:
        gt[..., 7:9] = rng.normal(0, 3, (B, M, 2))
    gt[..., -1] = cls
    return {'points': nuscenes_points(B, N, seed), 'gt_boxes': gt,
            'gt_mask': np.ones((B, M), bool)}


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


def voxel_batch(B: int, N: int, cfg, seed: int = 0, device='cpu', mode: str = 'test') -> dict:
    """A serving batch of a voxel model: seeded `lidar_points` on `device`,
    voxelized there as the config's processor says (its voxel cap of `mode`,
    'test' by default): 'points', 'voxels', 'voxel_coords',
    'voxel_num_points', 'voxel_mask'."""
    from ..ops.voxelize import voxelize_batch
    proc = voxel_processor(cfg)
    pc_range = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
    pts = torch.from_numpy(lidar_points(B, N, seed, pc_range)).to(device)
    batch = voxelize_batch(pts, pc_range, list(proc.VOXEL_SIZE), int(proc.MAX_POINTS_PER_VOXEL),
                           int(proc.MAX_NUMBER_OF_VOXELS[mode]))
    batch['points'] = pts
    return batch


# (dx, dy, dz) of the KITTI classes, as the anchors of
# `configs/kitti_models/second_sparse.yaml` size them
CLASS_SIZES = {1: (3.9, 1.6, 1.56), 2: (0.8, 0.6, 1.73), 3: (1.76, 0.6, 1.73)}


def gt_boxes(B: int, M: int, pc_range, seed: int) -> np.ndarray:
    """(B, M, 8) float32 ground truth: classes 1..3 drawn uniformly, each of
    its class's size, standing on the ground plane of `lidar_points` (1.73 m
    below the sensor), centers uniform over the range's inner 80 %, headings
    uniform."""
    rng = np.random.RandomState(seed)
    x0, y0, _, x1, y1, _ = (float(v) for v in pc_range)
    cls = rng.randint(1, 4, (B, M))
    size = np.array([CLASS_SIZES[c] for c in cls.reshape(-1)], np.float32).reshape(B, M, 3)
    out = np.zeros((B, M, 8), np.float32)
    out[..., 0] = rng.uniform(x0 + 0.1 * (x1 - x0), x1 - 0.1 * (x1 - x0), (B, M))
    out[..., 1] = rng.uniform(y0 + 0.1 * (y1 - y0), y1 - 0.1 * (y1 - y0), (B, M))
    out[..., 2] = -1.73 + size[..., 2] / 2
    out[..., 3:6] = size
    out[..., 6] = rng.uniform(-np.pi, np.pi, (B, M))
    out[..., 7] = cls
    return out


def voxel_train_batch(B: int, N: int, cfg, M: int = 8, seed: int = 0, device='cpu') -> dict:
    """A training batch of a voxel model: `voxel_batch` at the train-time
    voxel cap, plus 'gt_boxes' (B, M, 8) of `gt_boxes` and 'gt_mask' (B, M),
    all true."""
    batch = voxel_batch(B, N, cfg, seed, device, mode='train')
    boxes = gt_boxes(B, M, cfg.DATA_CONFIG.POINT_CLOUD_RANGE, seed + 1)
    batch['gt_boxes'] = torch.from_numpy(boxes).to(device)
    batch['gt_mask'] = torch.ones((B, M), dtype=torch.bool, device=device)
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
    if cfg.DATA_CONFIG.get('DATASET') == 'NuScenesDataset':
        return tiny_nuscenes_cfg(cfg)
    if cfg.DATA_CONFIG.POINT_CLOUD_RANGE[0] < 0:
        return tiny_large_cfg(cfg)
    return tiny_grid_cfg(cfg)


def tiny_nuscenes_cfg(cfg):
    """Shrink `configs/nuscenes_models/pdm_ssd_nuscenes.yaml` in place as
    `tiny_grid_cfg` shrinks its KITTI counterpart, over its +-51.2 m range:
    a 32 x 32 grid of 3.2 m cells (levels 32, 16 and 8 cells a side), the
    head at 16 x 16 cells of 6.4 m, narrow."""
    bb = cfg.MODEL.BACKBONE_3D
    bb.CELL_SIZE = 3.2
    bb.GRID_SIZE = [32, 32]
    bb.NUM_FILTERS = [8, 8, 16]
    neck = cfg.MODEL.PDM_NECK
    neck.BEV_SIZE = [16, 16]
    neck.VOXEL_SIZE = [6.4, 6.4, 2.0]
    neck.NUM_BEV_FEATURES = 8
    cfg.MODEL.BACKBONE_2D.NUM_FILTERS = [16]
    cfg.MODEL.BACKBONE_2D.NUM_UPSAMPLE_FILTERS = [16]
    _tiny_center_head(cfg)
    return cfg


def multihead_variant(cfg, iou_rectify: bool = True):
    """`pdm_ssd_nuscenes.yaml` with `bevfusion.yaml`'s six head groups, 'vel'
    and 'iou' branches, IOU_REG_LOSS and PRED_VELOCITY (the velocity's two
    codes join the regression, code weight 1), in place; with
    `iou_rectify` the decode rectifies its scores by the 'iou' branch
    (IOU_RECTIFIER 0.5 for every class)."""
    head = cfg.MODEL.DENSE_HEAD
    head.CLASS_NAMES_EACH_HEAD = [['car'], ['truck', 'construction_vehicle'],
                                  ['bus', 'trailer'], ['barrier'], ['motorcycle', 'bicycle'],
                                  ['pedestrian', 'traffic_cone']]
    head.SEPARATE_HEAD_CFG.HEAD_ORDER = ['center', 'center_z', 'dim', 'rot', 'vel']
    head.SEPARATE_HEAD_CFG.HEAD_DICT['vel'] = {'out_channels': 2, 'num_conv': 2}
    head.SEPARATE_HEAD_CFG.HEAD_DICT['iou'] = {'out_channels': 1, 'num_conv': 2}
    head.IOU_REG_LOSS = True
    head.LOSS_CONFIG.LOSS_WEIGHTS['code_weights'] = [1.0] * 10
    if iou_rectify:
        head.POST_PROCESSING.USE_IOU_TO_RECTIFY_SCORE = True
        head.POST_PROCESSING.IOU_RECTIFIER = [0.5] * 10
    cfg.DATA_CONFIG.PRED_VELOCITY = True
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


def tiny_dense_second_cfg(cfg):
    """Shrink `configs/kitti_models/second.yaml` in place: the same path
    (MeanVFE, the dense ladder of seven 3D blocks, BEV convs, anchor head)
    on the tiny sparse SECOND's 32 x 32 x 4 m range at 0.5 x 0.5 x 0.2 m
    voxels, a 64 x 64 x 20 grid whose depth runs 20, 10, 5 and 3 (the odd
    stride-2 step of the file's grid) and 256 voxel slots, narrow."""
    ds = cfg.DATA_CONFIG
    ds.POINT_CLOUD_RANGE = [0, -16, -3, 32, 16, 1]
    proc = voxel_processor(cfg)
    proc.VOXEL_SIZE = [0.5, 0.5, 0.2]
    proc.MAX_NUMBER_OF_VOXELS = {'train': 256, 'test': 256}
    cfg.MODEL.BACKBONE_3D.NUM_FILTERS = [4, 8, 8, 8]
    b2 = cfg.MODEL.BACKBONE_2D
    b2.LAYER_NUMS = [1, 1]
    b2.NUM_FILTERS = [16, 32]
    b2.NUM_UPSAMPLE_FILTERS = [16, 16]
    nms = cfg.MODEL.POST_PROCESSING.NMS_CONFIG
    nms.NMS_PRE_MAXSIZE = 32
    nms.NMS_POST_MAXSIZE = 16
    return cfg


def tiny_second_focal_cfg(cfg):
    """Shrink `configs/kitti_models/second_focal.yaml` in place: the same
    path (MeanVFE, the focal ladder with its three focal layers and TOPK,
    BEV convs, anchor head) on the tiny sparse SECOND's 64 x 64 x 40 grid of
    256 voxel slots, narrow. The capacities become the JAX package's
    defaults for 256 slots: candidates [256, 512, 384, 256, 256], dilated
    tables [1024, 2048, 1536]."""
    tiny_second_cfg(cfg)
    cfg.MODEL.BACKBONE_3D.pop('FOCAL_ECAPS', None)
    return cfg


def tiny_secondnet_cfg(cfg):
    """The shrink of a SECONDNet config, by its backbone: the sparse ladder's
    (`tiny_second_cfg`), the focal one's (`tiny_second_focal_cfg`) or the
    dense one's (`tiny_dense_second_cfg`)."""
    name = cfg.MODEL.BACKBONE_3D.get('NAME', '')
    if name.startswith('Sparse'):
        return tiny_second_cfg(cfg)
    if name == 'VoxelBackBone8xFocal':
        return tiny_second_focal_cfg(cfg)
    return tiny_dense_second_cfg(cfg)


def tiny_voxelnext_cfg(cfg):
    """Shrink `configs/kitti_models/voxelnext.yaml` in place: the same path
    (MeanVFE, the sparse ladder, the BEV slot table, VoxelNeXtHead's 9-tap
    convs, circle NMS) on the tiny sparse SECOND's 64 x 64 x 40 grid of 256
    voxel slots (an 8 x 8 BEV grid at stride 8), narrow; the head's centre
    limit follows the range."""
    ds = cfg.DATA_CONFIG
    ds.POINT_CLOUD_RANGE = [0, -16, -3, 32, 16, 1]
    proc = voxel_processor(cfg)
    proc.VOXEL_SIZE = [0.5, 0.5, 0.1]
    proc.MAX_NUMBER_OF_VOXELS = {'train': 256, 'test': 256}
    bb = cfg.MODEL.BACKBONE_3D
    bb.NUM_FILTERS = [4, 8, 8, 8]
    bb.OUT_FEATURES = 8
    bb.pop('ACTIVE_CAPS', None)
    head = cfg.MODEL.DENSE_HEAD
    head.SHARED_CONV_CHANNEL = 8
    head.POST_PROCESSING.POST_CENTER_LIMIT_RANGE = [0, -16, -3, 32, 16, 1]
    head.POST_PROCESSING.MAX_OBJ_PER_SAMPLE = 16
    nms = cfg.MODEL.POST_PROCESSING.NMS_CONFIG
    nms.NMS_PRE_MAXSIZE = 32
    nms.NMS_POST_MAXSIZE = 16
    return cfg


def tiny_pointpillar_cfg(cfg):
    """Shrink `configs/kitti_models/pointpillar.yaml` in place: the same path
    (PillarVFE, PointPillarScatter, the three-level BEV backbone, anchor
    head) on a 32 x 32 grid of 1 m pillars of up to 32 points, 256 pillar
    slots, narrow and shallow."""
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = [0, -16, -3, 32, 16, 1]
    proc = voxel_processor(cfg)
    proc.VOXEL_SIZE = [1.0, 1.0, 4.0]
    proc.MAX_NUMBER_OF_VOXELS = {'train': 256, 'test': 256}
    cfg.MODEL.VFE.NUM_FILTERS = [16]
    cfg.MODEL.MAP_TO_BEV.NUM_BEV_FEATURES = 16
    b2 = cfg.MODEL.BACKBONE_2D
    b2.LAYER_NUMS = [1, 1, 1]
    b2.NUM_FILTERS = [16, 16, 32]
    b2.NUM_UPSAMPLE_FILTERS = [16, 16, 16]
    nms = cfg.MODEL.POST_PROCESSING.NMS_CONFIG
    nms.NMS_PRE_MAXSIZE = 64
    nms.NMS_POST_MAXSIZE = 16
    return cfg


def _tiny_center_head(cfg):
    cfg.MODEL.DENSE_HEAD.SHARED_CONV_CHANNEL = 8
    cfg.MODEL.DENSE_HEAD.POST_PROCESSING.MAX_OBJ_PER_SAMPLE = 16
    nms = cfg.MODEL.POST_PROCESSING.NMS_CONFIG
    nms.NMS_PRE_MAXSIZE = 64
    nms.NMS_POST_MAXSIZE = 16


def _grid_processor(cfg):
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.get('NAME') == 'calculate_grid_size':
            return proc
    raise ValueError('the config sets no grid')


def tiny_centerpoint_pillar_cfg(cfg):
    """Shrink `configs/kitti_models/centerpoint_pillar.yaml` in place: the
    same path (DynamicPillarVFE, the two-level BEV backbone, CenterHead,
    circle NMS) over the KITTI range on an 88 x 100 grid of 0.8 m pillars,
    narrow."""
    _grid_processor(cfg).VOXEL_SIZE = [0.8, 0.8, 4.0]
    b2 = cfg.MODEL.BACKBONE_2D
    b2.LAYER_NUMS = [1, 1]
    b2.NUM_FILTERS = [8, 16]
    b2.NUM_UPSAMPLE_FILTERS = [8, 8]
    _tiny_center_head(cfg)
    return cfg


def tiny_pillarnet_cfg(cfg):
    """Shrink `configs/kitti_models/pillarnet.yaml` in place: the same path
    (GridPointBackbone's four levels, the one-level BEV backbone with its
    2x deconv, CenterHead at stride 4, circle NMS) over the KITTI range on a
    176 x 200 grid of 0.4 m cells (levels down to 22 x 25), narrow."""
    _grid_processor(cfg).VOXEL_SIZE = [0.4, 0.4, 4.0]
    bb = cfg.MODEL.BACKBONE_3D
    bb.CELL_SIZE = 0.4
    bb.GRID_SIZE = [176, 200]
    bb.NUM_FILTERS = [8, 8, 16, 16]
    bb.LAYER_NUMS = [1, 1, 1, 1]
    b2 = cfg.MODEL.BACKBONE_2D
    b2.LAYER_NUMS = [1]
    b2.NUM_FILTERS = [16]
    b2.NUM_UPSAMPLE_FILTERS = [8]
    _tiny_center_head(cfg)
    return cfg


def _tiny_two_stage_common(cfg):
    """The first stage and ROI head shrink shared by PV-RCNN and Voxel R-CNN,
    after the JAX package's zoo test (`tests/test_detector3d_zoo.py`): the
    tiny SECOND's 32 x 32 x 4 m range at its ladder's voxel size, 256 voxel
    slots, a one-level BEV backbone, a GRID_SIZE 3 lattice, 16 ROIs a cloud.
    The sparse ladder keeps XWIN (an exact gather order) and drops
    TABLE_DTYPE, which the port does not take (it stays in float32)."""
    ds = cfg.DATA_CONFIG
    ds.POINT_CLOUD_RANGE = [0, -16, -3, 32, 16, 1]
    proc = voxel_processor(cfg)
    sparse = cfg.MODEL.BACKBONE_3D.get('NAME', '').startswith('Sparse')
    proc.VOXEL_SIZE = [0.5, 0.5, 0.1] if sparse else [0.5, 0.5, 0.2]
    proc.MAX_NUMBER_OF_VOXELS = {'train': 256, 'test': 256}
    bb = cfg.MODEL.BACKBONE_3D
    bb.NUM_FILTERS = [4, 8, 8, 8]
    if sparse:
        bb.OUT_FEATURES = 8
        bb.pop('ACTIVE_CAPS', None)
        bb.pop('TABLE_DTYPE', None)
    b2 = cfg.MODEL.BACKBONE_2D
    b2.LAYER_NUMS = [1]
    b2.LAYER_STRIDES = [1]
    b2.NUM_FILTERS = [16]
    b2.UPSAMPLE_STRIDES = [1]
    b2.NUM_UPSAMPLE_FILTERS = [16]
    roi = cfg.MODEL.ROI_HEAD
    roi.GRID_SIZE = 3
    roi.SHARED_FC = [32]
    roi.CLS_FC = [16]
    roi.REG_FC = [16]
    for mode in ('TRAIN', 'TEST'):
        roi.NMS_CONFIG[mode].NMS_PRE_MAXSIZE = 64
        roi.NMS_CONFIG[mode].NMS_POST_MAXSIZE = 16
    roi.TARGET_CONFIG.ROI_PER_IMAGE = 16
    nms = cfg.MODEL.POST_PROCESSING.NMS_CONFIG
    nms.NMS_PRE_MAXSIZE = 16
    nms.NMS_POST_MAXSIZE = 16
    return cfg


def tiny_pv_rcnn_cfg(cfg):
    """Shrink `configs/kitti_models/pv_rcnn.yaml` or `pv_rcnn_sparse.yaml` in
    place: the same path (MeanVFE, the dense or sparse ladder, the anchor
    proposals, VoxelSetAbstraction from the BEV map, x_conv3, x_conv4 and the
    raw points, PointHeadSimple on the features before fusion, the grid
    pool's two radii and its ROI head), 64 keypoints, narrow."""
    _tiny_two_stage_common(cfg)
    pfe = cfg.MODEL.PFE
    pfe.NUM_KEYPOINTS = 64
    pfe.NUM_OUTPUT_FEATURES = 16
    sa = pfe.SA_LAYER
    sa.raw_points.MLPS = [[8, 8], [8, 8]]
    sa.raw_points.POOL_RADIUS = [1.6, 3.2]
    sa.x_conv3.MLPS = [[16, 16]]
    sa.x_conv4.MLPS = [[16, 16]]
    cfg.MODEL.POINT_HEAD.CLS_FC = [16]
    roi = cfg.MODEL.ROI_HEAD
    roi.POOL_MAX_KEYPOINTS = 32
    roi.ROI_GRID_POOL.POOL_RADIUS = [1.6, 3.2]
    roi.ROI_GRID_POOL.NSAMPLE = [8, 8]
    roi.ROI_GRID_POOL.MLPS = [[16, 16], [16, 16]]
    return cfg


def tiny_voxel_rcnn_cfg(cfg):
    """Shrink `configs/kitti_models/voxel_rcnn.yaml` or
    `voxel_rcnn_sparse.yaml` in place: the same path (MeanVFE, the dense or
    sparse ladder, the anchor proposals, the voxel pools of x_conv2, x_conv3
    and x_conv4 and the ROI head), narrow."""
    _tiny_two_stage_common(cfg)
    pool = cfg.MODEL.ROI_HEAD.ROI_GRID_POOL
    for src in pool.FEATURES_SOURCE:
        pool[src].MLPS = [16, 16]
    return cfg


def tiny_second_iou_cfg(cfg):
    """Shrink `configs/kitti_models/second_iou.yaml` in place: the same path
    (MeanVFE, the dense ladder, the anchor proposals, SECONDHead's rotated
    BEV crop, its FC layers and IoU logit) on the two-stage shrink, a 3 x 3
    crop, narrow."""
    _tiny_two_stage_common(cfg)
    roi = cfg.MODEL.ROI_HEAD
    roi.ROI_GRID_POOL.GRID_SIZE = 3
    roi.IOU_FC = [16]
    return cfg


def tiny_parta2_cfg(cfg):
    """Shrink `configs/kitti_models/parta2.yaml` or `parta2_sparse.yaml` in
    place: the same path (MeanVFE, the dense or sparse UNet, the anchor
    proposals, the part head, both ROI-aware pools, the ROI convs and FC
    stacks) on the two-stage shrink, a 4^3 pool of up to 16 points, narrow
    (TABLE_DTYPE dropped, as for the other sparse shrinks). The anchors are
    8 x 8 x 2 m: a seeded head shrinks its boxes below a voxel of the shrink
    (0.5 m), and Part-A2's pools read the voxels inside a ROI only."""
    _tiny_two_stage_common(cfg)
    for anchor in cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG:
        anchor['anchor_sizes'] = [[8.0, 8.0, 2.0]]
        anchor['anchor_bottom_heights'] = [-2.0]
    cfg.MODEL.POINT_HEAD.CLS_FC = [8]
    cfg.MODEL.POINT_HEAD.PART_FC = [8]
    pool = cfg.MODEL.ROI_HEAD.ROI_AWARE_POOL
    pool.POOL_SIZE = 4
    pool.NUM_FEATURES = 8
    pool.MAX_POINTS = 16
    return cfg


def tiny_pv_rcnn_plusplus_cfg(cfg):
    """Shrink `configs/kitti_models/pv_rcnn_plusplus.yaml` or
    `pv_rcnn_plusplus_sparse.yaml` in place: PV-RCNN's shrink, with the
    proposals before the keypoints, sector FPS near them (six sectors) and
    the raw points through VectorPool (one radius, a 3^3 grid, 8 + 8
    channels)."""
    tiny_pv_rcnn_cfg(cfg)
    rp = cfg.MODEL.PFE.SA_LAYER.raw_points
    rp.MLPS = [[8, 8]]
    rp.POOL_RADIUS = [1.6]
    return cfg


def tiny_dsvt_cfg(cfg):
    """Shrink `configs/kitti_models/dsvt.yaml` in place: the same path
    (DynamicPillarVFE, both DSVT stages of two blocks, the stride-2 pool,
    CenterHead, circle NMS) over the KITTI range on an 88 x 100 grid of
    0.8 m pillars (H padded to 104 for the 8 x 8 windows), at the JAX
    package's zoo widths (D_MODEL [16, 16], NHEAD [2, 2])."""
    _grid_processor(cfg).VOXEL_SIZE = [0.8, 0.8, 4.0]
    b2 = cfg.MODEL.BACKBONE_2D
    b2.D_MODEL = [16, 16]
    b2.NHEAD = [2, 2]
    b2.DIM_FEEDFORWARD = [32, 32]
    _tiny_center_head(cfg)
    return cfg


def tiny_transfusion_cfg(cfg):
    """Shrink `configs/kitti_models/transfusion.yaml` in place: the same path
    (DynamicPillarVFE, the two-level BEV backbone, the query decoder, the
    host LAP) over the KITTI range on an 88 x 100 grid of 0.8 m pillars,
    narrow, at the JAX package's zoo widths (HIDDEN_CHANNEL 16,
    NUM_PROPOSALS 16, NUM_HEADS 2)."""
    _grid_processor(cfg).VOXEL_SIZE = [0.8, 0.8, 4.0]
    b2 = cfg.MODEL.BACKBONE_2D
    b2.LAYER_NUMS = [1, 1]
    b2.NUM_FILTERS = [8, 16]
    b2.NUM_UPSAMPLE_FILTERS = [8, 8]
    head = cfg.MODEL.DENSE_HEAD
    head.HIDDEN_CHANNEL = 16
    head.NUM_PROPOSALS = 16
    head.NUM_HEADS = 2
    return cfg


# the voxel step that `mppnet_16frame.yaml`'s data path lacks (its processor,
# from `waymo_dataset.yaml`, ends with `calculate_grid_size`, so MeanVFE finds
# no 'voxels'; ROADMAP Queue 3). The file's grid, 0.4 m over 150.4 m, gives
# a 47 x 47 BEV map, whose stride-2 level comes back from the 2x upsampling
# at 48 x 48 (the second fault there): 0.2 m in x and y is the nearest grid
# at which the shipped BEV backbone's levels line up (752 cells, a 94 x 94
# map), the file's 6 m in z; 5 points a voxel and 150000 voxel slots
WAYMO_VOXEL_STEP = {'NAME': 'transform_points_to_voxels', 'VOXEL_SIZE': [0.2, 0.2, 6.0],
                    'MAX_POINTS_PER_VOXEL': 5,
                    'MAX_NUMBER_OF_VOXELS': {'train': 150000, 'test': 150000}}


def waymo_voxel_step(cfg):
    """Replace a Waymo config's `calculate_grid_size` by WAYMO_VOXEL_STEP, in
    place, unless it voxelizes already; the model's widths stay the file's."""
    from .config import CfgNode
    ds = cfg.DATA_CONFIG
    if not voxelizes(cfg):
        ds.DATA_PROCESSOR = [p for p in ds.DATA_PROCESSOR if p.NAME != 'calculate_grid_size']
        ds.DATA_PROCESSOR.append(CfgNode(WAYMO_VOXEL_STEP))
    return cfg


def tiny_mppnet_cfg(cfg):
    """Shrink `configs/waymo_models/mppnet_16frame.yaml` or `mppnet_mini.yaml`
    in place: the same path (MeanVFE, the dense ladder, the anchor
    proposals, trajectories over 4 frames, the crops, the geometry and
    motion features, the trajectory branch, two groups of one encoder layer,
    the memory bank) on `mppnet_mini.yaml`'s 32 x 32 x 4 m range at its
    0.5 x 0.5 x 4 m voxels, 1024 voxel slots, 2048 points a cloud and 512 a
    frame, 16 proposals, 16 points a crop, a 2 x 2 x 2 proxy grid, narrow."""
    from .config import CfgNode
    ds = cfg.DATA_CONFIG
    ds.POINT_CLOUD_RANGE = [0, -16, -3, 32, 16, 1]
    ds.MAX_GT_BOXES = 16
    ds.SAMPLED_INTERVAL = CfgNode({'train': 1, 'test': 1})
    seq = ds.SEQUENCE_CONFIG
    seq.SAMPLE_OFFSET = [-3, 0]
    seq.NUM_POINTS_PER_FRAME = 512
    seq.MAX_PRED_BOXES = 16
    for proc in ds.DATA_PROCESSOR:
        if proc.NAME == 'sample_points':
            proc.NUM_POINTS = CfgNode({'train': 2048, 'test': 2048})
    waymo_voxel_step(cfg)
    proc = voxel_processor(cfg)
    proc.VOXEL_SIZE = [0.5, 0.5, 4.0]
    proc.MAX_NUMBER_OF_VOXELS = CfgNode({'train': 1024, 'test': 1024})
    cfg.MODEL.BACKBONE_3D.NUM_FILTERS = [4, 8, 8, 8]
    b2 = cfg.MODEL.BACKBONE_2D
    b2.LAYER_NUMS = [1, 1]
    b2.NUM_FILTERS = [16, 32]
    b2.NUM_UPSAMPLE_FILTERS = [16, 16]
    roi = cfg.MODEL.ROI_HEAD
    roi.NUM_FRAMES = 4
    roi.TRANS_INPUT = 32
    tr = roi.Transformer
    tr.num_lidar_points = 8
    tr.num_groups = 2
    tr.enc_layers = 1
    tr.nheads = 2
    roi.ROI_GRID_POOL.GRID_SIZE = 2
    roi.ROI_GRID_POOL.MLPS = [[16, 16]]
    for mode in ('TRAIN', 'TEST'):
        roi.NMS_CONFIG[mode].NMS_PRE_MAXSIZE = 64
        roi.NMS_CONFIG[mode].NMS_POST_MAXSIZE = 16
    roi.TARGET_CONFIG.ROI_PER_IMAGE = 16
    nms = cfg.MODEL.POST_PROCESSING.NMS_CONFIG
    nms.NMS_PRE_MAXSIZE = 64
    nms.NMS_POST_MAXSIZE = 16
    return cfg


def waymo_set(cfg, root, frames: int, training: bool = False, n_bg: int = 2000,
              seed: int = 0):
    """A `WaymoDataset` of `cfg` over a mini-Waymo set generated at `root`
    (one sequence of `frames` frames, `n_bg` background points a frame, the
    first of CLASS_NAMES for every object; made when `root` holds no set).
    Points the config's DATA_PATH at `root` and its ROI_BOXES_PATH at the
    set's `pred_boxes.pkl`, the offline proposals of USE_PREDBOX."""
    from pathlib import Path

    from ..datasets.waymo.synthetic import make_mini_waymo
    from ..datasets.waymo.waymo_dataset import WaymoDataset
    root = Path(root)
    if not (root / 'ImageSets' / 'val.txt').exists():
        make_mini_waymo(root, n_seq=1, n_frames=frames, n_bg=n_bg, seed=seed,
                        class_name=cfg.CLASS_NAMES[0])
    ds = cfg.DATA_CONFIG
    ds.DATA_PATH = str(root)
    ds.ROI_BOXES_PATH = {'train': str(root / 'pred_boxes.pkl'),
                         'test': str(root / 'pred_boxes.pkl')}
    return WaymoDataset(ds, list(cfg.CLASS_NAMES), training=training, root_path=root)


def waymo_batch(dataset, indices, device='cpu') -> dict:
    """The samples `indices` of a `WaymoDataset`, collated, as tensors on
    `device`: the model's inputs (the sequence keys among them) and the
    ground truth."""
    from ..runtime.trainer import DEVICE_KEYS, to_device_batch
    return to_device_batch(dataset.collate_batch([dataset[i] for i in indices]), device,
                           DEVICE_KEYS)


def bevfusion_grid(cfg):
    """Make `configs/nuscenes_models/bevfusion.yaml`'s three grids agree, in
    place (ROADMAP Queue 3: as shipped its 0.3 m pillars over +-51.2 m give
    341 cells a side, whose stride-2 BEV level comes back at 342, its
    +-54 m camera map of 180 cells lands in the LiDAR map's corner, and
    FEATURE_MAP_STRIDE 2 asks for a 170-cell target on a full-resolution
    map): the LiDAR range in x and y the camera map's XBOUND and YBOUND,
    pillars of 0.6 x 0.6 x 8 m (180 x 180, the camera map's size after its
    DOWNSAMPLE 2) and FEATURE_MAP_STRIDE 1. Every width stays the file's."""
    vt = cfg.MODEL.VTRANSFORM
    pc = list(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = [float(vt.XBOUND[0]), float(vt.YBOUND[0]), pc[2],
                                         float(vt.XBOUND[1]), float(vt.YBOUND[1]), pc[5]]
    voxel_processor(cfg).VOXEL_SIZE = [0.6, 0.6, 8.0]
    cfg.MODEL.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.FEATURE_MAP_STRIDE = 1
    return cfg


def tiny_bevfusion_cfg(cfg):
    """Shrink `configs/nuscenes_models/bevfusion.yaml` or `bevfusion_mini.yaml`
    in place to `bevfusion_mini.yaml`'s path at narrower widths: the 4-stage
    Swin (EMBED_DIM 8, one block in stages 1, 2 and 4, two in stage 3,
    windows of 4, drop path 0.1), the neck at 16, the Lift-Splat at 8
    channels over 64 x 96 images (8 x 12 feature cells, 8 depth bins) onto a
    32 x 32 grid of 1 m cells, 1 m pillars of 16 channels, the fuser at 24,
    one BEV level, one head group of all classes, circle NMS."""
    from .config import CfgNode
    ds = cfg.DATA_CONFIG
    ds.POINT_CLOUD_RANGE = [0, -16, -3, 32, 16, 1]
    ds.CAMERA_CONFIG.IMAGE.FINAL_DIM = [64, 96]
    proc = voxel_processor(cfg)
    proc.VOXEL_SIZE = [1.0, 1.0, 4.0]
    proc.MAX_POINTS_PER_VOXEL = 8
    proc.MAX_NUMBER_OF_VOXELS = CfgNode({'train': 256, 'test': 256})
    m = cfg.MODEL
    m.IMAGE_BACKBONE.update({'EMBED_DIM': 8, 'DEPTHS': [1, 1, 2, 1], 'NUM_HEADS': [1, 2, 4, 8],
                             'WINDOW_SIZE': 4, 'DROP_PATH_RATE': 0.1})
    m.NECK.update({'IN_CHANNELS': [16, 32, 64], 'OUT_CHANNELS': 16})
    m.VTRANSFORM.update({'IN_CHANNEL': 16, 'OUT_CHANNEL': 8, 'IMAGE_SIZE': [64, 96],
                         'FEATURE_SIZE': [8, 12], 'XBOUND': [0.0, 32.0, 1.0],
                         'YBOUND': [-16.0, 16.0, 1.0], 'ZBOUND': [-4.0, 4.0, 8.0],
                         'DBOUND': [1.0, 17.0, 2.0], 'DOWNSAMPLE': 1})
    m.VFE.NUM_FILTERS = [16]
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 16
    m.FUSER.OUT_CHANNEL = 24
    m.BACKBONE_2D.update({'LAYER_NUMS': [1], 'LAYER_STRIDES': [1], 'NUM_FILTERS': [16],
                          'UPSAMPLE_STRIDES': [1], 'NUM_UPSAMPLE_FILTERS': [16]})
    head = m.DENSE_HEAD
    head.CLASS_NAMES_EACH_HEAD = [list(cfg.CLASS_NAMES)]
    head.SHARED_CONV_CHANNEL = 16
    head.TARGET_ASSIGNER_CONFIG.FEATURE_MAP_STRIDE = 1
    head.TARGET_ASSIGNER_CONFIG.NUM_MAX_OBJS = 50
    head.POST_PROCESSING.POST_CENTER_LIMIT_RANGE = [-4.0, -20.0, -6.0, 36.0, 20.0, 4.0]
    head.POST_PROCESSING.MAX_OBJ_PER_SAMPLE = 50
    m.POST_PROCESSING.NMS_CONFIG = CfgNode({'NMS_TYPE': 'circle_nms', 'NMS_RADIUS': 0.8,
                                            'NMS_PRE_MAXSIZE': 32, 'NMS_POST_MAXSIZE': 16})
    return cfg


# a nuScenes rig's six cameras, by the yaw (degrees, counter-clockwise from
# the LiDAR's x axis) of each optical axis: front, front right, front left,
# back, back left, back right; their 1600 x 900 images and focal length
CAMERA_YAWS = (0.0, -55.0, 55.0, 180.0, 110.0, -110.0)
CAMERA_WH = (1600, 900)
CAMERA_FOCAL = 1266.0


def camera_rig(n_cam: int = 6, image_wh: tuple = CAMERA_WH) -> tuple:
    """(camera2lidar, camera_intrinsics, lidar2image), each (n_cam, 4, 4)
    float32, of the first `n_cam` cameras of CAMERA_YAWS: camera x right, y
    down, z along the optical axis, level, 0.3 m below the LiDAR; the
    intrinsics of an image of `image_wh` (the focal length CAMERA_FOCAL at
    1600 pixels wide, in proportion otherwise)."""
    W, H = image_wh
    f = CAMERA_FOCAL * W / CAMERA_WH[0]
    intr = np.eye(4, dtype=np.float32)
    intr[:3, :3] = [[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]
    c2l = np.zeros((n_cam, 4, 4), np.float32)
    for c, yaw in enumerate(CAMERA_YAWS[:n_cam]):
        a = np.radians(yaw)
        fwd, right = np.array([np.cos(a), np.sin(a), 0.0]), np.array([np.sin(a), -np.cos(a), 0.0])
        c2l[c, :3, :3] = np.stack([right, [0.0, 0.0, -1.0], fwd], axis=1)
        c2l[c, :3, 3] = [0.0, 0.0, -0.3]
        c2l[c, 3, 3] = 1.0
    intrinsics = np.repeat(intr[None], n_cam, axis=0)
    return c2l, intrinsics, (intrinsics @ np.linalg.inv(c2l)).astype(np.float32)


def camera_batch(B: int, N: int, cfg, seed: int = 0, n_cam: int = 6, M: int = 0,
                 device='cpu', mode: str = 'test', image_wh: tuple = CAMERA_WH) -> dict:
    """A BEVFusion batch of `cfg`: `nuscenes_points` over its range, voxelized
    as its processor says (the voxel cap of `mode`); `n_cam` cameras of
    `camera_rig` whose `image_wh` images were resized by the mean of
    RESIZE_LIM_TEST and cropped to FINAL_DIM as the test-time data path does
    ('img_aug_matrix'), seeded normal pixels ('camera_imgs', normalized
    images) and each camera's sparse depth map of the cloud
    (`camera_depth_map`); with M > 0 also M boxes a cloud of
    `nuscenes_batch`'s, the classes taken modulo the config's ('gt_boxes',
    'gt_mask'). Tensors on `device`."""
    from ..datasets.processor.data_processor import camera_depth_map
    from ..ops.voxelize import voxelize_batch
    iH, iW = (int(v) for v in cfg.DATA_CONFIG.CAMERA_CONFIG.IMAGE.FINAL_DIM)
    resize = float(np.mean(cfg.DATA_CONFIG.CAMERA_CONFIG.IMAGE.RESIZE_LIM_TEST))
    W0, H0 = image_wh
    newW, newH = int(W0 * resize), int(H0 * resize)
    aug = np.eye(4, dtype=np.float32)
    aug[:2, :2] *= resize
    aug[:2, 3] = [-int(max(0, newW - iW) / 2), -(newH - iH)]
    c2l, intr, l2i = camera_rig(n_cam, image_wh)
    raw = nuscenes_batch(B, N, max(M, 1), seed)
    pts = raw['points'][..., :int(cfg.DATA_CONFIG.get('NUM_POINT_FEATURES', 5))]
    depth = np.stack([camera_depth_map(p, l2i, np.repeat(aug[None], n_cam, 0), None, iH, iW)
                      for p in pts])
    rng = np.random.RandomState(seed + 2)
    batch = {'camera_imgs': rng.randn(B, n_cam, iH, iW, 3).astype(np.float32),
             'camera_depth': depth,
             'camera2lidar': np.repeat(c2l[None], B, 0),
             'camera_intrinsics': np.repeat(intr[None], B, 0),
             'img_aug_matrix': np.repeat(np.repeat(aug[None], n_cam, 0)[None], B, 0)}
    if M:
        gt = raw['gt_boxes'].copy()
        gt[..., -1] = (gt[..., -1] - 1) % len(cfg.CLASS_NAMES) + 1
        batch.update(gt_boxes=gt, gt_mask=raw['gt_mask'])
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
    proc = voxel_processor(cfg)
    p = torch.from_numpy(pts).to(device)
    out.update(voxelize_batch(p, cfg.DATA_CONFIG.POINT_CLOUD_RANGE, list(proc.VOXEL_SIZE),
                              int(proc.MAX_POINTS_PER_VOXEL),
                              int(proc.MAX_NUMBER_OF_VOXELS[mode])))
    out['points'] = p
    return out


# CaDDN's KITTI grid and frustum, from OpenPCDet's
# `tools/cfgs/kitti_models/CaDDN.yaml`: 0.16 m voxels over 2..46.8 m ahead,
# +-30.08 m across and -3..1 m up (280 x 376 x 25), 80 LID depth bins over the
# same depths
CADDN_RANGE = [2.0, -30.08, -3.0, 46.8, 30.08, 1.0]
CADDN_ANCHORS = [
    {'class_name': name, 'anchor_sizes': [list(size)], 'anchor_rotations': [0, 1.57],
     'anchor_bottom_heights': [bottom], 'align_center': False, 'feature_map_stride': 2,
     'matched_threshold': hi, 'unmatched_threshold': lo}
    for name, size, bottom, hi, lo in (('Car', (3.9, 1.6, 1.56), -1.78, 0.6, 0.45),
                                       ('Pedestrian', (0.8, 0.6, 1.73), -0.6, 0.5, 0.35),
                                       ('Cyclist', (1.76, 0.6, 1.73), -0.6, 0.5, 0.35))]


def caddn_kitti():
    """CaDDN on KITTI at its published widths, a whole config (`MODEL`,
    `CLASS_NAMES`, `DATA_CONFIG`, `OPTIMIZATION`), written from OpenPCDet's
    `tools/cfgs/kitti_models/CaDDN.yaml` on `configs/dataset_configs/
    kitti_dataset.yaml` in the JAX package's CaDDN keys (no file of the repo
    builds CaDDN). The file's range, 0.16 m voxels (280 x 376 x 25), FOV
    points and images, the image flip as its only augmentation, 80 LID
    bins over 2..46.8 m and 64 frustum channels, the DDN loss (weight 3,
    alpha 0.25, gamma 2, fg 13, bg 1), the BEV backbone (10 layers at each
    of 64, 128, 256 filters, strides 2, upsampled 1, 2, 4 to 128 each), the
    KITTI anchors at stride 2, NMS 0.01 over 4096 candidates to 500, and
    adam_onecycle at 1e-3. Deviations, each the JAX class's:

    - the image backbone is `ConvImageBackbone` (filters 64, 128, 256, out
      256) where the file has DeepLabV3 on ResNet-101;
    - its features are at 1/8 of the image, 47 x 156 cells for 375 x 1242,
      so `downsample_depth_map` takes DOWNSAMPLE_FACTOR 8, not the file's 4;
    - the height compression concatenates the 25 z cells' 64 channels (1600
      channels into the BEV backbone) where the file has `Conv2DCollapse`
      to 64;
    - the depth maps are made from the points (`generate_depth_map`, at
      MAP_SHAPE 375 x 1242: without it the step reads an 'image_shape' that
      KITTI sets after the data path, ROADMAP Queue 3), where the file
      loads KITTI's."""
    from pathlib import Path

    from .config import CfgNode, cfg_from_yaml_file
    repo = Path(__file__).resolve().parents[2]
    ds = cfg_from_yaml_file(str(repo / 'configs/dataset_configs/kitti_dataset.yaml'))
    ds.POINT_CLOUD_RANGE = list(CADDN_RANGE)
    ds.GET_ITEM_LIST = ['points', 'images']
    ds.FOV_POINTS_ONLY = True
    ds.DATA_AUGMENTOR = CfgNode({'DISABLE_AUG_LIST': ['placeholder'], 'AUG_CONFIG_LIST': [
        {'NAME': 'random_image_flip', 'ALONG_AXIS_LIST': ['horizontal']}]})
    ds.DATA_PROCESSOR = [
        {'NAME': 'generate_depth_map', 'MAP_SHAPE': [375, 1242]},
        {'NAME': 'mask_points_and_boxes_outside_range', 'REMOVE_OUTSIDE_BOXES': True},
        {'NAME': 'calculate_grid_size', 'VOXEL_SIZE': [0.16, 0.16, 0.16]},
        {'NAME': 'downsample_depth_map', 'DOWNSAMPLE_FACTOR': 8}]
    model = {
        'NAME': 'CaDDN',
        'IMAGE_BACKBONE': {'NUM_FILTERS': [64, 128, 256], 'OUT_CHANNEL': 256},
        'FRUSTUM': {'NUM_DEPTH_BINS': 80, 'DEPTH_MIN': 2.0, 'DEPTH_MAX': 46.8,
                    'OUT_CHANNEL': 64},
        'DDN_LOSS': {'WEIGHT': 3.0, 'ALPHA': 0.25, 'GAMMA': 2.0, 'FG_WEIGHT': 13.0,
                     'BG_WEIGHT': 1.0, 'MODE': 'LID'},
        'BACKBONE_2D': {'NAME': 'BaseBEVBackbone', 'LAYER_NUMS': [10, 10, 10],
                        'LAYER_STRIDES': [2, 2, 2], 'NUM_FILTERS': [64, 128, 256],
                        'UPSAMPLE_STRIDES': [1, 2, 4], 'NUM_UPSAMPLE_FILTERS': [128, 128, 128]},
        'DENSE_HEAD': {
            'NAME': 'AnchorHeadSingle', 'CLASS_AGNOSTIC': False,
            'USE_DIRECTION_CLASSIFIER': True, 'DIR_OFFSET': 0.78539, 'DIR_LIMIT_OFFSET': 0.0,
            'NUM_DIR_BINS': 2, 'ANCHOR_GENERATOR_CONFIG': CADDN_ANCHORS,
            'TARGET_ASSIGNER_CONFIG': {'NAME': 'AxisAlignedTargetAssigner', 'POS_FRACTION': -1.0,
                                       'SAMPLE_SIZE': 512, 'NORM_BY_NUM_EXAMPLES': False,
                                       'MATCH_HEIGHT': False, 'BOX_CODER': 'ResidualCoder',
                                       'FEATURE_MAP_STRIDE': 2},
            'LOSS_CONFIG': {'LOSS_WEIGHTS': {'cls_weight': 1.0, 'loc_weight': 2.0,
                                             'dir_weight': 0.2, 'code_weights': [1.0] * 7}}},
        'POST_PROCESSING': {
            'RECALL_THRESH_LIST': [0.3, 0.5, 0.7], 'SCORE_THRESH': 0.1,
            'OUTPUT_RAW_SCORE': False, 'EVAL_METRIC': 'kitti',
            'NMS_CONFIG': {'NMS_TYPE': 'nms_bev', 'NMS_THRESH': 0.01, 'NMS_PRE_MAXSIZE': 4096,
                           'NMS_POST_MAXSIZE': 500}}}
    optimization = {
        'BATCH_SIZE_PER_GPU': 4, 'NUM_EPOCHS': 80, 'OPTIMIZER': 'adam_onecycle', 'LR': 0.001,
        'WEIGHT_DECAY': 0.01, 'MOMENTUM': 0.9, 'MOMS': [0.95, 0.85], 'PCT_START': 0.4,
        'DIV_FACTOR': 10, 'DECAY_STEP_LIST': [35, 45], 'LR_DECAY': 0.1, 'LR_CLIP': 1e-07,
        'LR_WARMUP': False, 'WARMUP_EPOCH': 1, 'GRAD_NORM_CLIP': 10}
    return CfgNode({'CLASS_NAMES': ['Car', 'Pedestrian', 'Cyclist'], 'DATA_CONFIG': ds,
                    'MODEL': model, 'OPTIMIZATION': optimization})


def tiny_caddn_cfg(cfg):
    """Shrink `caddn_kitti()` in place to the JAX package's tests' widths
    (`tests/test_depth_supervision.py`): the image backbone at 8, 16, 32 to
    16, 8 LID bins over 2..40 m into 8 channels, one BEV level of 16, NMS
    over 32 candidates to 16; a 32 x 32 x 4 grid of 1 m voxels over 2..34 m
    ahead and +-16 m across; depth maps of 64 x 96 images."""
    ds = cfg.DATA_CONFIG
    ds.POINT_CLOUD_RANGE = [2.0, -16.0, -3.0, 34.0, 16.0, 1.0]
    for proc in ds.DATA_PROCESSOR:
        if proc['NAME'] == 'calculate_grid_size':
            proc['VOXEL_SIZE'] = [1.0, 1.0, 1.0]
        elif proc['NAME'] == 'generate_depth_map':
            proc['MAP_SHAPE'] = [64, 96]
    m = cfg.MODEL
    m.IMAGE_BACKBONE.update({'NUM_FILTERS': [8, 16, 32], 'OUT_CHANNEL': 16})
    m.FRUSTUM.update({'NUM_DEPTH_BINS': 8, 'DEPTH_MAX': 40.0, 'OUT_CHANNEL': 8})
    m.BACKBONE_2D.update({'LAYER_NUMS': [1], 'LAYER_STRIDES': [2], 'NUM_FILTERS': [16],
                          'UPSAMPLE_STRIDES': [1], 'NUM_UPSAMPLE_FILTERS': [16]})
    nms = m.POST_PROCESSING.NMS_CONFIG
    nms.NMS_PRE_MAXSIZE = 32
    nms.NMS_POST_MAXSIZE = 16
    return cfg


def caddn_camera_inputs(batch: dict) -> dict:
    """Add CaDDN's inputs to a collated KITTI camera batch, in place (the
    KITTI data path does not make them, ROADMAP Queue 3; OpenPCDet makes
    them through GET_ITEM_LIST 'calib_matricies'): 'camera_imgs' (B, 1, H,
    W, 3), the 'images' with an axis of one camera; 'trans_lidar_to_cam'
    (B, 4, 4), R0 V2C of each sample's calibration; 'trans_cam_to_img'
    (B, 3, 4), its P2."""
    from ..datasets.kitti.calibration import _homogenize
    calibs = batch['calib']
    batch['camera_imgs'] = np.ascontiguousarray(batch['images'][:, None], np.float32)
    batch['trans_lidar_to_cam'] = np.stack(
        [_homogenize(c.R0) @ _homogenize(c.V2C) for c in calibs]).astype(np.float32)
    batch['trans_cam_to_img'] = np.stack([c.P2 for c in calibs]).astype(np.float32)
    return batch


def _camera_collate(collate, samples):
    return caddn_camera_inputs(collate(samples))


def caddn_loader(loader):
    """`loader` (a `build_dataloader` loader of a KITTI camera set) with
    `caddn_camera_inputs` applied to each collated batch, in its workers."""
    from functools import partial
    loader.collate_fn = partial(_camera_collate, loader.collate_fn)
    return loader


def caddn_batch(B: int, N: int, cfg, seed: int = 0, M: int = 0, device='cpu') -> dict:
    """A CaDDN batch of `cfg` on the mini KITTI set's camera
    (`datasets.kitti.synthetic`'s P2, R0 and V2C; P2's rows scaled to the
    image where it is not 375 x 1242): images (B, 1, H, W, 3) of uniform
    pixels in [0, 1], H x W the MAP_SHAPE of its `generate_depth_map` step;
    the two transforms; and, with M > 0, M boxes a cloud of
    `gt_boxes` over the range's ground ('gt_boxes', 'gt_mask'), their
    projections clipped to the image ('gt_boxes2d', 'gt_boxes2d_mask': all
    true, as the collate marks a sample's boxes), and the depth maps of N
    `lidar_points` of each cloud inside the camera's view
    (`generate_depth_map`, then `downsample_depth_map`), as the data path
    makes them. Tensors on `device`."""
    from ..datasets.kitti import kitti_utils
    from ..datasets.kitti import synthetic as kitti_syn
    from ..datasets.kitti.calibration import Calibration
    from ..datasets.processor.data_processor import block_mean, lidar_depth_map
    steps = {p['NAME']: p for p in cfg.DATA_CONFIG.DATA_PROCESSOR}
    H, W = (int(v) for v in steps['generate_depth_map']['MAP_SHAPE'])
    P2 = kitti_syn.P2.copy()
    P2[0] *= W / kitti_syn.IMG_W
    P2[1] *= H / kitti_syn.IMG_H
    calib = Calibration({'P2': P2, 'P3': P2, 'R0': kitti_syn.R0, 'Tr_velo2cam': kitti_syn.V2C})
    rng = np.random.RandomState(seed)
    batch = {'images': rng.rand(B, H, W, 3).astype(np.float32), 'calib': [calib] * B}
    caddn_camera_inputs(batch)
    del batch['images'], batch['calib']
    if M:
        pc_range = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
        gt = gt_boxes(B, M, pc_range, seed + 1)
        boxes2d = np.zeros((B, M, 4), np.float32)
        for b in range(B):
            cam = kitti_utils.boxes3d_lidar_to_kitti_camera(gt[b, :, :7], calib)
            boxes2d[b] = kitti_utils.boxes3d_kitti_camera_to_imageboxes(cam, calib,
                                                                        image_shape=(H, W))
        f = int(steps['downsample_depth_map']['DOWNSAMPLE_FACTOR'])
        depth = []
        for b in range(B):
            pts = lidar_points(1, 4 * N, seed + 2 + b, pc_range)[0]
            uv, d = calib.rect_to_img(calib.lidar_to_rect(pts[:, :3]))
            seen = (d > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) \
                & (uv[:, 1] < H)
            depth.append(block_mean(lidar_depth_map(pts[seen][:N], calib, H, W), f))
        batch.update(gt_boxes=gt, gt_mask=np.ones((B, M), bool), gt_boxes2d=boxes2d,
                     gt_boxes2d_mask=np.ones((B, M), bool), depth_maps=np.stack(depth))
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


# the configurations no file of the repo holds, by the name the tools take
# in place of a file (`--cfg_file caddn`)
# the six per-object, frustum and pyramid augmentations, at the settings of
# the JAX package's queue test (`tests/test_augmentor.py`)
LOCAL_AUGMENTATIONS = (
    {'NAME': 'random_local_translation', 'ALONG_AXIS_LIST': ['x', 'y'],
     'LOCAL_TRANSLATION_RANGE': [-0.2, 0.2]},
    {'NAME': 'random_local_rotation', 'LOCAL_ROT_ANGLE': [-0.15, 0.15]},
    {'NAME': 'random_local_scaling', 'LOCAL_SCALE_RANGE': [0.95, 1.05]},
    {'NAME': 'random_world_frustum_dropout', 'DIRECTION': ['top'], 'INTENSITY_RANGE': [0.05, 0.1]},
    {'NAME': 'random_local_frustum_dropout', 'DIRECTION': ['top'], 'INTENSITY_RANGE': [0.05, 0.1]},
    {'NAME': 'random_local_pyramid_aug', 'DROP_PROB': 0.2, 'SPARSIFY_PROB': 0.2,
     'SPARSIFY_MAX_NUM': 50, 'SWAP_PROB': 0.2, 'SWAP_MAX_NUM': 50})


def flagship_on(set_name: str, root, local_augmentations: bool = False):
    """`configs/kitti_models/pdm_ssd_point.yaml` as shipped (the model, its
    range, point encoding, processors and 16384 points) on the generated
    mini set `set_name` ('once', 'argo2', 'lyft', 'pandaset' or 'custom') at
    `root`: DATASET, DATA_PATH, INFO_PATH and the split keys are the set's;
    the world flip, rotation and scaling stay; KITTI's GT sampling goes,
    except on the custom set, which samples from its own
    `custom_dbinfos_train.pkl`. The set's three names of the model's classes
    replace CLASS_NAMES and CLASS_NAMES_EACH_HEAD, in their order (Lyft's
    'car', 'pedestrian', 'bicycle'); the widths stay. With
    `local_augmentations`, LOCAL_AUGMENTATIONS follow in the queue."""
    import contextlib
    import importlib
    from pathlib import Path

    from .config import CfgNode, cfg_from_yaml_file
    repo = Path(__file__).resolve().parents[2]
    with contextlib.chdir(repo):    # the config names its base config relative to the repo
        cfg = cfg_from_yaml_file(str(repo / 'configs/kitti_models/pdm_ssd_point.yaml'))
    # the set's generator module holds its CLASS_NAMES and DATASET_CFG
    mod = importlib.import_module(f'..datasets.{set_name}.synthetic', __package__)
    names = list(mod.CLASS_NAMES)
    cfg.CLASS_NAMES = names
    cfg.MODEL.DENSE_HEAD.CLASS_NAMES_EACH_HEAD = [names]
    ds = cfg.DATA_CONFIG
    ds.pop('DATA_SPLIT')
    ds.update(CfgNode(mod.DATASET_CFG))
    ds.DATA_PATH = str(root)
    augs = [a for a in ds.DATA_AUGMENTOR.AUG_CONFIG_LIST if a.NAME != 'gt_sampling']
    if set_name == 'custom':
        sampler = next(a for a in ds.DATA_AUGMENTOR.AUG_CONFIG_LIST if a.NAME == 'gt_sampling')
        sampler.DB_INFO_PATH = ['custom_dbinfos_train.pkl']
        sampler.PREPARE.filter_by_min_points = [f'{n}:5' for n in names]
        sampler.SAMPLE_GROUPS = [f'{n}:{k}' for n, k in zip(names, (20, 15, 15))]
        augs.insert(0, sampler)
    if local_augmentations:
        augs += [CfgNode(a) for a in LOCAL_AUGMENTATIONS]
    ds.DATA_AUGMENTOR.AUG_CONFIG_LIST = augs
    return cfg


SYNTHETIC_CFGS = {'caddn': caddn_kitti}


def load_cfg(cfg_file: str):
    """A whole config: `SYNTHETIC_CFGS[cfg_file]()` for a name there, else the
    YAML file (relative to the working directory)."""
    from .config import cfg_from_yaml_file
    if cfg_file in SYNTHETIC_CFGS:
        return SYNTHETIC_CFGS[cfg_file]()
    return cfg_from_yaml_file(cfg_file)


# the dry run's shrink of each model that has one, by `MODEL.NAME` (a
# SECONDNet's by its backbone too)
TINY_CFGS = {'PDMSSD': tiny_pdmssd_cfg, 'PointRCNN': tiny_pointrcnn_cfg,
             'SECONDNet': tiny_secondnet_cfg, 'PointPillar': tiny_pointpillar_cfg,
             'CenterPoint': tiny_centerpoint_pillar_cfg, 'PillarNet': tiny_pillarnet_cfg,
             'VoxelNeXt': tiny_voxelnext_cfg, 'PVRCNN': tiny_pv_rcnn_cfg,
             'VoxelRCNN': tiny_voxel_rcnn_cfg, 'SECONDNetIoU': tiny_second_iou_cfg,
             'PartA2Net': tiny_parta2_cfg, 'PVRCNNPlusPlus': tiny_pv_rcnn_plusplus_cfg,
             'DSVT': tiny_dsvt_cfg, 'TransFusion': tiny_transfusion_cfg,
             'MPPNet': tiny_mppnet_cfg, 'BevFusion': tiny_bevfusion_cfg,
             'CaDDN': tiny_caddn_cfg}


def voxelizes(cfg) -> bool:
    """Whether the config's data path voxelizes its points (a voxel model's
    batches hold voxels, a point model's the points)."""
    return any(proc.get('NAME') == 'transform_points_to_voxels'
               for proc in cfg.DATA_CONFIG.DATA_PROCESSOR)


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
    its NMS sees no candidate) or a heatmap head's, in every head group of
    a CenterHead or a VoxelNeXtHead (it starts at -2.19, scores near 0.1,
    at the SCORE_THRESH of the PDM configs). At 0 the scores spread around
    0.5 and post-processing does the work it does for a trained model."""
    head = net.dense_head
    layers = ([head.conv_cls] if hasattr(head, 'conv_cls') else
              [m.hm_out for n, m in head.named_children() if n == 'head' or n.startswith('head_')])
    with torch.no_grad():
        for layer in layers:
            layer.bias.zero_()
    return net


def random_model(cfg, device=None, seed: int = 0) -> torch.nn.Module:
    """The detector of a full config (`MODEL`, `CLASS_NAMES`, `DATA_CONFIG`)
    with seeded weights and BatchNorm statistics, in eval mode, built with
    the config's CLASS_NAMES as the CLIs build it (a CenterHead has one
    head per CLASS_NAMES_EACH_HEAD group)."""
    from ..models import build_network
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device=device,
                        seed=seed, class_names=cfg.CLASS_NAMES)
    randomize_bn(net, torch.Generator().manual_seed(seed + 1))
    return net
