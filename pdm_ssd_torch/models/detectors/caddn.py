"""CaDDN, camera-only 3D detection by categorical depth (counterpart of
`pdm_ssd_tpu/models/detectors/caddn.py`):

    image -> ConvImageBackbone -> depth_head (1x1 to D+1 depth logits and C
             channels) -> softmax over D+1, the last ("beyond range") bin
             dropped -> frustum (B, fH, fW, D, C), the outer product
    voxel centres -> trans_lidar_to_cam, trans_cam_to_img -> (fv, fu, LID
             bin) -> trilinear sample of the frustum -> (B, gh, gw, gd * C)
             -> BaseBEVBackbone -> AnchorHeadSingle.

The trilinear sample gathers the 8 corners of each voxel's frustum cell
through the port's `gather_rows` kernel on CUDA tensors (its gradient the
`scatter_add_rows` kernel, `ops.sa_fused.GatherRows`): one launch a corner,
(B, V) rows of the flattened frustum (B, fH * fW * D, C). The corners are
weighted and summed in the JAX package's order (dy, dx, dd), so that the
float32 sums agree, and the voxels that project outside the image or depth
range are zeroed. The voxels are visited in (y, x, z) order, so the sum is
already the height-compressed (B, gh, gw, gd * C) map of the JAX package's
transpose.

The training loss adds the DDN loss (`ops.depth.ddn_loss`) whenever the
batch holds 'depth_maps'. The batch holds 'camera_imgs' (B, 1, H, W, 3),
'trans_lidar_to_cam' (B, 4, 4) and 'trans_cam_to_img' (B, 3, 4); the KITTI
data path does not make them (`utils.synthetic.caddn_camera_inputs` does,
ROADMAP Queue 3). The submodules carry the JAX detector's names
(`image_backbone`, `depth_head`, `backbone_2d`, `dense_head`).
"""
from __future__ import annotations

import copy

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.depth import ddn_loss
from ...ops.sa_fused import GatherRows
from ...utils.config import as_cfg
from ..backbones_2d.base_bev_backbone import BaseBEVBackbone
from ..backbones_image import ConvImageBackbone
from ..dense_heads.anchor_head import AnchorHeadSingle
from .detector3d import Detector3D, _grid_info


def voxel_centers(grid: tuple, voxel: tuple, pc_range, device=None,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(gh * gw * gd, 4) homogeneous LiDAR-frame centres of a (gw, gh, gd)
    grid, in (y, x, z) order (z fastest), in `dtype` (the JAX package's
    default float: float32, or float64 in its float64 runs)."""
    (gw, gh, gd), (vx, vy, vz) = grid, voxel
    xs = (torch.arange(gw, dtype=dtype, device=device) + 0.5) * vx + pc_range[0]
    ys = (torch.arange(gh, dtype=dtype, device=device) + 0.5) * vy + pc_range[1]
    zs = (torch.arange(gd, dtype=dtype, device=device) + 0.5) * vz + pc_range[2]
    gy, gx, gz = torch.meshgrid(ys, xs, zs, indexing='ij')
    return torch.stack([gx, gy, gz, torch.ones_like(gx)], -1).reshape(-1, 4)


def lid_bin(depth: torch.Tensor, depth_min: float, depth_max: float, num_bins: int):
    """LID discretization: the fractional bin of each depth (bin width
    growing linearly with depth), in the JAX package's order of operations."""
    D = num_bins
    return 0.5 * (-1 + torch.sqrt(1 + 8 * torch.clamp(depth - depth_min, min=0) * D * (D + 1)
                                  / (2 * (depth_max - depth_min))))


def frustum_corners(centers: torch.Tensor, trans_lidar_to_cam: torch.Tensor,
                    trans_cam_to_img: torch.Tensor, image_hw: tuple, frustum_hwd: tuple,
                    depth_range: tuple) -> tuple:
    """Each voxel centre (V, 4) projected into the frustum (fH, fW, D) of an
    image of `image_hw`: the 8 corners of its trilinear sample as rows of
    the flattened frustum, clipped to it, (8, B, V) int32 in the order dy,
    dx, dd; their weights (8, B, V) float32; and (B, V) bool, the voxels
    inside the image, in front of DEPTH_MIN and short of the last bin."""
    iH, iW = image_hw
    fH, fW, D = frustum_hwd
    dmin, dmax = depth_range
    cam = torch.einsum('bij,nj->bni', trans_lidar_to_cam, centers)
    img = torch.einsum('bij,bnj->bni', trans_cam_to_img, cam)
    depth = img[..., 2]
    u = img[..., 0] / torch.clamp(depth, min=1e-3)
    v = img[..., 1] / torch.clamp(depth, min=1e-3)
    fu = u * (fW / iW) - 0.5
    fv = v * (fH / iH) - 0.5
    fd = lid_bin(depth, dmin, dmax, D) - 0.5
    valid = (depth > dmin) & (u >= 0) & (u < iW) & (v >= 0) & (v < iH) & (fd < D - 0.5)
    y0, x0, d0 = (torch.floor(t).to(torch.int32) for t in (fv, fu, fd))
    ay = torch.clamp(fv - y0, 0, 1)
    ax = torch.clamp(fu - x0, 0, 1)
    ad = torch.clamp(fd - d0, 0, 1)
    rows, weights = [], []
    for dy in (0, 1):
        for dx in (0, 1):
            for dd in (0, 1):
                wy = ay if dy else (1 - ay)
                wx = ax if dx else (1 - ax)
                wd = ad if dd else (1 - ad)
                rows.append((torch.clamp(y0 + dy, 0, fH - 1) * fW
                             + torch.clamp(x0 + dx, 0, fW - 1)) * D + torch.clamp(d0 + dd, 0, D - 1))
                weights.append(wy * wx * wd)
    return torch.stack(rows), torch.stack(weights), valid


def sample_frustum(flat: torch.Tensor, rows: torch.Tensor, weights: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """The trilinear sample: flat (B, fH * fW * D, C), rows and weights (8,
    B, V) of `frustum_corners`, valid (B, V) -> (B, V, C), the weighted
    corners summed in order and the invalid voxels zeroed. Each corner is a
    `GatherRows` of (B, V) rows: the `gather_rows` kernel on CUDA tensors,
    its backward `scatter_add_rows`."""
    out = None
    for rows_k, w_k in zip(rows, weights):
        g = GatherRows.apply(flat, rows_k).mul_(w_k[..., None])
        out = g if out is None else out.add_(g)
    return out.masked_fill_(~valid[..., None], 0.0)


class CaDDN(Detector3D):
    """Config: IMAGE_BACKBONE (`ConvImageBackbone`'s), FRUSTUM
    (NUM_DEPTH_BINS, DEPTH_MIN, DEPTH_MAX, OUT_CHANNEL), BACKBONE_2D,
    DENSE_HEAD (an `AnchorHeadSingle`), DDN_LOSS (WEIGHT, ALPHA, GAMMA,
    FG_WEIGHT, BG_WEIGHT, MODE), POST_PROCESSING."""

    def __init__(self, model_cfg, num_class: int, dataset_cfg, class_names=None, device=None):
        nn.Module.__init__(self)
        cfg = as_cfg(copy.deepcopy(model_cfg))
        ds = as_cfg(dataset_cfg)
        self.model_cfg = cfg
        self.num_class = num_class
        self.pc_range = tuple(float(v) for v in ds.POINT_CLOUD_RANGE)
        (gw, gh, gd), self.voxel_size = _grid_info(ds)
        self.grid_size = (gw, gh, gd)
        fcfg = cfg.FRUSTUM
        self.depth_bins = int(fcfg.NUM_DEPTH_BINS)
        self.depth_range = (float(fcfg.DEPTH_MIN), float(fcfg.DEPTH_MAX))
        self.frustum_channels = int(fcfg.OUT_CHANNEL)
        self.image_backbone = ConvImageBackbone(cfg.IMAGE_BACKBONE, device=device)
        self.backbone_2d = BaseBEVBackbone(cfg.BACKBONE_2D, self.frustum_channels * gd,
                                           device=device)
        stride = cfg.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.get('FEATURE_MAP_STRIDE', 1)
        self.dense_head = AnchorHeadSingle(cfg.DENSE_HEAD, self.backbone_2d.num_bev_features,
                                           num_class, class_names, (gw // stride, gh // stride),
                                           self.pc_range, device=device)
        # D+1 logits (the last: beyond DEPTH_MAX) and the frustum's channels
        self.depth_head = nn.Conv2d(self.image_backbone.out_channels,
                                    self.depth_bins + 1 + self.frustum_channels, 1, device=device)
        self.slots = {'backbone_2d': 'backbone_2d'}

    def image_features(self, images: torch.Tensor) -> tuple:
        """(depth logits (B, fH, fW, D+1), frustum (B, fH, fW, D, C)) of
        images (B, 1, H, W, 3)."""
        return self.depth_frustum(self.image_backbone(images)[:, 0])

    def depth_frustum(self, feats: torch.Tensor) -> tuple:
        """The depth head, the softmax over its bins (the last dropped) and
        the frustum's outer product on the image features (B, fH, fW, Ci)."""
        x = self.depth_head(feats.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        D, C = self.depth_bins, self.frustum_channels
        depth_logits = x[..., :D + 1]
        depth_dist = F.softmax(depth_logits, dim=-1)[..., :D]
        ctx = x[..., D + 1:D + 1 + C]
        return depth_logits, depth_dist[..., None] * ctx[..., None, :]

    def frustum_to_bev(self, frustum: torch.Tensor, batch: dict) -> torch.Tensor:
        """The frustum sampled at every voxel centre: (B, gh, gw, gd * C)."""
        B, fH, fW, D, C = frustum.shape
        gw, gh, gd = self.grid_size
        centers = voxel_centers(self.grid_size, self.voxel_size, self.pc_range, frustum.device,
                                frustum.dtype)
        rows, weights, valid = frustum_corners(
            centers, batch['trans_lidar_to_cam'], batch['trans_cam_to_img'],
            tuple(batch['camera_imgs'].shape[2:4]), (fH, fW, D), self.depth_range)
        out = sample_frustum(frustum.reshape(B, fH * fW * D, C), rows, weights, valid)
        return out.reshape(B, gh, gw, gd * C)

    def forward(self, batch: dict) -> dict:
        batch = dict(batch)
        depth_logits, frustum = self.image_features(batch['camera_imgs'])
        batch['depth_logits'] = depth_logits
        batch['spatial_features'] = self.frustum_to_bev(frustum, batch)
        batch['spatial_features_stride'] = 1
        batch = self.backbone_2d(batch)
        return self.dense_head(batch)

    def get_training_loss(self, batch: dict) -> tuple:
        """The anchor head's loss, plus the DDN loss when the batch holds
        'depth_maps' (at the logits' resolution) and the config DDN_LOSS; its
        2D boxes 'gt_boxes2d' with 'gt_boxes2d_mask' (none: no foreground),
        downsampled by the image's height over the logits'."""
        loss, tb = super().get_training_loss(batch)
        dcfg = self.model_cfg.get('DDN_LOSS', None)
        if 'depth_maps' in batch and dcfg is not None:
            dm = batch['depth_maps']
            fH = batch['depth_logits'].shape[1]
            iH = batch['camera_imgs'].shape[2]
            boxes = batch.get('gt_boxes2d')
            if boxes is None:
                boxes = torch.zeros((dm.shape[0], 1, 4), device=dm.device)
            dl, dtb = ddn_loss(
                batch['depth_logits'], dm, boxes, box_mask=batch.get('gt_boxes2d_mask'),
                weight=dcfg.get('WEIGHT', 3.0), alpha=dcfg.get('ALPHA', 0.25),
                gamma=dcfg.get('GAMMA', 2.0), fg_weight=dcfg.get('FG_WEIGHT', 13.0),
                bg_weight=dcfg.get('BG_WEIGHT', 1.0),
                downsample_factor=max(int(round(iH / fH)), 1),
                disc_cfg={'mode': dcfg.get('MODE', 'LID'), 'depth_min': self.depth_range[0],
                          'depth_max': self.depth_range[1]})
            loss = loss + dl
            tb = {**tb, **dtb, 'loss': loss}
        return loss, tb
