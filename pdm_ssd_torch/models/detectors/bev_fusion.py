"""BEVFusion, camera and LiDAR fused in BEV (counterpart of
`pdm_ssd_tpu/models/detectors/bev_fusion.py`):

    images -> Swin (or `ConvImageBackbone`) -> GeneralizedLSSFPN (its finest
              level) -> DepthLSSTransform -> camera BEV
    voxels -> PillarVFE -> PointPillarScatter -> LiDAR BEV
    ConvFuser(LiDAR, camera) -> BaseBEVBackbone -> CenterHead.

The camera map is cropped to the LiDAR map's size and zero-padded at its
far edges where it is smaller, as the JAX package does (a camera grid that
does not match the LiDAR grid lands in the LiDAR map's corner). Targets,
losses and post-processing are `Detector3D`'s. The batch holds the camera
tensors ('camera_imgs' (B, N, H, W, 3), 'camera_depth', 'camera2lidar',
'camera_intrinsics', 'img_aug_matrix') beside the voxels. The submodules
carry the JAX detector's attribute names (`image_backbone`, `neck`,
`view_transform`, `vfe`, `map_to_bev`, `fuser`, `backbone_2d`,
`dense_head`).
"""
from __future__ import annotations

import copy

import torch
from torch import nn
from torch.nn import functional as F

from ...utils.config import as_cfg
from ..backbones_2d.base_bev_backbone import BaseBEVBackbone
from ..backbones_2d.map_to_bev import PointPillarScatter
from ..backbones_3d.vfe import PillarVFE
from ..backbones_image import ConvFuser, ConvImageBackbone, GeneralizedLSSFPN, SwinTransformer
from ..dense_heads.center_head import CenterHead
from ..view_transforms.depth_lss import DepthLSSTransform
from .detector3d import Detector3D, _grid_info


class BevFusion(Detector3D):
    def __init__(self, model_cfg, num_class: int, dataset_cfg, class_names=None, device=None):
        nn.Module.__init__(self)
        cfg = as_cfg(copy.deepcopy(model_cfg))
        ds = as_cfg(dataset_cfg)
        self.model_cfg = cfg
        self.num_class = num_class
        pc_range = tuple(ds.POINT_CLOUD_RANGE)
        (gw, gh, gd), voxel = _grid_info(ds)
        self.grid_size = (gw, gh, gd)
        swin = cfg.IMAGE_BACKBONE.get('NAME', '') == 'SwinTransformer'
        self.image_backbone = (SwinTransformer if swin else ConvImageBackbone)(
            cfg.IMAGE_BACKBONE, device=device)
        self.neck = GeneralizedLSSFPN(cfg.NECK, device=device) \
            if cfg.get('NECK') is not None else None
        self.view_transform = DepthLSSTransform(cfg.VTRANSFORM, device=device)
        self.vfe = PillarVFE(cfg.VFE, ds.get('NUM_POINT_FEATURES', 4), voxel, pc_range,
                             device=device)
        self.map_to_bev = PointPillarScatter(cfg.MAP_TO_BEV, (gw, gh))
        self.fuser = ConvFuser(cfg.FUSER, self.map_to_bev.num_bev_features
                               + self.view_transform.num_bev_features, device=device)
        self.backbone_2d = BaseBEVBackbone(cfg.BACKBONE_2D, self.fuser.num_bev_features,
                                           device=device)
        stride = cfg.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.get('FEATURE_MAP_STRIDE', 1)
        self.dense_head = CenterHead(cfg.DENSE_HEAD, self.backbone_2d.num_bev_features,
                                     num_class, (gw // stride, gh // stride), pc_range, voxel[:2],
                                     class_names=tuple(class_names) if class_names else None,
                                     device=device)
        self.slots = {'vfe': 'vfe', 'map_to_bev': 'map_to_bev', 'backbone_2d': 'backbone_2d'}

    def image_features(self, images: torch.Tensor,
                       generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, N, fH, fW, C) features of the images that the view transform
        lifts: the neck's finest level, or the backbone's output without a
        neck. `generator` draws Swin's drop path in training (none: the
        identity)."""
        if isinstance(self.image_backbone, SwinTransformer):
            feats = self.image_backbone(images, generator)
        else:
            feats = self.image_backbone(images)
        return feats if self.neck is None else self.neck(feats)[0]

    def forward(self, batch: dict, generator: torch.Generator | None = None) -> dict:
        batch = dict(batch)
        batch['camera_feats'] = self.image_features(batch['camera_imgs'], generator)
        camera = self.view_transform(batch)['spatial_features']
        batch = self.map_to_bev(self.vfe(batch))
        lidar = batch['spatial_features']
        lh, lw = lidar.shape[1:3]
        camera = camera[:, :lh, :lw]
        camera = F.pad(camera, (0, 0, 0, lw - camera.shape[2], 0, lh - camera.shape[1]))
        batch['spatial_features'] = self.fuser(lidar, camera)
        return self.dense_head(self.backbone_2d(batch))
