"""Config-assembled single-stage detector (counterpart of
`pdm_ssd_tpu/models/detectors/detector3d.py`): a detector is the module
slots its config names,

    VFE -> BACKBONE_3D -> MAP_TO_BEV -> BACKBONE_2D -> DENSE_HEAD.

Ported slots: `MeanVFE`, the sparse voxel `BACKBONE_3D`, `BaseBEVBackbone`,
`AnchorHeadSingle`, which is SECOND on the sparse ladder
(`configs/kitti_models/second_sparse.yaml`). Every other name raises
`NotImplementedError`. The serving path; training is not ported yet.

The submodules carry flax's names for the entries of the JAX detector's
module list (`module_list_0`, ...), so `utils/weights.from_flax` maps the
parameter tree one to one; `vfe`, `backbone_3d` and `backbone_2d` name the
same modules by their slot.
"""
from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from ...ops.selection import two_stage_topk
from ...utils.config import as_cfg
from .. import model_nms
from ..backbones_2d.base_bev_backbone import BaseBEVBackbone
from ..backbones_3d.sparse_backbone import SparseVoxelBackBone8x
from ..backbones_3d.vfe import build_vfe
from ..dense_heads.anchor_head import AnchorHeadSingle
from ..model_nms import take_rows


def _grid_info(ds_cfg):
    """Grid size (W, H, D) and voxel size from the dataset's processor list."""
    pc = np.asarray(ds_cfg.POINT_CLOUD_RANGE, np.float32)
    voxel = None
    for proc in ds_cfg.get('DATA_PROCESSOR', []):
        if 'VOXEL_SIZE' in proc:
            voxel = np.asarray(proc.VOXEL_SIZE, np.float32)
    if voxel is None:
        voxel = np.asarray([0.16, 0.16, 4.0], np.float32)
    grid = np.round((pc[3:6] - pc[0:3]) / voxel).astype(int)
    return tuple(int(g) for g in grid), tuple(float(v) for v in voxel)


def build_voxel_backbone_3d(bb_cfg, input_channels: int, grid_size, device=None) -> nn.Module:
    name = bb_cfg.get('NAME', 'VoxelBackBone8x')
    if name in ('SparseVoxelBackBone8x', 'SparseVoxelResBackBone8x'):
        return SparseVoxelBackBone8x(bb_cfg, input_channels, grid_size,
                                     residual=(name == 'SparseVoxelResBackBone8x'), device=device)
    raise NotImplementedError(f'BACKBONE_3D {name} is not ported yet (ROADMAP Queue 1 item 10, '
                              'the rest of the sparse voxel ladder)')


class Detector3D(nn.Module):
    def __init__(self, model_cfg, num_class: int, dataset_cfg, class_names=None, device=None):
        super().__init__()
        cfg = as_cfg(copy.deepcopy(model_cfg))
        ds = as_cfg(dataset_cfg)
        self.model_cfg = cfg
        self.num_class = num_class
        pc_range = tuple(ds.POINT_CLOUD_RANGE)
        num_pf = ds.get('NUM_POINT_FEATURES', 4)
        (gw, gh, gd), _ = _grid_info(ds)
        if cfg.POST_PROCESSING.get('TTA_FLIP'):
            raise NotImplementedError('TTA_FLIP of the voxel family is not ported yet (ROADMAP '
                                      'Queue 1 item 10, the rest of the sparse voxel ladder)')

        self.slots = {}         # slot name -> flax name of its module
        width = num_pf

        def add(slot: str, module: nn.Module) -> nn.Module:
            name = f'module_list_{len(self.slots)}'
            self.add_module(name, module)
            self.slots[slot] = name
            return module

        if cfg.get('VFE') is not None:
            width = add('vfe', build_vfe(cfg.VFE, num_pf)).get_output_feature_dim()
        if cfg.get('BACKBONE_3D') is not None:
            width = add('backbone_3d', build_voxel_backbone_3d(
                cfg.BACKBONE_3D, width, (gw, gh, gd), device=device)).num_bev_features
        if cfg.get('MAP_TO_BEV') is not None:
            raise NotImplementedError(f'MAP_TO_BEV {cfg.MAP_TO_BEV.NAME} is not ported yet '
                                      '(ROADMAP Queue 1 items 9 and 10, the pillar family and the '
                                      'rest of the sparse voxel ladder)')
        if cfg.get('BACKBONE_2D') is not None:
            name2d = cfg.BACKBONE_2D.get('NAME', 'BaseBEVBackbone')
            if name2d != 'BaseBEVBackbone':
                raise NotImplementedError(f'BACKBONE_2D {name2d} is not ported yet '
                                          '(ROADMAP Queue 1 item 9, the pillar family)')
            width = add('backbone_2d', BaseBEVBackbone(cfg.BACKBONE_2D, width,
                                                       device=device)).num_bev_features
        head_cfg = cfg.DENSE_HEAD
        if head_cfg.NAME != 'AnchorHeadSingle':
            raise NotImplementedError(f'DENSE_HEAD {head_cfg.NAME} is not ported in Detector3D '
                                      'yet (ROADMAP Queue 1 items 9 to 11: the pillar family, '
                                      'the rest of the sparse voxel ladder, the other '
                                      'two-stage heads)')
        stride = head_cfg.TARGET_ASSIGNER_CONFIG.get('FEATURE_MAP_STRIDE', 2) \
            if 'TARGET_ASSIGNER_CONFIG' in head_cfg else 2
        self.dense_head = AnchorHeadSingle(head_cfg, width, num_class, class_names,
                                           grid_size=(gw // stride, gh // stride),
                                           point_cloud_range=pc_range, device=device)

    def _slot(self, slot: str):
        return getattr(self, self.slots[slot]) if slot in self.slots else None

    vfe = property(lambda self: self._slot('vfe'))
    backbone_3d = property(lambda self: self._slot('backbone_3d'))
    backbone_2d = property(lambda self: self._slot('backbone_2d'))

    def forward(self, batch: dict) -> dict:
        batch = dict(batch)
        for name in self.slots.values():
            batch = getattr(self, name)(batch)
        if 'spatial_features_2d' not in batch:
            batch['spatial_features_2d'] = batch['spatial_features']
        return self.dense_head(batch)

    def get_training_loss(self, batch: dict):
        raise NotImplementedError('Detector3D training is not ported yet '
                                  '(ROADMAP Queue 1 item 6, SECOND training)')

    def forward_with_loss(self, batch: dict):
        raise NotImplementedError('Detector3D training is not ported yet '
                                  '(ROADMAP Queue 1 item 6, SECOND training)')

    @torch.inference_mode()
    def predict(self, batch: dict) -> dict:
        """Forward + post-processing. The model must be in eval mode."""
        if self.training:
            raise RuntimeError('predict needs eval mode (call model.eval())')
        return self.post_process(self(batch))

    def select_candidates(self, batch: dict):
        """Sigmoid scores, the best class per anchor and the top
        2 * NMS_PRE_MAXSIZE anchors by `two_stage_topk`: (boxes (B, K, 7),
        scores, labels (1-based), valid (B, K)), valid above SCORE_THRESH."""
        pp = self.model_cfg.POST_PROCESSING
        cls_preds, boxes = self.dense_head.generate_predicted_boxes(batch)
        probs = torch.sigmoid(cls_preds)                          # (B, A, nc)
        scores_all, labels_all = probs.max(dim=-1)
        K = min(int(np.max(pp.NMS_CONFIG.NMS_PRE_MAXSIZE)) * 2, scores_all.shape[1])
        scores, sel = two_stage_topk(scores_all, K)
        return (take_rows(boxes, sel)[..., :7], scores, take_rows(labels_all, sel) + 1,
                scores > pp.get('SCORE_THRESH', 0.1))

    def post_process(self, batch: dict) -> dict:
        """The candidates of `select_candidates` through one class-agnostic
        rotated NMS. Returns (B, P, 7) boxes and (B, P) scores, labels
        (1-based) and mask."""
        boxes, scores, labels, valid = self.select_candidates(batch)
        fb, fs, fl, fm = model_nms.dispatch_nms(boxes, scores, labels, valid,
                                                self.model_cfg.POST_PROCESSING.NMS_CONFIG,
                                                self.num_class)
        return {'pred_boxes': fb, 'pred_scores': fs, 'pred_labels': fl, 'pred_mask': fm}
