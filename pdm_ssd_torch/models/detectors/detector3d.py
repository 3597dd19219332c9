"""Config-assembled single-stage detector (counterpart of
`pdm_ssd_tpu/models/detectors/detector3d.py`): a detector is the module
slots its config names,

    VFE -> BACKBONE_3D -> MAP_TO_BEV -> BACKBONE_2D -> DENSE_HEAD.

Ported slots: `MeanVFE`, `PillarVFE`, `DynamicPillarVFE`; the sparse voxel
ladder, the focal ladder `VoxelBackBone8xFocal`, the dense
`DenseVoxelBackBone8x` (any other BACKBONE_3D name, as the JAX package's
`build_voxel_backbone_3d` reads it) and `GridPointBackbone`;
`PointPillarScatter`, `HeightCompression`, `Conv2DCollapse`;
`BaseBEVBackbone`, `BaseBEVResBackbone`, `DSVTBackbone`;
`AnchorHeadSingle`, `AnchorHeadMulti` (axis-aligned or ATSS targets),
`CenterHead`, `VoxelNeXtHead` and `TransFusionHead` (its decode takes no
NMS). That is SECOND on the sparse, focal or dense ladder, PointPillar,
CenterPoint-pillar, PillarNet, VoxelNeXt, DSVT and TransFusion
(`configs/kitti_models/second_sparse.yaml`, `second_focal.yaml`,
`second.yaml`, `pointpillar.yaml`, `centerpoint_pillar.yaml`,
`pillarnet.yaml`, `voxelnext.yaml`, `dsvt.yaml`, `transfusion.yaml`),
served and trained, with `TTA_FLIP`. Another head or BEV backbone raises
`NotImplementedError`.

The submodules carry flax's names for the entries of the JAX detector's
module list (`module_list_0`, ...), so `utils/weights.from_flax` maps the
parameter tree one to one; `vfe`, `backbone_3d`, `map_to_bev` and
`backbone_2d` name the same modules by their slot.
"""
from __future__ import annotations

import copy
import math

import numpy as np
import torch
from torch import nn

from ...ops.selection import two_stage_topk
from ...utils.config import as_cfg
from .. import model_nms
from ..backbones_2d.base_bev_backbone import BaseBEVBackbone, BaseBEVResBackbone
from ..backbones_2d.dsvt_backbone import DSVTBackbone
from ..backbones_2d.map_to_bev import build_map_to_bev
from ..backbones_3d.grid_point_backbone import GridPointBackbone
from ..backbones_3d.sparse_backbone import SparseUNetV2, SparseVoxelBackBone8x
from ..backbones_3d.sparse_backbone_focal import VoxelBackBone8xFocal
from ..backbones_3d.vfe import build_vfe
from ..backbones_3d.voxel_backbone import DenseUNetV2, DenseVoxelBackBone8x
from ..dense_heads.anchor_head import AnchorHeadMulti, AnchorHeadSingle
from ..dense_heads.center_head import CenterHead
from ..dense_heads.transfusion_head import TransFusionHead
from ..dense_heads.voxelnext_head import VoxelNeXtHead
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


def build_voxel_backbone_3d(bb_cfg, input_channels: int, grid_size, voxel_size=None,
                            pc_range=None, dense_canvas: bool = True, device=None) -> nn.Module:
    """The sparse and focal ladders and the two UNets (Part-A2's, which the
    JAX package's `PartA2Net` builds itself) by their names; every other name
    (`DenseVoxelBackBone8x`, `VoxelBackBone8x`, none) is the dense ladder, as
    in the JAX package's `build_voxel_backbone_3d`. `dense_canvas=False`
    spares the sparse ladder its dense BEV map, for a head that reads only
    the sparse output."""
    name = bb_cfg.get('NAME', 'VoxelBackBone8x')
    if name == 'DenseUNetV2':
        return DenseUNetV2(bb_cfg, input_channels, grid_size, voxel_size, pc_range, device=device)
    if name == 'SparseUNetV2':
        return SparseUNetV2(bb_cfg, input_channels, grid_size, voxel_size, pc_range,
                            device=device)
    if name in ('SparseVoxelBackBone8x', 'SparseVoxelResBackBone8x'):
        return SparseVoxelBackBone8x(bb_cfg, input_channels, grid_size,
                                     residual=(name == 'SparseVoxelResBackBone8x'),
                                     dense_canvas=dense_canvas, device=device)
    if name == 'VoxelBackBone8xFocal':
        return VoxelBackBone8xFocal(bb_cfg, input_channels, grid_size, voxel_size, pc_range,
                                    device=device)
    return DenseVoxelBackBone8x(bb_cfg, input_channels, grid_size, device=device)


class Detector3D(nn.Module):
    def __init__(self, model_cfg, num_class: int, dataset_cfg, class_names=None, device=None):
        super().__init__()
        cfg = as_cfg(copy.deepcopy(model_cfg))
        ds = as_cfg(dataset_cfg)
        self.model_cfg = cfg
        self.num_class = num_class
        pc_range = tuple(ds.POINT_CLOUD_RANGE)
        num_pf = ds.get('NUM_POINT_FEATURES', 4)
        (gw, gh, gd), voxel = _grid_info(ds)
        self.grid_size = (gw, gh, gd)
        head_cfg = cfg.DENSE_HEAD

        self.slots = {}         # slot name -> flax name of its module
        width = num_pf

        def add(slot: str, module: nn.Module) -> nn.Module:
            name = f'module_list_{len(self.slots)}'
            self.add_module(name, module)
            self.slots[slot] = name
            return module

        if cfg.get('VFE') is not None:
            width = add('vfe', build_vfe(cfg.VFE, num_pf, voxel, pc_range, (gw, gh),
                                         device=device)).get_output_feature_dim()
        if cfg.get('BACKBONE_3D') is not None:
            if cfg.BACKBONE_3D.get('NAME') == 'GridPointBackbone':
                width = add('backbone_3d', GridPointBackbone(
                    cfg.BACKBONE_3D, num_pf, pc_range, device=device)).num_point_features
            else:
                # VoxelNeXt's head reads the sparse output only: no reader of
                # the dense BEV map, which the JAX package's jit drops
                width = add('backbone_3d', build_voxel_backbone_3d(
                    cfg.BACKBONE_3D, width, (gw, gh, gd), voxel, pc_range,
                    dense_canvas=head_cfg.NAME != 'VoxelNeXtHead', device=device)
                ).num_bev_features
        if cfg.get('MAP_TO_BEV') is not None:
            width = add('map_to_bev', build_map_to_bev(cfg.MAP_TO_BEV, (gw, gh), width,
                                                       device=device)).num_bev_features
        if cfg.get('BACKBONE_2D') is not None:
            name2d = cfg.BACKBONE_2D.get('NAME', 'BaseBEVBackbone')
            bb_cls = {'BaseBEVBackbone': BaseBEVBackbone, 'BaseBEVResBackbone': BaseBEVResBackbone,
                      'DSVTBackbone': DSVTBackbone}.get(name2d)
            if bb_cls is None:
                raise NotImplementedError(f'BACKBONE_2D {name2d} is not ported yet '
                                          '(ROADMAP Queue 1)')
            width = add('backbone_2d', bb_cls(cfg.BACKBONE_2D, width,
                                              device=device)).num_bev_features
        stride = head_cfg.TARGET_ASSIGNER_CONFIG.get('FEATURE_MAP_STRIDE', 2) \
            if 'TARGET_ASSIGNER_CONFIG' in head_cfg else 2
        fmap = (gw // stride, gh // stride)
        if head_cfg.NAME == 'CenterHead':
            self.dense_head = CenterHead(head_cfg, width, num_class, fmap, pc_range, voxel[:2],
                                         class_names=tuple(class_names) if class_names else None,
                                         device=device)
        elif head_cfg.NAME == 'VoxelNeXtHead':
            # the head reads the ladder's sparse output rows, not a BEV map
            self.dense_head = VoxelNeXtHead(head_cfg, self.backbone_3d.out_features, num_class,
                                            pc_range, voxel[:2],
                                            class_names=tuple(class_names) if class_names
                                            else None, device=device)
        elif head_cfg.NAME == 'TransFusionHead':
            self.dense_head = TransFusionHead(head_cfg, width, num_class, pc_range, voxel[:2],
                                              device=device)
        elif head_cfg.NAME in ('AnchorHeadSingle', 'AnchorHeadMulti'):
            head_cls = AnchorHeadMulti if head_cfg.NAME == 'AnchorHeadMulti' else AnchorHeadSingle
            self.dense_head = head_cls(head_cfg, width, num_class, class_names, grid_size=fmap,
                                       point_cloud_range=pc_range, device=device)
        else:
            raise NotImplementedError(f'DENSE_HEAD {head_cfg.NAME} is not ported in Detector3D '
                                      'yet (ROADMAP Queue 1)')

    def _slot(self, slot: str):
        return self._modules[self.slots[slot]] if slot in self.slots else None

    vfe = property(lambda self: self._slot('vfe'))
    backbone_3d = property(lambda self: self._slot('backbone_3d'))
    map_to_bev = property(lambda self: self._slot('map_to_bev'))
    backbone_2d = property(lambda self: self._slot('backbone_2d'))

    def forward(self, batch: dict) -> dict:
        batch = dict(batch)
        for name in self.slots.values():
            batch = getattr(self, name)(batch)
        if isinstance(self.dense_head, VoxelNeXtHead):
            return self.dense_head(batch)
        if 'spatial_features_2d' not in batch:
            batch['spatial_features_2d'] = batch['spatial_features']
        return self.dense_head(batch)

    def get_training_loss(self, batch: dict) -> tuple:
        """The dense head's targets and losses on a forward's output, which
        carries the batch's 'gt_boxes' and 'gt_mask'; a heatmap head's targets
        at the (H, W) of 'spatial_features_2d'. Returns (loss, tb) with the
        head's entries and 'loss' in `tb`. The focal ladder's importance loss
        ('loss_box_of_pts') is added to an anchor or heatmap head's."""
        if isinstance(self.dense_head, VoxelNeXtHead):
            targets = self.dense_head.assign_targets(batch['gt_boxes'], batch['gt_mask'],
                                                     batch['sp_bev_coords'], batch['sp_bev_mask'])
            loss, tb = self.dense_head.get_loss(batch, targets)
            return loss, {**tb, 'loss': loss}
        if isinstance(self.dense_head, TransFusionHead):
            loss, tb = self.dense_head.get_loss(batch, self.dense_head.assign_targets(batch))
            return loss, {**tb, 'loss': loss}
        if isinstance(self.dense_head, CenterHead):
            targets = self.dense_head.assign_targets(batch['gt_boxes'], batch['gt_mask'],
                                                     batch['spatial_features_2d'].shape[1:3])
        else:
            targets = self.dense_head.assign_targets(batch)
        loss, tb = self.dense_head.get_loss(batch, targets)
        if 'loss_box_of_pts' in batch:
            loss = loss + batch['loss_box_of_pts']
            tb = {**tb, 'loss_box_of_pts': batch['loss_box_of_pts']}
        return loss, {**tb, 'loss': loss}

    def forward_with_loss(self, batch: dict, target_generator=None) -> tuple:
        """Forward, target assignment and losses: (loss, tb). BatchNorm uses
        batch statistics when the model is in training mode. The batch holds
        the model's inputs (the points, or the voxels with, for the sparse
        ladder, the kernel maps and their transposes of
        `get_host_prepare(..., training=True)`) and the ground truth. The
        model draws no random targets: `target_generator` is taken and
        ignored."""
        return self.get_training_loss(self(batch))

    @torch.inference_mode()
    def predict(self, batch: dict) -> dict:
        """Forward + post-processing. The model must be in eval mode.

        With POST_PROCESSING.TTA_FLIP (a list of 'x', 'y', 'xy') the model
        also runs once per entry on the scene mirrored along those axes
        ('points' and 'voxels' negated in x or y, 'voxel_coords' mirrored on
        the grid), mirrors those detections back (heading: 'x' pi - theta,
        'y' -theta, 'xy' pi + theta), and one NMS of the config's type
        merges all the variants, as in the JAX package. The batch's kernel
        maps are not rebuilt for a flip, as the JAX package's `predict` does
        not rebuild them: on the sparse and focal ladders a flipped pass
        runs the unflipped maps (and the unflipped reorder) on features
        whose x or y mean is negated (ROADMAP Queue 3, known faults of the
        reference)."""
        if self.training:
            raise RuntimeError('predict needs eval mode (call model.eval())')
        det = self.post_process(self(batch))
        flips = list(self.model_cfg.POST_PROCESSING.get('TTA_FLIP', []))
        if not flips:
            return det
        gw, gh, _ = self.grid_size
        dets = [det]
        for axes in flips:
            cols = {'x': [0], 'y': [1], 'xy': [0, 1]}[axes]
            fb = dict(batch)
            for col in cols:
                for key in ('points', 'voxels'):
                    if key in fb:
                        fb[key] = fb[key].clone()
                        fb[key][..., col] *= -1.0
                if 'voxel_coords' in fb:       # zyx: column 2 is x, column 1 is y
                    ccol, dim = (2, gw) if col == 0 else (1, gh)
                    fb['voxel_coords'] = fb['voxel_coords'].clone()
                    fb['voxel_coords'][..., ccol] = dim - 1 - fb['voxel_coords'][..., ccol]
            fdet = self.post_process(self(fb))
            boxes = fdet['pred_boxes'].clone()
            for col in cols:
                boxes[..., col] *= -1.0
            boxes[..., 6] = {'x': math.pi - boxes[..., 6], 'y': -boxes[..., 6],
                             'xy': math.pi + boxes[..., 6]}[axes]
            dets.append({**fdet, 'pred_boxes': boxes})
        boxes, scores, labels, valid = (torch.cat([d[k] for d in dets], dim=1) for k in
                                        ('pred_boxes', 'pred_scores', 'pred_labels', 'pred_mask'))
        fb_, fs, fl, fm = model_nms.dispatch_nms(boxes, scores, labels, valid,
                                                 self.model_cfg.POST_PROCESSING.NMS_CONFIG,
                                                 self.num_class)
        return {'pred_boxes': fb_, 'pred_scores': fs, 'pred_labels': fl, 'pred_mask': fm}

    def select_candidates(self, batch: dict):
        """(boxes (B, K, 7), scores, labels (1-based), valid (B, K), the
        per-class scores (B, K, C) or None), valid above SCORE_THRESH. A
        query head's are its queries' decode, valid above its own
        SCORE_THRESH; a heatmap head's its fixed-K decode; an anchor head's
        the sigmoid scores, the best class per anchor and the top 2 *
        NMS_PRE_MAXSIZE anchors by `two_stage_topk`, with their per-class
        scores under NMS_TYPE `multi_classes_nms`."""
        pp = self.model_cfg.POST_PROCESSING
        thresh = pp.get('SCORE_THRESH', 0.1)
        if isinstance(self.dense_head, TransFusionHead):
            out = self.dense_head.generate_predicted_boxes(batch)
            return (out['pred_boxes'], out['pred_scores'], out['pred_labels'] + 1,
                    out['pred_mask'], None)
        if isinstance(self.dense_head, (CenterHead, VoxelNeXtHead)):
            hm = self.dense_head.generate_predicted_boxes(batch)
            return (hm['pred_boxes'][..., :7], hm['pred_scores'], hm['pred_labels'] + 1,
                    hm['pred_mask'] & (hm['pred_scores'] > thresh), None)
        cls_preds, boxes = self.dense_head.generate_predicted_boxes(batch)
        probs = torch.sigmoid(cls_preds)                          # (B, A, nc)
        scores_all, labels_all = probs.max(dim=-1)
        K = min(int(np.max(pp.NMS_CONFIG.NMS_PRE_MAXSIZE)) * 2, scores_all.shape[1])
        scores, sel = two_stage_topk(scores_all, K)
        cls_probs = (take_rows(probs, sel)
                     if pp.NMS_CONFIG.get('NMS_TYPE', 'nms_bev') == 'multi_classes_nms' else None)
        return (take_rows(boxes, sel)[..., :7], scores, take_rows(labels_all, sel) + 1,
                scores > thresh, cls_probs)

    def post_process(self, batch: dict) -> dict:
        """The candidates of `select_candidates` through the NMS of
        NMS_TYPE (`model_nms.dispatch_nms`): class-agnostic, rotated or by
        center distance, or per class (`multi_classes_nms` on an anchor
        head's per-class scores, `class_specific_nms`), the per-class kinds
        gated at SCORE_THRESH. Returns (B, P, 7) boxes and (B, P) scores,
        labels (1-based) and mask."""
        pp = self.model_cfg.POST_PROCESSING
        boxes, scores, labels, valid, cls_probs = self.select_candidates(batch)
        if isinstance(self.dense_head, TransFusionHead):
            # a query head takes no NMS (the reference TransFusion's default)
            return {'pred_boxes': boxes, 'pred_scores': scores * valid,
                    'pred_labels': labels * valid, 'pred_mask': valid}
        per_class = pp.NMS_CONFIG.get('NMS_TYPE', 'nms_bev') in ('multi_classes_nms',
                                                                 'class_specific_nms')
        fb, fs, fl, fm = model_nms.dispatch_nms(
            boxes, scores, labels, valid, pp.NMS_CONFIG, self.num_class, cls_probs=cls_probs,
            score_thresh=pp.get('SCORE_THRESH', 0.1) if per_class else None)
        return {'pred_boxes': fb, 'pred_scores': fs, 'pred_labels': fl, 'pred_mask': fm}


class SECONDNet(Detector3D):
    """SECOND: `Detector3D` with the anchor head, which holds its statistics
    and normalisers global over the ranks on the sparse ladder."""

    DATA_PARALLEL_HELD = ('SparseVoxelBackBone8x', 'SparseVoxelResBackBone8x')
