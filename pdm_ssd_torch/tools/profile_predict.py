"""Where the time of a model's `predict` goes, on one GPU.

    python3 -m pdm_ssd_torch.tools.profile_predict [--cfg_file CFG] [--batch B]
        [--points N] [--reps 7] [--out build/profile_predict.json]

Builds the config (default `configs/kitti_models/pdm_ssd_point.yaml`,
unmodified, at batch 8) with seeded random weights and BatchNorm statistics,
float32 with TF32 off, and feeds it seeded synthetic clouds. Each stage runs
alone on its own precomputed input and is timed with CUDA events (median of
`--reps`); for the flagship the SA level 1 split times FPS and the query +
group on their own. With `--cfg_file configs/kitti_models/pointrcnn.yaml`
the model is PointRCNN with the FP list made whole
(`utils/synthetic.pointrcnn_fp3`), at the file's batch of 4, and the stages
are the backbone's SA levels (each level's ball query, and the grid build
of those on the grid path, apart too), its FP modules, the point head, the proposal
layer, ROI pooling, the ROI SA stack and the final NMS. With `--cfg_file
configs/kitti_models/second_sparse.yaml` the model is SECOND on the sparse
voxel ladder as shipped, at the file's batch of 4 on LiDAR-like clouds of
50000 points (`utils/synthetic.lidar_points`), and the stages are the
voxelizer, the kernel-map build, the VFE with the reorder, each of the 12
sparse layers (the whole layer, and its `sparse_conv` kernel alone through
the plan its forward built), the 8 plans of a forward (`sp_plans`), the
canvas scatter, the BEV backbone, the head, top-K + decode and the NMS; the
classification bias is set to 0 so that the candidates pass the score
threshold and the NMS does its full work. With `--cfg_file
configs/kitti_models/pdm_ssd.yaml` (or `pdm_ssd_large.yaml`, at batch 4 on
clouds of 163840 points over its +-75.2 m range) the stages are
pillarize, each level of `GridPointBackbone`, the grid PDM neck, the BEV
backbone, the heatmap head (each with the GFLOP of its convolutions, its
rate and its peak memory beyond its input) and post-processing with the
circle NMS; the heatmap bias is set to 0, as SECOND's. With
`configs/kitti_models/pointpillar.yaml` (B=8), `second.yaml` (B=4; both on
LiDAR-like clouds of 50000 points, voxelized on the card),
`centerpoint_pillar.yaml` or `pillarnet.yaml` (B=8, N=16384) the stages
are the slots of `Detector3D` (VFE, 3D backbone, map to BEV, BEV backbone,
head; each convolving one with its GFLOP, rate and peak memory), top-K +
decode and the NMS, the classification bias at 0. With
`configs/kitti_models/voxelnext.yaml` or `second_focal.yaml` (B=4, LiDAR-like
clouds of 50000 points) the stages are the map build (the sparse ladder with
VoxelNeXt's BEV slot table, or the focal ladder) and then those slots, the
bias at 0. With `configs/kitti_models/pv_rcnn.yaml`, `pv_rcnn_sparse.yaml`,
`voxel_rcnn.yaml` or `voxel_rcnn_sparse.yaml` (B=4, LiDAR-like clouds of
16384 points, the `sample_points` of their data processor, voxelized on the
card into their 16000 slots) the stages are those of
`two_stage_stage_times`, the anchor bias at 0. With
`configs/kitti_models/dsvt.yaml` or `transfusion.yaml` (B=8, N=16384) the
stages are the slots of `Detector3D` and the parts of the window-attention
backbone or of the query head (`query_stage_times`), DSVT's heatmap bias
at 0 (TransFusion's scores pass its threshold as seeded). With `--cfg_file
caddn` (`utils/synthetic.caddn_kitti`, CaDDN at its published widths, which
no file holds; B=2, 375 x 1242 images of the mini KITTI camera) the stages
are the image backbone, the depth head with the frustum's outer product,
the frustum-to-voxel sample (the voxel centres' projection and corners
apart), the BEV backbone, the anchor head, top-K + decode and the NMS
(`caddn_stage_times`), the classification bias at 0. Then
`torch.profiler` traces three `predict` calls: device time per predict,
device activities per predict, the busy share (device time over the
unprofiled wall time of one predict), the ten kernels with the most device
time and any kernel of cuDNN's FFT route. Prints one line per
stage and writes everything, with the card's name and power limit, as JSON
to `--out`. Must be run from the repository root.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch

from ..models import get_host_prepare
from ..models.backbones_3d.sparse_backbone import SparseConvBNReLU
from ..ops import dispatch, sa_fused
from ..ops.ball_query import ball_query_plan, build_grid
from ..ops.pointnet2 import gather_operation
from ..ops.sparse_conv import sparse_conv_plan
from ..ops.voxelize import voxelize_batch
from ..utils import synthetic

CFG = 'configs/kitti_models/pdm_ssd_point.yaml'


def median_ms(fn, reps: int) -> float:
    fn()                                        # warm-up: allocator, cuDNN plans
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


STAGES = ('backbone_3d', 'point_head', 'pdm_neck', 'backbone_2d', 'dense_head')


def stage_times(net, cfg, predict_inputs: dict, reps: int) -> dict:
    """Median ms of each stage of `predict`, each on its own input."""
    pts = predict_inputs['points']
    inputs, batch = {}, {'points': pts}
    for name in STAGES:
        inputs[name] = batch
        batch = getattr(net, name)(dict(batch))
    sa0 = net.backbone_3d.sa_0
    agg = sa0.agg
    xyz, feats = pts[..., :3], pts[..., 3:]
    new_xyz = gather_operation(xyz, dispatch.farthest_point_sample(xyz, sa0.npoint))
    t = {
        'sa1_fps': median_ms(lambda: dispatch.farthest_point_sample(xyz, sa0.npoint), reps),
        'sa1_query_group': median_ms(lambda: sa_fused.fused_query_group(
            agg.radii, agg.nsamples, xyz, feats, new_xyz, agg.pc_range, cap=agg.bucket_cap),
            reps),
        'sa1_group_mlp': median_ms(lambda: agg(xyz, feats, new_xyz), reps),
        'sa1': median_ms(lambda: sa0(xyz, feats, 'fps'), reps),
    }
    for name in STAGES:
        t[name] = median_ms(lambda: getattr(net, name)(dict(inputs[name])), reps)
    t['post_process'] = median_ms(lambda: net.post_process(dict(batch)), reps)
    t['predict'] = median_ms(lambda: net.predict({'points': pts}), reps)
    t['sa1_mlp'] = t['sa1_group_mlp'] - t['sa1_query_group']
    t['sa2_sa3'] = t['backbone_3d'] - t['sa1']
    return t


def pointrcnn_stage_times(net, cfg, predict_inputs: dict, reps: int) -> dict:
    """Median ms of each stage of PointRCNN's `predict`, each on its own input."""
    from ..models.roi_heads.pointrcnn_head import pool_roi_points_ref
    pts = predict_inputs['points']
    bb, head = net.backbone_3d, net.roi_head
    t = {}

    def fp_modules(l_xyz, l_feat):
        l_feat = list(l_feat)
        for i in range(-1, -(bb.n_fp + 1), -1):
            l_feat[i - 1] = getattr(bb, f'fp_{bb.n_fp + i}')(l_xyz[i - 1], l_xyz[i],
                                                            l_feat[i - 1], l_feat[i])
        return l_feat

    n_fp, bb.n_fp = bb.n_fp, 0                   # the SA ladder alone, with its own sampler logic
    try:
        sa_out = bb({'points': pts})
        t['backbone_sa'] = median_ms(lambda: bb({'points': pts}), reps)
    finally:
        bb.n_fp = n_fp
    l_xyz, l_feat = sa_out['sa_xyz'], sa_out['sa_features']
    for k in range(len(bb.npoints)):
        sa = getattr(bb, f'sa_{k}')
        new_xyz = l_xyz[k + 1]
        t[f'sa{k + 1}_ball_query'] = median_ms(lambda: dispatch.ball_query_level(
            sa.radii, sa.nsamples, l_xyz[k], new_xyz), reps)
        plan = ball_query_plan(l_xyz[k].shape[1], sa.radii)
        if plan.path == 'grid':
            t[f'sa{k + 1}_grid_build'] = median_ms(lambda: build_grid(
                l_xyz[k].contiguous(), plan.cell), reps)
    t['sa2_fps'] = median_ms(lambda: dispatch.farthest_point_sample(
        l_xyz[1].contiguous(), bb.npoints[1]), reps)
    t['backbone_fp'] = median_ms(lambda: fp_modules(l_xyz, l_feat), reps)
    t['backbone_3d'] = median_ms(lambda: bb({'points': pts}), reps)
    batch = bb({'points': pts})
    t['point_head'] = median_ms(lambda: net.point_head(dict(batch)), reps)
    batch = net.point_head(batch)
    cls_preds, box_preds = net.point_head.generate_predicted_boxes(
        batch['point_coords'], batch['point_cls_preds'], batch['point_box_preds'])
    batch['batch_cls_preds'], batch['batch_box_preds'] = cls_preds, box_preds
    t['proposal_layer'] = median_ms(lambda: head.proposal_layer(dict(batch)), reps)
    batch = head.proposal_layer(batch)
    pool = head.model_cfg.ROI_POINT_POOL
    t['roi_pooling'] = median_ms(lambda: pool_roi_points_ref(
        batch['point_coords'], batch['rois'], int(pool.NUM_SAMPLED_POINTS),
        pool.POOL_EXTRA_WIDTH, roi_mask=batch['roi_mask']), reps)
    head.proposal_layer = lambda b: b            # time the head without its proposal layer
    try:
        t['roi_head_after_proposals'] = median_ms(lambda: head(dict(batch)), reps)
        batch = head(batch)
    finally:
        del head.proposal_layer
    t['roi_sa_stack'] = t['roi_head_after_proposals'] - t['roi_pooling']
    t['post_process'] = median_ms(lambda: net.post_process(dict(batch)), reps)
    t['predict'] = median_ms(lambda: net.predict({'points': pts}), reps)
    return t


def second_stage_times(net, cfg, predict_inputs: dict, reps: int) -> dict:
    """Median ms of each stage of SECOND's `predict`, each on its own input;
    `sp_<layer>` is a whole sparse layer (kernel, BatchNorm, ReLU, masks),
    `sp_<layer>_kernel` its `sparse_conv` launch alone."""
    proc = synthetic.voxel_processor(cfg)
    pc_range = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
    pts = predict_inputs['points']
    raw = {k: v for k, v in predict_inputs.items() if not k.startswith('sp_')}
    prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG)
    bb = net.backbone_3d
    t = {'voxelize': median_ms(lambda: voxelize_batch(
             pts, pc_range, list(proc.VOXEL_SIZE), int(proc.MAX_POINTS_PER_VOXEL),
             int(proc.MAX_NUMBER_OF_VOXELS['test'])), reps),
         'map_build': median_ms(lambda: prepare(raw), reps)}
    batch = net.vfe(dict(predict_inputs))
    t['vfe_reorder'] = median_ms(lambda: dispatch.gather_rows(
        net.vfe(dict(predict_inputs))['voxel_features'], predict_inputs['sp_perm1']), reps)
    calls = {}          # layer name -> the arguments of its one call in a forward
    hooks = [m.register_forward_pre_hook(lambda mod, args, name=name: calls.setdefault(name, args))
             for name, m in bb.named_modules() if isinstance(m, SparseConvBNReLU)]
    try:
        batch = bb(batch)
    finally:
        for h in hooks:
            h.remove()
    modules = dict(bb.named_modules())
    for name, args in calls.items():
        key = name.replace('.SparseConvBNReLU_', '_')
        t[f'sp_{key}'] = median_ms(lambda: modules[name](*args), reps)
        t[f'sp_{key}_kernel'] = median_ms(
            lambda: dispatch.sparse_conv(args[0], args[1], modules[name].kernel, args[3]), reps)
    plans = {id(args[3]): (args[1], args[3].vin) for args in calls.values()}
    t['sp_plans'] = median_ms(lambda: [sparse_conv_plan(nbr, vin) for nbr, vin in plans.values()],
                              reps)
    t['sparse_layers'] = sum(v for k, v in t.items() if k.startswith('sp_')
                             and not k.endswith('_kernel') and k != 'sp_plans')
    t['sparse_conv_kernels'] = sum(v for k, v in t.items() if k.endswith('_kernel'))
    t['sparse_conv_plans_and_kernels'] = t['sparse_conv_kernels'] + t['sp_plans']
    x, coords, mask = batch['encoded_sparse_out']
    t['canvas_scatter'] = median_ms(lambda: bb.scatter_to_bev(x, coords, mask), reps)
    t['backbone_3d'] = median_ms(lambda: bb(net.vfe(dict(predict_inputs))), reps)
    t['backbone_2d'] = median_ms(lambda: net.backbone_2d(dict(batch)), reps)
    batch = net.backbone_2d(batch)
    t['dense_head'] = median_ms(lambda: net.dense_head(dict(batch)), reps)
    batch = net.dense_head(batch)
    t['topk_decode'] = median_ms(lambda: net.select_candidates(batch), reps)
    t['post_process'] = median_ms(lambda: net.post_process(batch), reps)
    t['nms'] = t['post_process'] - t['topk_decode']
    t['predict'] = median_ms(lambda: net.predict(predict_inputs), reps)
    t['predict_with_voxelize_and_maps'] = t['predict'] + t['voxelize'] + t['map_build']
    sites = predict_inputs['sp_sites']
    for i, stage in enumerate(('stage1', 'stage2', 'stage3', 'stage4', 'out')):
        t[f'sites_{stage}_mean'] = float(sites[:, i].float().mean())
    return t


def conv_gflop(fn) -> float:
    """GFLOP of the convolutions `fn` runs (2 per multiply-add), counted by
    `torch.utils.flop_counter` from the shapes."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops() / 1e9


def peak_extra_gib(fn) -> float:
    """GiB allocated at the peak of `fn` beyond what was allocated before it
    (its outputs, temporaries and cuDNN's workspace)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 2 ** 30


def grid_conv_stages(net, pts: torch.Tensor) -> tuple:
    """The convolution stages of a grid-family `predict`, each on its own
    precomputed input: ([(name, fn)], the dense head's output batch)."""
    bb = net.backbone_3d
    stages = []
    x = bb.pillarize({'points': pts})
    for lvl in range(len(bb.layer_nums)):
        stages.append((f'lvl{lvl}', lambda x=x, lvl=lvl: bb.level(lvl, x)))
        x = bb.level(lvl, x)
    batch = {'spatial_features': x.permute(0, 2, 3, 1)}
    for name, key in (('pdm_neck_conv', 'pdm_neck'), ('backbone_2d', 'backbone_2d'),
                      ('dense_head', 'dense_head')):
        stages.append((name, lambda b=dict(batch), key=key: getattr(net, key)(dict(b))))
        batch = getattr(net, key)(batch)
    return stages, batch


def grid_stage_times(net, cfg, predict_inputs: dict, reps: int) -> dict:
    """Median ms of each stage of the grid family's `predict`
    (`configs/kitti_models/pdm_ssd.yaml`, `pdm_ssd_large.yaml`), each on its
    own input: pillarize, each level of `GridPointBackbone`, the grid PDM
    neck, the BEV backbone, the heatmap head and post-processing (decode and
    circle NMS); beside each convolution stage its GFLOP (`<stage>_gflop`),
    its rate (`<stage>_tflops`) and the GiB it allocates at its peak beyond
    its input (`<stage>_peak_gib`)."""
    pts = predict_inputs['points']
    bb = net.backbone_3d
    t = {'pillarize': median_ms(lambda: bb.pillarize({'points': pts}), reps)}
    stages, batch = grid_conv_stages(net, pts)
    for name, fn in stages:
        t[name] = median_ms(fn, reps)
        t[f'{name}_gflop'] = conv_gflop(fn)
        t[f'{name}_tflops'] = t[f'{name}_gflop'] / t[name]     # GFLOP / ms
        t[f'{name}_peak_gib'] = peak_extra_gib(fn)
    t['backbone_3d'] = median_ms(lambda: bb({'points': pts}), reps)
    t['post_process'] = median_ms(lambda: net.post_process(dict(batch)), reps)
    t['predict'] = median_ms(lambda: net.predict({'points': pts}), reps)
    t['conv_gflop'] = sum(v for k, v in t.items() if k.endswith('_gflop'))
    return t


def detector3d_stage_times(net, cfg, predict_inputs: dict, reps: int) -> dict:
    """Median ms of each slot of a `Detector3D` (`pointpillar.yaml`,
    `centerpoint_pillar.yaml`, `pillarnet.yaml`, the dense `second.yaml`),
    each on its own input, with the GFLOP, rate and peak GiB beyond its
    input of each slot that convolves (`<slot>_gflop`, `_tflops`,
    `_peak_gib`); then the head's decode and the NMS."""
    t = {}
    batch = dict(predict_inputs)
    for slot, name in list(net.slots.items()) + [('dense_head', None)]:
        module = getattr(net, name) if name else net.dense_head
        fn = (lambda m=module, b=dict(batch): m(dict(b)))
        t[slot] = median_ms(fn, reps)
        gflop = conv_gflop(fn)
        if gflop > 0:
            t[f'{slot}_gflop'] = gflop
            t[f'{slot}_tflops'] = gflop / t[slot]            # GFLOP / ms
            t[f'{slot}_peak_gib'] = peak_extra_gib(fn)
        batch = module(batch)
    t['topk_decode'] = median_ms(lambda: net.select_candidates(batch), reps)
    t['post_process'] = median_ms(lambda: net.post_process(batch), reps)
    t['nms'] = t['post_process'] - t['topk_decode']
    t['predict'] = median_ms(lambda: net.predict(predict_inputs), reps)
    t['conv_gflop'] = sum(v for k, v in t.items() if k.endswith('_gflop'))
    return t


def query_stage_times(net, cfg, predict_inputs: dict, reps: int) -> dict:
    """`detector3d_stage_times` of DSVT or TransFusion, then the parts of
    its new module, each on its own input: of `DSVTBackbone`, each stage's
    projection and pool and each block's windowing (the window and unwindow
    copies), LayerNorm with attention, and LayerNorm with FFN; of
    `TransFusionHead`, the shared conv, the heatmap with the query pick, the
    queries' gather, the self-attention, the cross-attention to every BEV
    token, and the FFN with the five branches."""
    from torch.nn import functional as F
    from ..models.backbones_2d.dsvt_backbone import _max_pool_same
    from ..ops import losses
    from ..ops.selection import two_stage_topk
    t = detector3d_stage_times(net, cfg, predict_inputs, reps)
    batch = dict(predict_inputs)
    for name in net.slots.values():
        if name == net.slots.get('backbone_2d') and cfg.MODEL.NAME == 'DSVT':
            break
        batch = getattr(net, name)(batch)
    if cfg.MODEL.NAME == 'DSVT':
        bb = net.backbone_2d
        x = batch['spatial_features']
        occ = (x.abs() > 0).any(dim=-1)
        for si, stride in enumerate(bb.strides):
            ph, pw = (-x.shape[1]) % bb.wy, (-x.shape[2]) % bb.wx
            if ph or pw:
                x, occ = F.pad(x, (0, 0, 0, pw, 0, ph)), F.pad(occ, (0, pw, 0, ph))
            proj = getattr(bb, f's{si}_proj')
            t[f'dsvt_s{si}_proj'] = median_ms(lambda: proj(x), reps)
            x = proj(x)
            for bi in range(bb.blocks[si]):
                blk, xm, key = getattr(bb, f's{si}_block{bi}'), bi % 2 == 0, f'dsvt_s{si}_b{bi}'
                xw, mw = bb.window(x, xm), bb.window(occ, xm)[:, None, None, :]
                t[f'{key}_window'] = median_ms(
                    lambda: bb.unwindow(bb.window(x, xm), x.shape, xm), reps)
                t[f'{key}_attn'] = median_ms(lambda: blk.attn(blk.ln1(xw), mask=mw), reps)
                h = xw + blk.attn(blk.ln1(xw), mask=mw)
                t[f'{key}_ffn'] = median_ms(
                    lambda: blk.ff2(torch.relu(blk.ff1(blk.ln2(h)))), reps)
                x = bb.unwindow(blk(xw, mw[:, 0, 0]), x.shape, xm)
            x = torch.where(occ[..., None], x, 0.0)
            if stride > 1:
                t[f'dsvt_s{si}_pool'] = median_ms(lambda: _max_pool_same(x, stride), reps)
                x = _max_pool_same(x, stride)
                occ = _max_pool_same(occ[..., None].to(x.dtype), stride)[..., 0] > 0.5
        return t
    head = net.dense_head
    x = batch['spatial_features_2d'].permute(0, 3, 1, 2)
    B, _, H, W = x.shape
    t['tf_shared_conv'] = median_ms(lambda: torch.relu(head.shared_bn(head.shared(x))), reps)
    feat = torch.relu(head.shared_bn(head.shared(x)))

    def pick():
        hm = torch.sigmoid(head.heatmap_conv(feat).permute(0, 2, 3, 1))
        return two_stage_topk(hm.amax(dim=-1).reshape(B, H * W), head.num_proposals)

    t['tf_heatmap_pick'] = median_ms(pick, reps)
    top_idx = pick()[1]
    tokens = feat.permute(0, 2, 3, 1).reshape(B, H * W, -1) + head.pos_encoding(H, W, feat)
    t['tf_query_gather'] = median_ms(lambda: losses.gather_feat(tokens, top_idx), reps)
    q = losses.gather_feat(tokens, top_idx)
    t['tf_self_attn'] = median_ms(lambda: head.self_attn(head.ln_sa(q)), reps)
    t['tf_cross_attn'] = median_ms(lambda: head.cross_attn(head.ln_ca(q), tokens), reps)
    t['tf_ffn_branches'] = median_ms(lambda: [
        getattr(head, f'{n}_out')(torch.relu(getattr(head, f'{n}_fc')(
            head.ff2(torch.relu(head.ff1(head.ln_ff(q))))))) for n in
        ('center', 'height', 'dim', 'rot', 'cls')], reps)
    return t


def ladder_stage_times(net, cfg, predict_inputs: dict, reps: int) -> dict:
    """`detector3d_stage_times` of a model on the sparse or focal ladder
    (`voxelnext.yaml`, `second_focal.yaml`), after the map build of the batch
    (`map_build`: `get_host_prepare` on the voxelized batch without its
    maps), timed apart."""
    raw = {k: v for k, v in predict_inputs.items() if not k.startswith(('sp_', 'fl_'))}
    prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG)
    t = {'map_build': median_ms(lambda: prepare(raw), reps)}
    t.update(detector3d_stage_times(net, cfg, predict_inputs, reps))
    t['predict_with_map_build'] = t['predict'] + t['map_build']
    return t


def two_stage_stage_times(net, cfg, predict_inputs: dict, reps: int) -> dict:
    """Median ms of each stage of PV-RCNN or Voxel R-CNN, each on its own
    input: the sparse ladder's map build (timed apart, `map_build`), the
    first stage's slots (VFE, 3D backbone, BEV backbone, anchor head) and
    the decode of its boxes; PV-RCNN's keypoints (`pfe_fps`, FPS alone),
    the whole VSA (`pfe`) and the point head; then the proposal layer, the
    grid pool's selection (PV-RCNN: the preselection and one ball query of
    all radii, `roi_grid_select`), the whole ROI head (`roi_head`, the
    proposals included) and the post-processing with its NMS."""
    from ..models.detectors.pv_rcnn import PVRCNN
    t = {}
    if any(k.startswith('sp_') for k in predict_inputs):
        raw = {k: v for k, v in predict_inputs.items() if not k.startswith('sp_')}
        prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG)
        t['map_build'] = median_ms(lambda: prepare(raw), reps)
    batch = dict(predict_inputs)
    for name in ('vfe', 'backbone_3d', 'backbone_2d', 'dense_head'):
        module = getattr(net, name)
        t[name] = median_ms(lambda m=module, b=dict(batch): m(dict(b)), reps)
        batch = module(batch)
    t['decode'] = median_ms(lambda: net.dense_head.generate_predicted_boxes(batch), reps)
    cls_preds, box_preds = net.dense_head.generate_predicted_boxes(batch)
    batch.update(batch_cls_preds=cls_preds, batch_box_preds=box_preds)
    if isinstance(net, PVRCNN) and net.pfe is not None:
        xyz = batch['points'][..., :3].contiguous()
        t['pfe_fps'] = median_ms(lambda: dispatch.farthest_point_sample(
            xyz, int(net.pfe.cfg.NUM_KEYPOINTS)), reps)
        t['pfe'] = median_ms(lambda b=dict(batch): net.pfe(dict(b)), reps)
        batch = net.pfe(batch)
        if net.point_head is not None:
            t['point_head'] = median_ms(lambda b=dict(batch): net.point_head(dict(b)), reps)
            batch = net.point_head(batch)
    head = net.roi_head
    t['proposal_layer'] = median_ms(lambda b=dict(batch): head.proposal_layer(dict(b)), reps)
    if hasattr(head, 'grid_select'):
        proposed = head.proposal_layer(dict(batch))
        t['roi_grid_select'] = median_ms(
            lambda: head.grid_select(proposed, proposed['rois']), reps)
    t['roi_head'] = median_ms(lambda b=dict(batch): head(dict(b)), reps)
    batch = head(batch)
    t['post_process'] = median_ms(lambda: net.post_process(batch), reps)
    t['predict'] = median_ms(lambda: net.predict(predict_inputs), reps)
    if 'map_build' in t:
        t['predict_with_map_build'] = t['predict'] + t['map_build']
    return t


def caddn_stage_times(net, cfg, predict_inputs: dict, reps: int) -> dict:
    """Median ms of CaDDN's stages, each on its own input made in advance:
    the image backbone; the depth head with the softmax and the frustum's
    outer product, on the backbone's features; the frustum-to-voxel sample
    whole, and its two parts apart: the projection of the voxel centres into
    corner rows and weights (`frustum_corners`) and the sample on those
    corners (`sample_frustum`: the 8 corner gathers, weighted and summed);
    the BEV backbone, the anchor head, top-K + decode and the NMS; with the
    GFLOP of the convolutions of the image backbone and of the BEV
    backbone."""
    from ..models.detectors.caddn import frustum_corners, sample_frustum, voxel_centers
    t = {}
    imgs = predict_inputs['camera_imgs']
    t['image_backbone'] = median_ms(lambda: net.image_backbone(imgs), reps)
    t['image_backbone_gflop'] = conv_gflop(lambda: net.image_backbone(imgs))
    feats = net.image_backbone(imgs)[:, 0]
    t['depth_head_frustum'] = median_ms(lambda: net.depth_frustum(feats), reps)
    logits, frustum = net.depth_frustum(feats)
    B, fH, fW, D, C = frustum.shape
    centers = voxel_centers(net.grid_size, net.voxel_size, net.pc_range, frustum.device)
    corner_args = (centers, predict_inputs['trans_lidar_to_cam'],
                   predict_inputs['trans_cam_to_img'], tuple(imgs.shape[2:4]), (fH, fW, D),
                   net.depth_range)
    t['frustum_corners'] = median_ms(lambda: frustum_corners(*corner_args), reps)
    rows, weights, valid = frustum_corners(*corner_args)
    flat = frustum.reshape(B, fH * fW * D, C)
    t['frustum_sample'] = median_ms(lambda: sample_frustum(flat, rows, weights, valid), reps)
    t['frustum_to_voxel'] = median_ms(lambda: net.frustum_to_bev(frustum, predict_inputs), reps)
    batch = dict(predict_inputs, depth_logits=logits,
                 spatial_features=net.frustum_to_bev(frustum, predict_inputs))
    t['bev_backbone'] = median_ms(lambda: net.backbone_2d(dict(batch)), reps)
    t['bev_backbone_gflop'] = conv_gflop(lambda: net.backbone_2d(dict(batch)))
    batch = net.backbone_2d(batch)
    t['dense_head'] = median_ms(lambda: net.dense_head(dict(batch)), reps)
    batch = net.dense_head(batch)
    t['topk_decode'] = median_ms(lambda: net.select_candidates(batch), reps)
    t['post_process'] = median_ms(lambda: net.post_process(batch), reps)
    t['nms'] = t['post_process'] - t['topk_decode']
    t['predict'] = median_ms(lambda: net.predict(predict_inputs), reps)
    return t


def caddn_inputs(cfg, B: int, N: int) -> dict:
    """`synthetic.caddn_batch`'s serving batch on the card."""
    return synthetic.caddn_batch(B, N, cfg, seed=5, device='cuda')


def point_inputs(cfg, B: int, N: int) -> dict:
    return {'points': torch.from_numpy(synthetic.kitti_points(B, N, 5)).cuda()}


def large_inputs(cfg, B: int, N: int) -> dict:
    return {'points': torch.from_numpy(synthetic.large_scene_points(B, N, 5)).cuda()}


def second_inputs(cfg, B: int, N: int) -> dict:
    """A voxel model's serving batch of LiDAR-like clouds, voxelized on the
    card, with the kernel maps of a model that has them."""
    batch = synthetic.voxel_batch(B, N, cfg, seed=5, device='cuda')
    prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG)
    return batch if prepare is None else prepare(batch)


# per `MODEL.NAME` (and, for PDMSSD, backbone): what makes the config full
# width, the default batch and points per cloud, what makes the input of
# `predict`, the function that times the model's stages, and what is done to
# the seeded model before it is timed
PROFILES = {'PDMSSD': (lambda cfg: cfg, 8, 16384, point_inputs, stage_times, None),
            'PDMSSD grid': (lambda cfg: cfg, 8, 16384, point_inputs, grid_stage_times,
                            synthetic.open_score_gate),
            'PDMSSD grid large': (lambda cfg: cfg, 4, 163840, large_inputs, grid_stage_times,
                                  synthetic.open_score_gate),
            'PointRCNN': (synthetic.pointrcnn_fp3, 4, 16384, point_inputs, pointrcnn_stage_times,
                          None),
            'SECONDNet': (lambda cfg: cfg, 4, 50000, second_inputs, second_stage_times,
                          synthetic.open_score_gate),
            'SECONDNet dense': (lambda cfg: cfg, 4, 50000, second_inputs,
                                detector3d_stage_times, synthetic.open_score_gate),
            'PointPillar': (lambda cfg: cfg, 8, 50000, second_inputs, detector3d_stage_times,
                            synthetic.open_score_gate),
            'CenterPoint': (lambda cfg: cfg, 8, 16384, point_inputs, detector3d_stage_times,
                            synthetic.open_score_gate),
            'PillarNet': (lambda cfg: cfg, 8, 16384, point_inputs, detector3d_stage_times,
                          synthetic.open_score_gate),
            'SECONDNet focal': (lambda cfg: cfg, 4, 50000, second_inputs, ladder_stage_times,
                                synthetic.open_score_gate),
            'VoxelNeXt': (lambda cfg: cfg, 4, 50000, second_inputs, ladder_stage_times,
                          synthetic.open_score_gate),
            'PVRCNN': (lambda cfg: cfg, 4, 16384, second_inputs, two_stage_stage_times,
                       synthetic.open_score_gate),
            'VoxelRCNN': (lambda cfg: cfg, 4, 16384, second_inputs, two_stage_stage_times,
                          synthetic.open_score_gate),
            'DSVT': (lambda cfg: cfg, 8, 16384, point_inputs, query_stage_times,
                     synthetic.open_score_gate),
            'TransFusion': (lambda cfg: cfg, 8, 16384, point_inputs, query_stage_times, None),
            'CaDDN': (lambda cfg: cfg, 2, 16384, caddn_inputs, caddn_stage_times,
                      synthetic.open_score_gate)}


def profile_key(cfg) -> str:
    """The key of a config in PROFILES."""
    name = cfg.MODEL.NAME
    if name == 'SECONDNet':
        bb = cfg.MODEL.BACKBONE_3D.get('NAME', '')
        return 'SECONDNet' if bb.startswith('Sparse') else \
            'SECONDNet focal' if bb == 'VoxelBackBone8xFocal' else 'SECONDNet dense'
    if name != 'PDMSSD' or cfg.MODEL.BACKBONE_3D.get('NAME') != 'GridPointBackbone':
        return name
    return 'PDMSSD grid large' if cfg.DATA_CONFIG.POINT_CLOUD_RANGE[0] < 0 else 'PDMSSD grid'


def is_fft_route(kernel: str) -> bool:
    """A kernel of cuDNN's FFT convolutions: the transforms ('fft' in the
    name) and the batched complex GEMMs between them ('cf32')."""
    return 'fft' in kernel.lower() or 'cf32' in kernel


def trace(net, predict_inputs: dict, n: int = 3) -> dict:
    """torch.profiler over `n` predicts: device time and activities per
    predict, the ten kernels with the most device time, and every kernel of
    an FFT route (`is_fft_route`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    net.predict(predict_inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            net.predict(predict_inputs)
        torch.cuda.synchronize()
    # kernels, copies and memsets only: an operator's own row repeats the
    # device time of the kernels it launched
    rows = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    if not rows:
        raise SystemExit('torch.profiler recorded no device activity')
    device_us = sum(r[2] for r in rows)
    rows.sort(key=lambda r: -r[2])
    return {'device_ms_per_predict': device_us / 1e3 / n,
            'device_activities_per_predict': sum(r[1] for r in rows) / n,
            'top_kernels': [{'name': k[:120], 'calls_per_predict': c / n,
                             'ms_per_predict': us / 1e3 / n} for k, c, us in rows[:10]],
            'fft_kernels': [{'name': k[:120], 'calls_per_predict': c / n,
                             'ms_per_predict': us / 1e3 / n} for k, c, us in rows
                            if is_fft_route(k)]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--cfg_file', default=CFG, help='a config file, or caddn')
    ap.add_argument('--batch', type=int, default=None,
                    help='default: 8 for the PDM configs, 4 for PointRCNN, SECOND, the '
                    'two-stage voxel models and pdm_ssd_large.yaml, 2 for CaDDN')
    ap.add_argument('--points', type=int, default=None,
                    help='points per cloud (default: 16384; 50000 for SECOND, 163840 for '
                    'pdm_ssd_large.yaml)')
    ap.add_argument('--reps', type=int, default=7)
    ap.add_argument('--out', default='build/profile_predict.json')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader', '-i', '0'],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = synthetic.load_cfg(args.cfg_file)
    if profile_key(cfg) not in PROFILES:
        raise SystemExit(f'no stage timing for {cfg.MODEL.NAME}')
    full_width, batch, points, make_inputs, time_stages, adjust = PROFILES[profile_key(cfg)]
    cfg = full_width(cfg)
    if args.batch is None:
        args.batch = batch
    if args.points is None:
        args.points = points
    net = synthetic.random_model(cfg, 'cuda', seed=7)
    if adjust is not None:
        adjust(net)
    inputs = make_inputs(cfg, args.batch, args.points)
    with torch.inference_mode():
        stages = time_stages(net, cfg, inputs, args.reps)
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        net.predict(inputs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = statistics.median(walls) * 1e3
    prof = trace(net, inputs)
    prof['busy_share'] = prof['device_ms_per_predict'] / wall_ms
    units = {'_gflop': 'GFLOP', '_tflops': 'TFLOP/s', '_gib': 'GiB'}
    for k, v in stages.items():
        unit = next((u for suffix, u in units.items() if k.endswith(suffix)), 'ms')
        print(f'{k:26s} {v:9.3f} {unit}')
    print(f'predict wall {wall_ms:.3f} ms; device {prof["device_ms_per_predict"]:.3f} ms per '
          f'predict ({prof["device_activities_per_predict"]:.0f} activities), busy '
          f'{prof["busy_share"]:.3f}; B={args.batch} N={args.points}; {card}')
    for r in prof['top_kernels']:
        print(f'  {r["ms_per_predict"]:8.3f} ms  x{r["calls_per_predict"]:<6g} {r["name"]}')
    print(f'FFT-route kernels: {len(prof["fft_kernels"])}, '
          f'{sum(r["ms_per_predict"] for r in prof["fft_kernels"]):.3f} ms per predict')
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({'card': card, 'cfg_file': args.cfg_file, 'batch': args.batch,
                               'points': args.points, 'reps': args.reps, 'stages_ms': stages,
                               'predict_wall_ms': wall_ms, 'profile': prof}, indent=1))


if __name__ == '__main__':
    main()
