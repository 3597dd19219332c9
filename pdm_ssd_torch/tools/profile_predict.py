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
circle NMS; the heatmap bias is set to 0, as SECOND's. Then
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
from ..utils.config import cfg_from_yaml_file

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
        t[f'{name}_tflops'] = t[f'{name}_gflop'] / t[name] / 1e3
        t[f'{name}_peak_gib'] = peak_extra_gib(fn)
    t['backbone_3d'] = median_ms(lambda: bb({'points': pts}), reps)
    t['post_process'] = median_ms(lambda: net.post_process(dict(batch)), reps)
    t['predict'] = median_ms(lambda: net.predict({'points': pts}), reps)
    t['conv_gflop'] = sum(v for k, v in t.items() if k.endswith('_gflop'))
    return t


def point_inputs(cfg, B: int, N: int) -> dict:
    return {'points': torch.from_numpy(synthetic.kitti_points(B, N, 5)).cuda()}


def large_inputs(cfg, B: int, N: int) -> dict:
    return {'points': torch.from_numpy(synthetic.large_scene_points(B, N, 5)).cuda()}


def second_inputs(cfg, B: int, N: int) -> dict:
    return get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG)(
        synthetic.voxel_batch(B, N, cfg, seed=5, device='cuda'))


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
                          synthetic.open_score_gate)}


def profile_key(cfg) -> str:
    """The key of a config in PROFILES."""
    if cfg.MODEL.NAME != 'PDMSSD' or cfg.MODEL.BACKBONE_3D.get('NAME') != 'GridPointBackbone':
        return cfg.MODEL.NAME
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
    ap.add_argument('--cfg_file', default=CFG)
    ap.add_argument('--batch', type=int, default=None,
                    help='default: 8 for the PDM configs, 4 for PointRCNN, SECOND and '
                    'pdm_ssd_large.yaml')
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
    cfg = cfg_from_yaml_file(args.cfg_file)
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
