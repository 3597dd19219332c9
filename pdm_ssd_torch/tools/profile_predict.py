"""Where the time of a model's `predict` goes, on one GPU.

    python3 -m pdm_ssd_torch.tools.profile_predict [--cfg_file CFG] [--batch B]
        [--points 16384] [--reps 7] [--out build/profile_predict.json]

Builds the config (default `configs/kitti_models/pdm_ssd_point.yaml`,
unmodified, at batch 8) with seeded random weights and BatchNorm statistics,
float32 with TF32 off, and feeds it seeded synthetic clouds. Each stage runs
alone on its own precomputed input and is timed with CUDA events (median of
`--reps`); for the flagship the SA level 1 split times FPS and the query +
group on their own. With `--cfg_file configs/kitti_models/pointrcnn.yaml`
the model is PointRCNN with the FP list made whole
(`utils/synthetic.pointrcnn_fp3`), at the file's batch of 4, and the stages
are the backbone's SA levels, its FP modules, the point head, the proposal
layer, ROI pooling, the ROI SA stack and the final NMS. Then `torch.profiler` traces
three `predict` calls: device time per predict, device activities per
predict, the busy share (device time over the unprofiled wall time of one
predict) and the ten kernels with the most device time. Prints one line per
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

from ..ops import dispatch, sa_fused
from ..ops.pointnet2 import gather_operation
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


def stage_times(net, pts: torch.Tensor, reps: int) -> dict:
    """Median ms of each stage of `predict`, each on its own input."""
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


def pointrcnn_stage_times(net, pts: torch.Tensor, reps: int) -> dict:
    """Median ms of each stage of PointRCNN's `predict`, each on its own input."""
    from ..models.roi_heads.pointrcnn_head import pool_roi_points_ref
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


# per `MODEL.NAME`: what makes the config full width, the default batch, and
# the function that times the model's stages
PROFILES = {'PDMSSD': (lambda cfg: cfg, 8, stage_times),
            'PointRCNN': (synthetic.pointrcnn_fp3, 4, pointrcnn_stage_times)}


def trace(net, pts: torch.Tensor, n: int = 3) -> dict:
    """torch.profiler over `n` predicts: device time and activities per predict."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    net.predict({'points': pts})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            net.predict({'points': pts})
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
                             'ms_per_predict': us / 1e3 / n} for k, c, us in rows[:10]]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--cfg_file', default=CFG)
    ap.add_argument('--batch', type=int, default=None,
                    help='default: 8 for the flagship, 4 for PointRCNN')
    ap.add_argument('--points', type=int, default=16384)
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
    if cfg.MODEL.NAME not in PROFILES:
        raise SystemExit(f'no stage timing for {cfg.MODEL.NAME}')
    full_width, batch, time_stages = PROFILES[cfg.MODEL.NAME]
    cfg = full_width(cfg)
    if args.batch is None:
        args.batch = batch
    net = synthetic.random_model(cfg, 'cuda', seed=7)
    pts = torch.from_numpy(synthetic.kitti_points(args.batch, args.points, 5)).cuda()
    with torch.inference_mode():
        stages = time_stages(net, pts, args.reps)
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        net.predict({'points': pts})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = statistics.median(walls) * 1e3
    prof = trace(net, pts)
    prof['busy_share'] = prof['device_ms_per_predict'] / wall_ms
    for k, v in stages.items():
        print(f'{k:26s} {v:9.3f} ms')
    print(f'predict wall {wall_ms:.3f} ms; device {prof["device_ms_per_predict"]:.3f} ms per '
          f'predict ({prof["device_activities_per_predict"]:.0f} activities), busy '
          f'{prof["busy_share"]:.3f}; B={args.batch} N={args.points}; {card}')
    for r in prof['top_kernels']:
        print(f'  {r["ms_per_predict"]:8.3f} ms  x{r["calls_per_predict"]:<6g} {r["name"]}')
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({'card': card, 'cfg_file': args.cfg_file, 'batch': args.batch,
                               'points': args.points, 'reps': args.reps, 'stages_ms': stages,
                               'predict_wall_ms': wall_ms, 'profile': prof}, indent=1))


if __name__ == '__main__':
    main()
