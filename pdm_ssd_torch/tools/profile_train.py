"""Where the time of one training step of a config goes, on one GPU.

    python3 -m pdm_ssd_torch.tools.profile_train [--cfg_file CFG] [--batch 8]
        [--points 16384] [--boxes 8] [--reps 5] [--out build/profile_train.json]

Builds the config (default `configs/kitti_models/pdm_ssd_point.yaml`; also
`pdm_ssd.yaml`, `pdm_ssd_aux.yaml`, `centerpoint_pillar.yaml`,
`pillarnet.yaml`, `dsvt.yaml`, `transfusion.yaml`, and the voxel models `second_sparse.yaml`, `second.yaml`,
`second_focal.yaml`, `voxelnext.yaml` and `pointpillar.yaml`, whose batch
is seeded LiDAR-like clouds of 50000 points unless `--points` says
otherwise, voxelized on the card; the two-stage `pointrcnn.yaml`,
`pv_rcnn.yaml`, `pv_rcnn_sparse.yaml`, `voxel_rcnn.yaml` and
`voxel_rcnn_sparse.yaml`, the last four at `--points 16384` as their data
processor samples; `caddn`, CaDDN at its published widths
(`utils/synthetic.caddn_kitti`, which no file holds) on
`utils/synthetic.caddn_batch`'s 375 x 1242 images with their depth maps
from `--points` points a cloud and 2D boxes, `--batch 2`), unmodified,
with seeded random weights,
float32 with TF32 off, and trains on one seeded synthetic batch. After warm-up steps it
times whole steps of `make_train_step` on the host clock (median of
`--reps`), then repeats the step's parts by hand with a CUDA event between
them: a voxel model's map build (`get_host_prepare(..., training=True)`),
each forward stage (for `GridPointBackbone` its pillarize and each level
apart, for a voxel model each slot of `Detector3D`, for CaDDN its image
backbone with the depth head and frustum, the frustum-to-voxel sample, the
BEV backbone and the head, for a two-stage model
its first stage's slots, the decode of its boxes, the keypoints and point
head where it has them, and the ROI head with its proposals and targets),
TransFusion's assignment (the matching cost and the host LAP) apart, targets
and losses,
backward, gradient clip, optimizer update (median of `--reps`). Then
`torch.profiler` traces two steps: device time per step, the busy share
(device time over the unprofiled wall time of a step), the twelve kernels
with the most device time and the time of cuDNN's FFT route. It also reports the launches of the port's own kernels in
one step and the peak of allocated device memory. Prints one line per part and
writes everything, with the card's name and power limit, as JSON to
`--out`. Must be run from the repository root.
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
from ..models.backbones_3d.grid_point_backbone import GridPointBackbone
from ..models.detectors.caddn import CaDDN
from ..models.detectors.detector3d import Detector3D
from ..models.detectors.point_rcnn import PointRCNN
from ..models.detectors.pv_rcnn import PVRCNN
from ..models.dense_heads.transfusion_head import TransFusionHead
from ..ops import ball_query, fps, group, sparse_conv
from ..runtime.trainer import create_train_state, make_train_step
from .profile_predict import is_fft_route
from ..utils import synthetic

CFG = 'configs/kitti_models/pdm_ssd_point.yaml'
KERNELS = {'farthest_point_sample': fps.farthest_point_sample_cuda,
           'window_select': group.window_select_cuda,
           'gather_rows': group.gather_rows_cuda,
           'scatter_add_rows': group.scatter_add_rows_cuda,
           'ball_query': ball_query.ball_query_cuda,
           'sparse_conv': sparse_conv.sparse_conv_cuda,
           'sparse_conv_wgrad': sparse_conv.sparse_conv_wgrad_cuda}
# points per cloud of a voxel model's batch (`chip_smoke.py`'s SECOND clouds)
VOXEL_POINTS = 50000


def _decode(head, points: bool):
    """The stage that decodes the first stage's boxes into a batch's
    'batch_cls_preds' and 'batch_box_preds'."""
    def decode(b):
        cls, box = (head.generate_predicted_boxes(b['point_coords'], b['point_cls_preds'],
                                                  b['point_box_preds']) if points
                    else head.generate_predicted_boxes(b))
        return {**b, 'batch_cls_preds': cls, 'batch_box_preds': box}
    return decode


def forward_parts(net) -> list:
    """(name, batch -> batch) of each stage of the forward, in order."""
    if isinstance(net, CaDDN):
        def image(b):
            logits, frustum = net.image_features(b['camera_imgs'])
            return {**b, 'depth_logits': logits, 'frustum': frustum}

        def sample(b):
            return {**b, 'spatial_features': net.frustum_to_bev(b['frustum'], b),
                    'spatial_features_stride': 1}
        return [('image_backbone_depth_head', image), ('frustum_to_voxel', sample),
                ('backbone_2d', net.backbone_2d), ('dense_head', net.dense_head)]
    if isinstance(net, Detector3D):
        return [(slot, getattr(net, name)) for slot, name in net.slots.items()] + [
            ('dense_head', net.dense_head)]
    if isinstance(net, PVRCNN):             # and Voxel R-CNN
        parts = [(name, getattr(net, name)) for name in
                 ('vfe', 'backbone_3d', 'backbone_2d', 'dense_head')]
        parts.append(('decode', _decode(net.dense_head, False)))
        return parts + [(name, getattr(net, name)) for name in ('pfe', 'point_head', 'roi_head')
                        if getattr(net, name) is not None]
    if isinstance(net, PointRCNN):
        return [('backbone_3d', net.backbone_3d), ('point_head', net.point_head),
                ('decode', _decode(net.point_head, True)), ('roi_head', net.roi_head)]
    bb = net.backbone_3d
    if isinstance(bb, GridPointBackbone):
        parts = [('pillarize', lambda b: {**b, 'bev_nchw': bb.pillarize(b)})]
        for lvl in range(len(bb.layer_nums)):
            def level(b, lvl=lvl):
                x = bb.level(lvl, b['bev_nchw'])
                return {**b, 'bev_nchw': x, 'spatial_features': x.permute(0, 2, 3, 1)}
            parts.append((f'lvl{lvl}', level))
    else:
        parts = [('backbone_3d', bb)]
    return parts + [(name, getattr(net, name)) for name in
                    ('point_head', 'pdm_neck', 'backbone_2d', 'dense_head')
                    if getattr(net, name) is not None]


def step_in_parts(net, optimizer, batch: dict, prepare=None) -> dict:
    """One training step with a CUDA event after each part: ms per part.
    `prepare` (a voxel model's training map build) is the first part."""
    marks = [('start', torch.cuda.Event(enable_timing=True))]

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    net.train()
    optimizer.zero_grad()
    marks[0][1].record()
    if prepare is not None:
        with torch.no_grad():
            batch = prepare(batch)
        mark('map_build')
    out = dict(batch)
    stages = forward_parts(net)
    for name, stage in stages:
        out = stage(out)
        mark(name)
    head = getattr(net, 'dense_head', None)
    if isinstance(head, TransFusionHead):
        targets = head.assign_targets(out)
        mark('assign_lap')
        loss, _ = head.get_loss(out, targets)
    else:
        loss, _ = net.get_training_loss(out)
    mark('targets_and_losses')
    loss.backward()
    mark('backward')
    optimizer.clip_gradients()
    mark('clip')
    # `step` clips again: the gradients' norm is already below the clip, so
    # the second pass scales by one
    optimizer.step()
    mark('clip_and_update')
    torch.cuda.synchronize()
    parts = {name: marks[i][1].elapsed_time(ev) for i, (name, ev) in enumerate(marks[1:])}
    parts['forward'] = sum(parts[name] for name, _ in stages)
    return parts


def trace(train_step, batch: dict, n: int = 2) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            train_step(batch)
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    if not rows:
        raise SystemExit('torch.profiler recorded no device activity')
    rows.sort(key=lambda r: -r[2])
    return {'device_ms_per_step': sum(r[2] for r in rows) / 1e3 / n,
            'device_activities_per_step': sum(r[1] for r in rows) / n,
            'top_kernels': [{'name': k[:120], 'calls_per_step': c / n,
                             'ms_per_step': us / 1e3 / n} for k, c, us in rows[:12]],
            'fft_route_ms_per_step': sum(us for k, _, us in rows if is_fft_route(k)) / 1e3 / n}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--cfg_file', default=CFG, help='a config file, or caddn')
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--points', type=int, default=None,
                    help='points per cloud (16384; a voxel model 50000)')
    ap.add_argument('--boxes', type=int, default=8)
    ap.add_argument('--reps', type=int, default=5)
    ap.add_argument('--out', default='build/profile_train.json')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader', '-i', '0'],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = synthetic.load_cfg(args.cfg_file)
    net = synthetic.random_model(cfg, 'cuda', seed=7)
    prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG, training=True)
    if cfg.MODEL.NAME == 'CaDDN':
        args.points = args.points or 16384
        batch = synthetic.caddn_batch(args.batch, args.points, cfg, seed=5, M=args.boxes,
                                      device='cuda')
    elif not synthetic.voxelizes(cfg):
        args.points = args.points or 16384
        batch = {k: torch.from_numpy(v).cuda() for k, v in
                 synthetic.kitti_batch(args.batch, args.points, args.boxes, seed=5).items()}
    else:
        args.points = args.points or VOXEL_POINTS
        batch = synthetic.voxel_train_batch(args.batch, args.points, cfg, args.boxes, seed=5,
                                            device='cuda')
    optimizer, _ = create_train_state(net, cfg.OPTIMIZATION, total_iters_each_epoch=100,
                                      total_epochs=1)
    train_step = make_train_step(net, optimizer, prepare)
    for _ in range(2):
        train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in KERNELS.values():
        fn.launches = 0
    train_step(batch)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        train_step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = statistics.median(walls) * 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    runs = [step_in_parts(net, optimizer, batch, prepare) for _ in range(args.reps)]
    parts = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    prof = trace(train_step, batch)
    prof['busy_share'] = prof['device_ms_per_step'] / wall_ms
    for k, v in parts.items():
        print(f'{k:20s} {v:9.3f} ms')
    print(f'train step wall {wall_ms:.3f} ms; device {prof["device_ms_per_step"]:.3f} ms per step '
          f'({prof["device_activities_per_step"]:.0f} activities), busy {prof["busy_share"]:.3f}; '
          f'peak allocated {peak_gib:.3f} GiB; launches per step {launches}; '
          f'B={args.batch} N={args.points} boxes={args.boxes}; {card}')
    for r in prof['top_kernels']:
        print(f'  {r["ms_per_step"]:8.3f} ms  x{r["calls_per_step"]:<6g} {r["name"]}')
    print(f'FFT-route kernels (cuDNN): {prof["fft_route_ms_per_step"]:.3f} ms per step')
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({'card': card, 'cfg_file': args.cfg_file, 'batch': args.batch,
                               'points': args.points,
                               'boxes': args.boxes, 'reps': args.reps, 'parts_ms': parts,
                               'step_wall_ms': wall_ms, 'peak_allocated_gib': peak_gib,
                               'kernel_launches_per_step': launches, 'profile': prof}, indent=1))


if __name__ == '__main__':
    main()
