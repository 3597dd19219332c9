"""Where the time of one training step of a PDM-SSD config goes, on one GPU.

    python3 -m pdm_ssd_torch.tools.profile_train [--cfg_file CFG] [--batch 8]
        [--points 16384] [--boxes 8] [--reps 5] [--out build/profile_train.json]

Builds the config (default `configs/kitti_models/pdm_ssd_point.yaml`; also
`pdm_ssd.yaml`, `pdm_ssd_aux.yaml`), unmodified, with seeded random weights,
float32 with TF32 off, and trains on one seeded synthetic batch. After
warm-up steps it times whole steps of `make_train_step` on the host clock
(median of `--reps`), then repeats the step's parts by hand with a CUDA event
between them: each forward stage (for `GridPointBackbone` its pillarize and
each level apart), targets and losses, backward, gradient clip, optimizer
update (median of `--reps`). Then `torch.profiler` traces two steps: device
time per step, the busy share (device time over the unprofiled wall time of
a step), the twelve kernels with the most device time and the time of
cuDNN's FFT route. It also reports the launches of the port's own kernels in
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

from ..models.backbones_3d.grid_point_backbone import GridPointBackbone
from ..ops import fps, group
from ..runtime.trainer import create_train_state, make_train_step
from .profile_predict import is_fft_route
from ..utils import synthetic
from ..utils.config import cfg_from_yaml_file

CFG = 'configs/kitti_models/pdm_ssd_point.yaml'
KERNELS = {'farthest_point_sample': fps.farthest_point_sample_cuda,
           'window_select': group.window_select_cuda,
           'gather_rows': group.gather_rows_cuda,
           'scatter_add_rows': group.scatter_add_rows_cuda}


def forward_parts(net) -> list:
    """(name, batch -> batch) of each stage of the forward, in order."""
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


def step_in_parts(net, optimizer, batch: dict) -> dict:
    """One training step with a CUDA event after each part: ms per part."""
    marks = [('start', torch.cuda.Event(enable_timing=True))]

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    net.train()
    optimizer.zero_grad()
    marks[0][1].record()
    out = dict(batch)
    stages = forward_parts(net)
    for name, stage in stages:
        out = stage(out)
        mark(name)
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
    ap.add_argument('--cfg_file', default=CFG)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--points', type=int, default=16384)
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
    cfg = cfg_from_yaml_file(args.cfg_file)
    net = synthetic.random_model(cfg, 'cuda', seed=7)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             synthetic.kitti_batch(args.batch, args.points, args.boxes, seed=5).items()}
    optimizer, _ = create_train_state(net, cfg.OPTIMIZATION, total_iters_each_epoch=100,
                                      total_epochs=1)
    train_step = make_train_step(net, optimizer)
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
    runs = [step_in_parts(net, optimizer, batch) for _ in range(args.reps)]
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
