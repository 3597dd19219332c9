"""Device time of four kernels as a model call makes them, on one GPU: the
sparse conv over SECOND's 12 layers, the ball query over PointRCNN's three
backbone levels, and the flagship's in-ball selection and row scatter-add.

    python3 pdm_ssd_torch/tools/time_kernels.py [--tree DIR] [--out FILE]

Run it by path from the repository root. `--tree` names a checkout of this
repository whose `pdm_ssd_torch` is timed (default: the one this script lies
in), so two commits are compared in turns on one card: parent, change,
change, parent, each its own process. The inputs are the full-width ones of
`chip_smoke.py` phases 6, 9, 12 and 15: `second_sparse.yaml` as shipped at
B=4 on `synthetic.voxel_batch(4, 50000, seed=5)` with seeded weights,
`pointrcnn.yaml` with the FP list made whole at B=4 on
`synthetic.kitti_points(4, 16384, 5)`, and `pdm_ssd_point.yaml`'s three SA
levels at B=8 on `synthetic.kitti_points(8, 16384, 6)` with FPS centers.
Each sparse layer's call is the one its forward makes (with its map's plan
where the tree has plans; the plans' build is timed on its own), each ball
query the level's `dispatch.ball_query_level` (with the grid build where the
tree builds one), each selection one `group.window_select_cuda` call of an
SA level on its slot table (built outside the timed call), and the
scatter-add the 4 launches of a flagship train step's backward (levels 2
and 3, one a radius) on the indices that level's selection gives, an empty
ball's slots at -1, as `sa_fused.fused_query_group` passes them.
A reading is device time per call: a sleep kernel long enough to cover the
enqueue queued first, then n back-to-back calls between two CUDA events (a
run of at least 1 ms), median of 5 runs. Prints one JSON line, with the
card's name and power limit, and writes it to `--out`.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path


def device_ms(fn, runs: int = 5) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    host_ms = statistics.median(host) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 20_000_000 / start.elapsed_time(end)

    def run(n: int) -> float:
        # long enough to cover the enqueue of all n calls
        torch.cuda._sleep(int(cycles_per_ms * (1.0 + 3.0 * n * host_ms)))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    n = min(500, max(20, int(1.0 / max(run(20), 1e-4)) + 1))
    return statistics.median(run(n) for _ in range(runs))


def grouping_ms(cfg, synthetic) -> dict:
    """The flagship's selection per SA level and its train step's scatter-adds
    per level and radius, device ms per call."""
    import torch

    from pdm_ssd_torch.ops import fps, group, sa_fused
    sa = cfg.MODEL.BACKBONE_3D.SA_CONFIG
    cap = int(sa.get('BUCKET_CAP', 32))
    pcr = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
    pc_range = (pcr[0], pcr[1], pcr[3], pcr[4])
    pts = torch.from_numpy(synthetic.kitti_points(8, 16384, 6)[..., :3].copy()).cuda()
    order = fps.farthest_point_sample_cuda(pts, int(sa.NPOINTS[0])).long()
    sampled = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))    # FPS order
    gen = torch.Generator(device='cpu').manual_seed(20)
    select, scatter = {}, {}
    n_in = pts.shape[1]
    for k, m in enumerate(sa.NPOINTS):
        xyz = (pts if k == 0 else sampled[:, :n_in]).contiguous()
        new_xyz = sampled[:, :m].contiguous()
        radii, nsamples = list(sa.RADIUS[k]), list(sa.NSAMPLE[k])
        cs = float(max(radii))
        gw = sa_fused.grid_dims(pc_range, cs)
        pc_min = (float(pc_range[0]) - cs, float(pc_range[1]) - cs)
        table = sa_fused.build_slot_table(xyz, cs, gw, cap, pc_min)
        cells = sa_fused.cell_ids(new_xyz, cs, gw, pc_min).to(torch.int32)
        args = (table, cells, gw[0], xyz, new_xyz, radii, nsamples)
        select[f'sa{k + 1}'] = device_ms(lambda: group.window_select_cuda(*args))
        if k > 0:   # level 1 gathers raw input, which takes no gradient
            for (_, idx, hit), K, mlp in zip(group.window_select_cuda(*args), nsamples,
                                             sa.MLPS[k]):
                rows = torch.where(hit[..., None], idx, -1).reshape(idx.shape[0], -1)
                rows = rows.contiguous()
                vals = torch.randn((*rows.shape, int(mlp[0])), generator=gen).cuda()
                scatter[f'sa{k + 1}_k{K}'] = device_ms(
                    lambda: group.scatter_add_rows_cuda(vals, rows, n_in))
        n_in = m
    return {'window_select_ms': select, 'window_select_total_ms': sum(select.values()),
            'scatter_add_rows_ms': scatter,
            'scatter_add_rows_total_ms': sum(scatter.values())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--tree', default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    out_path = None if args.out is None else Path(args.out).resolve()
    sys.path.insert(0, str(tree))
    os.chdir(tree)                  # the configs name their base config relative to the repo
    import torch

    from pdm_ssd_torch.models import get_host_prepare
    from pdm_ssd_torch.models.backbones_3d.sparse_backbone import SparseConvBNReLU
    from pdm_ssd_torch.ops import dispatch
    from pdm_ssd_torch.utils import synthetic
    from pdm_ssd_torch.utils.config import cfg_from_yaml_file
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader',
                           '-i', '0'], capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {'tree': str(tree), 'card': card}

    cfg = cfg_from_yaml_file('configs/kitti_models/second_sparse.yaml')
    net = synthetic.open_score_gate(synthetic.random_model(cfg, 'cuda', seed=7))
    inputs = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG)(
        synthetic.voxel_batch(4, 50000, cfg, seed=5, device='cuda'))
    bb = net.backbone_3d
    calls = {}
    hooks = [m.register_forward_pre_hook(lambda mod, a, name=name: calls.setdefault(name, a))
             for name, m in bb.named_modules() if isinstance(m, SparseConvBNReLU)]
    with torch.inference_mode():
        bb(net.vfe(dict(inputs)))
        for h in hooks:
            h.remove()
        modules = dict(bb.named_modules())
        layers = {}
        plans = {}
        for name, a in calls.items():
            w = modules[name].kernel
            layers[name] = device_ms(lambda: dispatch.sparse_conv(a[0], a[1], w, *a[3:4]))
            if len(a) > 3:
                plans[id(a[3])] = (a[1], a[3].vin)
        out['sparse_conv_ms'] = layers
        out['sparse_conv_total_ms'] = sum(layers.values())
        if plans:
            from pdm_ssd_torch.ops.sparse_conv import sparse_conv_plan
            out['sparse_conv_plans_ms'] = device_ms(
                lambda: [sparse_conv_plan(nbr, vin) for nbr, vin in plans.values()])
        del net, inputs, calls, modules

        cfg = synthetic.pointrcnn_fp3(cfg_from_yaml_file('configs/kitti_models/pointrcnn.yaml'))
        net = synthetic.random_model(cfg, 'cuda', seed=7)
        bb = net.backbone_3d
        pts = torch.from_numpy(synthetic.kitti_points(4, 16384, 5)).cuda()
        n_fp, bb.n_fp = bb.n_fp, 0
        l_xyz = bb({'points': pts})['sa_xyz']
        bb.n_fp = n_fp
        levels = {}
        for k in range(len(bb.npoints)):
            sa = getattr(bb, f'sa_{k}')
            levels[f'sa{k + 1}'] = device_ms(lambda: dispatch.ball_query_level(
                sa.radii, sa.nsamples, l_xyz[k], l_xyz[k + 1]))
        out['ball_query_ms'] = levels
        out['ball_query_total_ms'] = sum(levels.values())
        del net, bb, l_xyz

        out.update(grouping_ms(cfg_from_yaml_file('configs/kitti_models/pdm_ssd_point.yaml'),
                               synthetic))
    line = json.dumps(out)
    print(line)
    if out_path is not None:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(line + '\n')


if __name__ == '__main__':
    main()
