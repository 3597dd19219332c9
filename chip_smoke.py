"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Phases (each prints one line or more; any failure ends the run with a
non-zero exit):

1. device check: CUDA must be available; prints the card's name and
   `nvidia-smi` name and power limit;
2. builds the CUDA kernels from `pdm_ssd_torch/csrc/` (one `nvcc` per source,
   side by side);
3. FPS kernel against the plain PyTorch FPS on the card, exact index
   equality, at the flagship shape (8, 16384) -> 4096, on a tie-heavy cloud
   (duplicated grid points and a zero-padded tail) and at an odd N; times
   both (median of 5, CUDA events);
4. the flagship (`configs/kitti_models/pdm_ssd_point.yaml`, seeded random
   weights and BatchNorm statistics) at B=2, N=4096: forward on CUDA against
   the same model on the CPU, TF32 off;
5. the unmodified flagship's `predict` at B=8, N=16384: output shapes,
   finite values, kernel launches counted in that run, and frames/s (median
   of 5 timed runs after warm-up);
6. the grouping kernels (`window_select`, `gather_rows`, `scatter_add_rows`)
   against their plain versions on the card, at the shapes of the flagship's
   three SA levels (B=8) and at one ragged shape (odd M, 37 channels of
   which a slice is read, three radii, cap 20, indices out of range, empty
   balls, centers out of range): selection and gather exact, scatter-add
   within the rounding of float32 sums in any order; times kernel, plain
   version and the one PyTorch call that computes the same function
   (median of 5, CUDA events), and reckons each kernel's bound from the bytes
   it must move;
7. the flagship's training loss and every parameter's gradient at B=2,
   N=4096 on CUDA against the CPU, TF32 off;
8. five training steps of the unmodified flagship at B=8, N=16384 with 8
   boxes per cloud through `make_train_step`: finite losses, the last below
   the first, parameters changed, the kernels' launches per step, ms per
   step and the peak of allocated device memory.

The line before the last is the card's name and power limit; before it, one
JSON line describing each kernel. The last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CFG = 'configs/kitti_models/pdm_ssd_point.yaml'
# forward on CUDA vs CPU: float32 sums in another order (GEMM, cuDNN) and
# atomic adds in the PDM scatter; the measured difference on an H100 is
# about 3e-6 of the output scale, the bound leaves a wide margin
FWD_RTOL = 1e-3
# training loss on CUDA vs CPU: the same sources of difference
LOSS_RTOL = 1e-3
# every parameter's gradient on CUDA vs CPU, relative L2 per tensor: the
# same sources, plus BatchNorm on batch statistics, whose division by a
# channel's own deviation and the cancelling sums behind a bias's gradient
# enlarge float32 rounding (the CPU tests measure up to 8e-3 between the
# port's float32 and float64 gradients on a small cloud); measured on an H100:
# worst 2.3e-2, at a BatchNorm bias of SA level 2
GRAD_RTOL = 6e-2
GRAD_COSINE = 0.999
# published peaks of one H100 SXM: memory rate and float32 rate outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# launches of one full-width training step and of one predict
TRAIN_LAUNCHES = {'farthest_point_sample': 1, 'window_select': 3, 'gather_rows': 6,
                  'scatter_add_rows': 4}
PREDICT_LAUNCHES = {'farthest_point_sample': 1, 'window_select': 3, 'gather_rows': 6,
                    'scatter_add_rows': 0}


def log(phase: str, msg: str) -> None:
    print(f'[{phase}] {msg}', flush=True)


def device_check() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit('[1 device] FAILED: torch.cuda.is_available() is False')
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader', '-i', '0'],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log('1 device', f'{name}; nvidia-smi: {smi}; torch {torch.__version__} '
        f'cuda {torch.version.cuda}; devices {torch.cuda.device_count()}')
    return name, smi


def median_ms(fn, reps: int) -> float:
    fn()                                        # warm-up
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


def tie_heavy_xyz(B: int, N: int, seed: int) -> np.ndarray:
    """Grid-rounded points padded with random duplicates, shuffled, then a
    tail of zero rows: many exact distance ties."""
    rng = np.random.RandomState(seed)
    out = np.zeros((B, N, 3), np.float32)
    n_unique, n_dup = N // 3, (3 * N) // 4
    for b in range(B):
        base = np.round(rng.uniform(0, 8, (n_unique, 3))) * 2.0
        cloud = np.concatenate([base, base[rng.randint(0, n_unique, n_dup - n_unique)]])
        rng.shuffle(cloud)
        out[b, :n_dup] = cloud
    return out


def fps_phase(fps_mod, plain, kitti_points) -> dict:
    cases = [('flagship', torch.from_numpy(kitti_points(8, 16384, 1)[..., :3].copy()), 4096),
             ('tie-heavy', torch.from_numpy(tie_heavy_xyz(8, 16384, 2)), 4096),
             ('odd N', torch.from_numpy(kitti_points(3, 10007, 3)[..., :3].copy()), 2000)]
    max_err = 0
    for name, xyz, npoint in cases:
        x = xyz.cuda().contiguous()
        got = fps_mod.farthest_point_sample_cuda(x, npoint)
        torch.cuda.synchronize()
        want = plain.farthest_point_sample(x, npoint)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        if err != 0:
            raise SystemExit(f'[3 fps] FAILED {name}: {int((got != want).sum())} indices differ')
        log('3 fps', f'{name} {tuple(xyz.shape)} -> {npoint}: kernel == plain (exact)')
    x = cases[0][1].cuda().contiguous()
    ms = median_ms(lambda: fps_mod.farthest_point_sample_cuda(x, 4096), 5)
    plain_ms = median_ms(lambda: plain.farthest_point_sample(x, 4096), 5)
    # bound: the card-wide least time. Bytes: the cloud read once, the
    # indices written once. Operations: every step updates every point's
    # minimum (3 subtractions, 3 products, 2 sums, a minimum and a compare)
    B, N, npoint = 8, 16384, 4096
    t_bytes = (B * N * 12 + B * npoint * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = B * N * (npoint - 1) * 10 / FP32_FLOP_PER_S * 1e3
    return {'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations', 'library_ms': None}


def flatten(out: dict) -> dict:
    flat = {}
    for k, v in out.items():
        if isinstance(v, torch.Tensor):
            flat[k] = v
        elif isinstance(v, list):
            for i, x in enumerate(v):
                if isinstance(x, torch.Tensor):
                    flat[f'{k}[{i}]'] = x
                elif isinstance(x, dict):
                    flat.update({f'{k}[{i}].{n}': t for n, t in x.items()})
    return flat


def cuda_vs_cpu_phase(cfg, dispatch, synthetic) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pts = torch.from_numpy(synthetic.kitti_points(2, 4096, 4))
    want_idx = dispatch.farthest_point_sample(pts[..., :3].contiguous(), 4096)
    got_idx = dispatch.farthest_point_sample(pts[..., :3].contiguous().cuda(), 4096).cpu()
    if not torch.equal(want_idx, got_idx):
        raise SystemExit('[4 cuda-vs-cpu] FAILED: FPS indices differ between CUDA and CPU')
    cpu_net = synthetic.random_model(cfg, 'cpu')
    gpu_net = synthetic.random_model(cfg, 'cuda')
    gpu_net.load_state_dict(cpu_net.state_dict())
    with torch.inference_mode():
        want = flatten(cpu_net({'points': pts}))
        got = flatten(gpu_net({'points': pts.cuda()}))
    worst = 0.0
    for k, w in want.items():
        g = got[k].cpu()
        if g.dtype.is_floating_point:
            scale = max(float(w.abs().max()), 1e-6)
            rel = float((g - w).abs().max()) / scale
            worst = max(worst, rel)
            if not rel <= FWD_RTOL:
                raise SystemExit(f'[4 cuda-vs-cpu] FAILED {k}: max |diff| / max |cpu| = {rel:.3e}')
        elif not torch.equal(g, w):
            raise SystemExit(f'[4 cuda-vs-cpu] FAILED {k}: integer outputs differ')
    log('4 cuda-vs-cpu', f'B=2 N=4096 forward: {len(want)} outputs agree, worst '
        f'max|diff|/max|cpu| = {worst:.3e} (bound {FWD_RTOL:g}); FPS indices equal')


def reset_launches(wrappers: dict) -> None:
    for fn in wrappers.values():
        fn.launches = 0


def read_launches(wrappers: dict) -> dict:
    return {name: fn.launches for name, fn in wrappers.items()}


def predict_phase(cfg, wrappers, synthetic, card: str) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = synthetic.random_model(cfg, 'cuda', seed=7)
    B, N = 8, 16384
    pts = torch.from_numpy(synthetic.kitti_points(B, N, 5)).cuda()
    reset_launches(wrappers)
    det = net.predict({'points': pts})
    torch.cuda.synchronize()
    launches = read_launches(wrappers)
    want = {'pred_boxes': (B, 100, 7), 'pred_scores': (B, 100), 'pred_labels': (B, 100),
            'pred_mask': (B, 100)}
    for k, shape in want.items():
        if tuple(det[k].shape) != shape:
            raise SystemExit(f'[5 predict] FAILED {k}: shape {tuple(det[k].shape)} != {shape}')
        if det[k].dtype.is_floating_point and not bool(torch.isfinite(det[k]).all()):
            raise SystemExit(f'[5 predict] FAILED {k}: non-finite values')
    if launches != PREDICT_LAUNCHES:
        raise SystemExit(f'[5 predict] FAILED: kernel launches {launches}, expected '
                         f'{PREDICT_LAUNCHES}')
    for _ in range(3):
        net.predict({'points': pts})
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        net.predict({'points': pts})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log('5 predict', f'B={B} N={N}: shapes ok, finite, {int(det["pred_mask"].sum())} kept boxes, '
        f'launches {launches}; median {med * 1e3:.3f} ms/batch = {B / med:.2f} frames/s '
        f'(5 runs) on {card}')
    return launches


def sa_level_specs(cfg) -> list:
    """(name, N, M, radii, nsamples, payload width, branch slices, cap) of the
    flagship's SA levels as `SAGroupMLP` calls the grouping: level 1 groups
    the raw intensity (every branch reads the one channel), later levels a
    payload of the branches' first-layer widths side by side."""
    sa = cfg.MODEL.BACKBONE_3D.SA_CONFIG
    specs, n_in = [], 16384
    for k, m in enumerate(sa.NPOINTS):
        h1 = [int(mlp[0]) for mlp in sa.MLPS[k]]
        if k == 0:
            width, slices = 1, [(0, 1)] * len(h1)
        else:
            offs = np.concatenate([[0], np.cumsum(h1)]).tolist()
            width, slices = offs[-1], [(offs[i], offs[i + 1]) for i in range(len(h1))]
        specs.append((f'SA level {k + 1}', n_in, m, list(sa.RADIUS[k]), list(sa.NSAMPLE[k]),
                      width, slices, int(sa.get('BUCKET_CAP', 32))))
        n_in = m
    return specs


def group_case(name, xyz, new_xyz, radii, nsamples, width, slices, cap, pc_range, seed,
               group, sa_fused, spoil_idx=False, reps=5) -> dict:
    """One shape through the three grouping kernels and their plain
    versions. Returns per-kernel dicts of err, ms, plain_ms, library_ms,
    bound_ms summed over the shape's launches (one selection, one gather and
    one scatter-add per branch)."""
    dev = xyz.device
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    cs = float(max(radii))
    gw = sa_fused.grid_dims(pc_range, cs)
    pc_min = (float(pc_range[0]) - cs, float(pc_range[1]) - cs)
    table = sa_fused.build_slot_table(xyz, cs, gw, cap, pc_min)
    cells = sa_fused.cell_ids(new_xyz, cs, gw, pc_min).to(torch.int32)
    sel_args = (table, cells, gw[0], xyz, new_xyz, radii, nsamples)
    got = group.window_select_cuda(*sel_args)
    torch.cuda.synchronize()
    want = group.window_select_plain(*sel_args)
    torch.cuda.synchronize()
    empty = 0
    for bi, ((g_rel, g_idx, g_hit), (w_rel, w_idx, w_hit)) in enumerate(zip(got, want)):
        if not (torch.equal(g_hit, w_hit) and torch.equal(g_idx.long(), w_idx)
                and torch.equal(g_rel, w_rel)):
            raise SystemExit(f'[6 group] FAILED {name} window_select branch {bi}: '
                             f'{int((g_idx.long() != w_idx).sum())} indices, '
                             f'{int((g_hit != w_hit).sum())} hits, '
                             f'{int((g_rel != w_rel).sum())} rel values differ')
        empty += int((~g_hit).sum())
    res = {'window_select': {
        'err': 0.0,
        'ms': median_ms(lambda: group.window_select_cuda(*sel_args), reps),
        'plain_ms': median_ms(lambda: group.window_select_plain(*sel_args), reps),
        'library_ms': None,
        'bytes': (table.numel() * 4 + cells.numel() * 4 + xyz.numel() * 4 + new_xyz.numel() * 4
                  + sum(B * M * K * 16 + B * M for K in nsamples))}}

    gen = torch.Generator(device='cpu').manual_seed(seed)
    payload = torch.randn((B, N, width), generator=gen).to(dev)
    gather = {'err': 0.0, 'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0, 'bytes': 0}
    scatter = {'err': 0.0, 'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0, 'bytes': 0}
    for (rel, idx, hit), (s0, s1), K in zip(got, slices, nsamples):
        C = s1 - s0
        rows = torch.where(hit[..., None], idx, -1).reshape(B, M * K)
        if spoil_idx:   # indices beyond both ends
            rows = rows.clone()
            rows[:, ::7] = N + 3
            rows[:, 3::11] = -5
        rows = rows.contiguous()
        feats = payload[..., s0:s1]
        out = group.gather_rows_cuda(feats, rows)
        torch.cuda.synchronize()
        want_rows = group.gather_rows_plain(feats, rows)
        if not torch.equal(out, want_rows):
            raise SystemExit(f'[6 group] FAILED {name} gather_rows C={C}: '
                             f'{int((out != want_rows).sum())} values differ')
        safe = rows.clamp(0, N - 1).long()[..., None].expand(-1, -1, C)
        gather['ms'] += median_ms(lambda: group.gather_rows_cuda(feats, rows), reps)
        gather['plain_ms'] += median_ms(lambda: group.gather_rows_plain(feats, rows), reps)
        gather['library_ms'] += median_ms(lambda: torch.gather(feats, 1, safe), reps)
        gather['bytes'] += B * N * C * 4 + rows.numel() * 4 + out.numel() * 4

        vals = torch.randn((B, M * K, C), generator=gen).to(dev)
        back = group.scatter_add_rows_cuda(vals, rows, N)
        torch.cuda.synchronize()
        plain_back = group.scatter_add_rows_plain(vals, rows, N)
        exact = group.scatter_add_rows_plain(vals.double().cpu(), rows.cpu(), N)
        mass = group.scatter_add_rows_plain(vals.double().abs().cpu(), rows.cpu(), N)
        count = group.scatter_add_rows_plain(torch.ones((B, M * K, 1), dtype=torch.float64),
                                             rows.cpu(), N)
        # each of a row's `count` float32 additions rounds by at most 2^-24 of
        # the partial sum, itself at most the sum of magnitudes; atomics add
        # in an order that changes from run to run
        tol = 2.0 ** -23 * count * mass + 1e-30
        for label, t in (('kernel', back), ('plain', plain_back)):
            over = (t.double().cpu() - exact).abs() > tol
            if bool(over.any()):
                raise SystemExit(f'[6 group] FAILED {name} scatter_add_rows C={C}: {label} '
                                 f'differs from the float64 sum beyond rounding in '
                                 f'{int(over.sum())} values')
        scatter['err'] = max(scatter['err'], float((back - plain_back).abs().max()))
        flat = torch.where((rows >= 0) & (rows < N),
                           rows.long() + torch.arange(B, device=dev)[:, None] * N, B * N)
        flat = flat.reshape(-1)
        v2 = vals.reshape(-1, C)
        scatter['ms'] += median_ms(lambda: group.scatter_add_rows_cuda(vals, rows, N), reps)
        scatter['plain_ms'] += median_ms(lambda: group.scatter_add_rows_plain(vals, rows, N), reps)
        scatter['library_ms'] += median_ms(
            lambda: torch.zeros((B * N + 1, C), device=dev).index_add_(0, flat, v2), reps)
        scatter['bytes'] += vals.numel() * 4 + rows.numel() * 4 + B * N * C * 4
    res['gather_rows'], res['scatter_add_rows'] = gather, scatter
    for r in res.values():
        r['bound_ms'] = r.pop('bytes') / HBM_BYTES_PER_S * 1e3
    log('6 group', f'{name} N={N} M={M} K={list(nsamples)} C={[b - a for a, b in slices]}: '
        f'selection and gather exact ({empty} empty balls), scatter-add within rounding '
        f'(kernel vs plain max |diff| {scatter["err"]:.2e}); ms kernel/plain/library/bound: '
        + '; '.join(f'{k} {r["ms"]:.3f}/{r["plain_ms"]:.3f}/'
                    + ('-' if r['library_ms'] is None else f'{r["library_ms"]:.3f}')
                    + f'/{r["bound_ms"]:.4f}' for k, r in res.items()))
    return res


def group_phase(cfg, fps_mod, group, sa_fused, synthetic) -> dict:
    """The grouping kernels at the flagship's SA levels and at a ragged shape.
    Returns per-kernel totals over the levels (the launches of one forward)."""
    pcr = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
    bev = (pcr[0], pcr[1], pcr[3], pcr[4])
    pts = torch.from_numpy(synthetic.kitti_points(8, 16384, 6)[..., :3].copy()).cuda()
    order = fps_mod.farthest_point_sample_cuda(pts, 4096).long()
    sampled = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))    # FPS order
    total = {}
    for k, (name, n_in, m, radii, nsamples, width, slices, cap) in enumerate(sa_level_specs(cfg)):
        xyz = (pts if k == 0 else sampled[:, :n_in]).contiguous()
        new_xyz = sampled[:, :m].contiguous()
        res = group_case(name, xyz, new_xyz, radii, nsamples, width, slices, cap, bev, 20 + k,
                         group, sa_fused)
        for kern, r in res.items():
            t = total.setdefault(kern, {'err': 0.0, 'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0,
                                        'library_ms': None if r['library_ms'] is None else 0.0})
            t['err'] = max(t['err'], r['err'])
            for key in ('ms', 'plain_ms', 'bound_ms'):
                t[key] += r[key]
            if r['library_ms'] is not None:
                t['library_ms'] += r['library_ms']
    # ragged: odd sizes, a slice of 37 channels that starts off a 16-byte
    # boundary, three radii, cap 20, points and centers outside the range
    rng = np.random.RandomState(9)
    xyz = np.stack([rng.uniform(-2, 74, (3, 3001)), rng.uniform(-43, 43, (3, 3001)),
                    rng.uniform(-3, 1, (3, 3001))], -1).astype(np.float32)
    xyz[:, :1500, :2] = xyz[:, :1500, :2] * 0.1 + 20.0             # a dense patch: full cells
    new_xyz = xyz[:, :333].copy()
    new_xyz[:, :7, 0] = 200.0                                      # centers out of range
    new_xyz[:, 7:15, 2] = 50.0                                     # in range, empty balls
    group_case('ragged', torch.from_numpy(xyz).cuda(), torch.from_numpy(new_xyz).cuda(),
               [0.5, 1.3, 0.9], [5, 70, 3], 37, [(3, 22), (0, 37), (36, 37)], 20, bev, 30,
               group, sa_fused, spoil_idx=True)
    return total


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def grads_cuda_vs_cpu_phase(cfg, synthetic) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = synthetic.kitti_batch(2, 4096, 8, seed=4)
    cpu_net = synthetic.random_model(cfg, 'cpu')
    gpu_net = synthetic.random_model(cfg, 'cuda')
    gpu_net.load_state_dict(cpu_net.state_dict())
    out = {}
    for key, net, dev in (('cpu', cpu_net, 'cpu'), ('cuda', gpu_net, 'cuda')):
        net.train()
        loss, tb = net.forward_with_loss(to_device(batch, dev))
        loss.backward()
        out[key] = (float(loss.detach()), {k: float(v.detach()) for k, v in tb.items()},
                    {k: p.grad.detach().double().cpu() for k, p in net.named_parameters()})
    (c_loss, c_tb, c_grads), (g_loss, g_tb, g_grads) = out['cpu'], out['cuda']
    if not (np.isfinite(g_loss) and abs(g_loss - c_loss) <= LOSS_RTOL * abs(c_loss)):
        raise SystemExit(f'[7 grads] FAILED: loss {g_loss} on CUDA vs {c_loss} on the CPU')
    for k, v in c_tb.items():
        if abs(g_tb[k] - v) > LOSS_RTOL * max(abs(v), 1.0):
            raise SystemExit(f'[7 grads] FAILED {k}: {g_tb[k]} on CUDA vs {v} on the CPU')
    worst, worst_name = 0.0, ''
    for k, c in c_grads.items():
        g = g_grads[k]
        if not bool(torch.isfinite(g).all()):
            raise SystemExit(f'[7 grads] FAILED {k}: non-finite gradient')
        norm = float(c.norm())
        rel = float((g - c).norm()) / norm if norm > 0 else float(g.norm())
        if rel > worst:
            worst, worst_name = rel, k
        cos = float((g * c).sum() / (g.norm() * c.norm())) if norm > 0 else 1.0
        if not (rel <= GRAD_RTOL and cos >= GRAD_COSINE):
            raise SystemExit(f'[7 grads] FAILED {k}: relative L2 error {rel:.3e} '
                             f'(bound {GRAD_RTOL:g}), cosine {cos:.6f} (bound {GRAD_COSINE})')
    log('7 grads', f'B=2 N=4096, 8 boxes: loss {g_loss:.6f} on CUDA vs {c_loss:.6f} on the CPU; '
        f'{len(c_grads)} gradients agree, worst relative L2 {worst:.3e} at {worst_name} '
        f'(bound {GRAD_RTOL:g}; cosine of every pair at least {GRAD_COSINE})')


def train_phase(cfg, wrappers, synthetic, card: str) -> dict:
    from pdm_ssd_torch.runtime.trainer import create_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, N, M, steps = 8, 16384, 8, 5
    net = synthetic.random_model(cfg, seed=7)          # no device named: the card
    batch = to_device(synthetic.kitti_batch(B, N, M, seed=5), 'cuda')
    optimizer, _ = create_train_state(net, cfg.OPTIMIZATION, total_iters_each_epoch=100,
                                      total_epochs=1)
    train_step = make_train_step(net, optimizer)
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(wrappers)
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics = train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics['loss']))
    launches = read_launches(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(losses)):
        raise SystemExit(f'[8 train] FAILED: losses {losses}')
    if not losses[-1] < losses[0]:
        raise SystemExit(f'[8 train] FAILED: the loss did not fall: {losses}')
    want = {k: v * steps for k, v in TRAIN_LAUNCHES.items()}
    if launches != want:
        raise SystemExit(f'[8 train] FAILED: kernel launches {launches}, expected {want}')
    changed = sum(not torch.equal(p.detach(), before[k]) for k, p in net.named_parameters())
    finite = all(bool(torch.isfinite(p).all()) for p in net.parameters())
    if not finite or changed < 0.9 * len(before):
        raise SystemExit(f'[8 train] FAILED: {changed} of {len(before)} parameter tensors '
                         f'changed, all finite: {finite}')
    med = statistics.median(times)
    log('8 train', f'B={B} N={N}, {M} boxes per cloud, {steps} steps: losses '
        + ' '.join(f'{x:.4f}' for x in losses)
        + f'; {changed} of {len(before)} parameter tensors changed; launches per step '
        f'{TRAIN_LAUNCHES}; median {med * 1e3:.3f} ms/step (first {times[0] * 1e3:.1f} ms); '
        f'peak allocated {peak:.3f} GiB on {card}')
    return launches


KERNEL_TABLE = (
    ('farthest_point_sample', 'pdm_ssd_torch/csrc/fps.cu', 'pdm_ssd_tpu/ops/pallas/fps.py:60'),
    ('window_select', 'pdm_ssd_torch/csrc/group.cu',
     'pdm_ssd_tpu/ops/pallas/retired/grid_query.py:239'),
    ('gather_rows', 'pdm_ssd_torch/csrc/group.cu',
     'pdm_ssd_tpu/ops/pallas/retired/onehot_gather.py:146'),
    ('scatter_add_rows', 'pdm_ssd_torch/csrc/group.cu',
     'pdm_ssd_tpu/ops/pallas/retired/onehot_gather.py:226'),
)


def main() -> None:
    name, smi = device_check()
    sys.path.insert(0, str(REPO))
    from pdm_ssd_torch.ops import dispatch, fps, group, kernels, sa_fused
    from pdm_ssd_torch.ops import pointnet2 as plain
    from pdm_ssd_torch.utils import synthetic
    from pdm_ssd_torch.utils.config import CfgNode, cfg_from_yaml_file

    t0 = time.perf_counter()
    libs = kernels.build()
    kernels.load()
    log('2 build', f'{", ".join(so.name for so in libs.values())} in '
        f'{time.perf_counter() - t0:.1f} s')
    for line in kernels.build_log.splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling entry' in line:
            print(f'    {line.strip()}')
    wrappers = {'farthest_point_sample': fps.farthest_point_sample_cuda,
                'window_select': group.window_select_cuda,
                'gather_rows': group.gather_rows_cuda,
                'scatter_add_rows': group.scatter_add_rows_cuda}

    stats = {'farthest_point_sample': fps_phase(fps, plain, synthetic.kitti_points)}
    fps_stats = stats['farthest_point_sample']
    log('3 fps', f'(8, 16384) -> 4096: kernel {fps_stats["ms"]:.3f} ms, plain torch '
        f'{fps_stats["plain_ms"]:.3f} ms (median of 5), bound {fps_stats["bound_ms"]:.4f} ms '
        f'by {fps_stats["bound_by"]} on {smi}')

    os.chdir(REPO)   # the config names its base config relative to the repo
    cfg = cfg_from_yaml_file(str(REPO / CFG), CfgNode())
    cuda_vs_cpu_phase(cfg, dispatch, synthetic)
    predict_launches = predict_phase(cfg, wrappers, synthetic, smi)
    for kern, r in group_phase(cfg, fps, group, sa_fused, synthetic).items():
        stats[kern] = {'max_abs_err': r['err'], 'ms': r['ms'], 'plain_ms': r['plain_ms'],
                       'bound_ms': r['bound_ms'], 'bound_by': 'bytes',
                       'library_ms': r['library_ms']}
    grads_cuda_vs_cpu_phase(cfg, synthetic)
    train_launches = train_phase(cfg, wrappers, synthetic, smi)

    # `launches` counts the five training steps of phase 8. The grouping
    # kernels' times, bounds and library times are sums over the three SA
    # levels (the launches of one forward, and of one backward for the
    # scatter-add); `max_abs_err` is kernel against plain version
    print(json.dumps({'kernels': [{
        'name': kern, 'route': 'cuda', 'source': source, 'replaces': replaces,
        'launches': train_launches[kern], 'launches_per_predict': predict_launches[kern],
        **stats[kern]} for kern, source, replaces in KERNEL_TABLE]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
