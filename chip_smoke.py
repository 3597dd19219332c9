"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Phases (each prints one line or more; any failure ends the run with a
non-zero exit):

1. device check: CUDA must be available; prints the card's name and
   `nvidia-smi` name and power limit;
2. builds the CUDA kernels from `pdm_ssd_torch/csrc/` (one `nvcc` per source,
   side by side);
3. FPS kernel against the plain PyTorch FPS on the card, exact index
   equality, at the flagship shape (8, 16384) -> 4096, on a tie-heavy cloud
   (duplicated grid points and a zero-padded tail), at an odd N and at the
   three shapes of a PointRCNN predict ((4, 4096) -> 1024 in the backbone;
   400 clouds of 512 points -> 128, some of them 512 copies of the origin,
   and the 128 picked -> 32 in the ROI stack); times both (median of 5, CUDA
   events);
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
   balls, centers out of range): selection and gather exact (the plain
   emulation of the selection's compacted walk exact too), scatter-add
   within the rounding of float32 sums in any order; times kernel, plain
   version and the one PyTorch call that computes the same function (median
   of 5, CUDA events), and reckons each kernel's bound from the bytes it
   must move; prints per SA level and in total, from the plain emulations,
   the selection's occupied slots and walk steps per center against the
   ceil(9 * cap / 32) of a walk over the uncompacted window, and the
   scatter-add's rows, runs, sums sent and atomics;
7. the flagship's training loss and every parameter's gradient at B=2,
   N=4096 on CUDA against the CPU, TF32 off;
8. five training steps of the unmodified flagship at B=8, N=16384 with 8
   boxes per cloud through `make_train_step`: finite losses, the last below
   the first, parameters changed, the kernels' launches per step, ms per
   step and the peak of allocated device memory;
9. both ball-query kernel paths (`ops/ball_query.ball_query_plan`: the grid
   path walks a sorted cell grid built on the device, the walk path every
   point) against the plain version on the card, exact index equality, at the
   shapes PointRCNN gives it (`configs/kitti_models/pointrcnn.yaml`: the
   backbone's three SA levels at B=4, which the plan sends to the grid, the
   ROI head's two at 400 clouds, which it sends to the walk), with a mask, at
   a ragged shape (odd N and M, three radii, K = 5/70/3, centers far outside
   the cloud, duplicated points) and on clouds of 512 origins; at each shape
   the row gather by the selected indices, kernel against plain version,
   exact, of xyz and of features in the widths and layouts the model gathers
   (channel slices of the (B, N, 4) cloud and of the 5-channel pooled block,
   96, 256 and 128 channels); times both paths, the grid's build and walk
   apart, and the plain version over the backbone's levels, and on a denser
   cloud that fills the balls; the bound is the bytes or the distance tests
   in a 3x3 window of radius-sized cells, counted from the run's data, and
   the tests each path walks stand beside it (the grid's from the plain
   emulation of its walk, which must equal the plain version too);
10. PointRCNN with its FP list made whole (`synthetic.pointrcnn_fp3`) at B=2,
   N=4096, `NPOINTS` cut to [1024, 256, 64]: forward on CUDA against the CPU,
   TF32 off, the same number of proposals kept per cloud, the per-ROI
   outputs compared ROI by ROI after matching the proposals by box;
11. the same model's `predict` at full width, B=4, N=16384: shapes, finite
   values, kernel launches counted in that run (the ball query's by path: 3
   grid, 2 walk), frames/s and peak memory;
   then one `predict` of the file as shipped: shapes and finite values;
12. the sparse-conv kernel against its plain version and against a float64
   evaluation (each within float32 rounding of the sum of magnitudes), two
   runs bit-equal, rows without taps exactly 0, at the twelve layers of
   SECOND's ladder (`configs/kitti_models/second_sparse.yaml`, B=4, 40000
   voxel slots) with the maps, the layer inputs and the plans of a forward
   over the full-width synthetic batch, at the TPU microbench's shape (V =
   52224, C = 64, K = 27, its `make_maps`), at a ragged row count and with
   rows whose taps are all absent; per layer and in total the taps the plan
   makes the kernel compute over the taps present (at most 1.6 over the
   twelve layers, each weighted by Cin * Cout) and each plan's build time;
   times kernel, plain version and the gather + `torch.matmul` pair (median
   of 5, CUDA events); the bound is the bytes (table, map and weights read
   once, output written once) or the multiply-adds of the taps present in
   this run's maps, and the bytes the kernel really moves stand beside it;
13. the row gather's bfloat16 entry point at (52000, 96) with repeated
   indices, and its float32 use in the model, the reorder of (4, 40000, 4)
   voxel features by `sp_perm1`: exact; kernel, plain version,
   `torch.index_select`, bound;
14. the tiny SECOND (`synthetic.tiny_second_cfg`) on CUDA against the CPU:
   voxelizer and kernel maps equal exactly, head outputs within FWD_RTOL of
   scale, the same number of boxes kept per cloud, detections matched by box
   and label as phase 10 matches its ROIs;
15. SECOND's `predict` as shipped at B=4 on LiDAR-like clouds of 50000
   points: shapes, finite values, the active and dropped sites of every
   stage, kernel launches counted in that run (12 sparse convs, 1 row
   gather), ms per batch and frames/s with and without voxelizer and map
   build, peak memory;
16. the mini-KITTI set (64 frames, 3 classes) generated by the port's own
   generator under `build/chip_smoke_kitti/` (a checkout holds no `data/`),
   then the flagship as shipped (seeded weights and BatchNorm
   statistics, N=16384) through `runtime/eval_utils.eval_one_epoch` at B=8
   over the val split: kernel launches counted over the loop, one predict's
   worth a batch; recall and KITTI AP R40 finite, printed; frames/s of
   `predict` alone and of the loop with loading; then the same loop at B=2
   with `NUM_POINTS` 4096 over 8 frames on CUDA against the CPU: the same
   number of detections in every frame, matched by box and label as phase 10
   matches its ROIs;
17. `runtime/trainer.train_model` on the mini train split at B=8, full
   width, augmentation and GT sampling on: one epoch, a checkpoint, a resume
   into a fresh model and optimizer (epoch, the schedule's iteration, the
   optimizer's moments and the weights restored exactly), a second epoch,
   the rotation down to `max_ckpt_save_num=1`; finite losses and the
   kernels' launches over both epochs (the scatter-add's 4 a step); a model
   loaded from the last checkpoint predicts bit for bit what the trained one
   does (deterministic algorithms on for that comparison); then
   `eval_one_epoch` of that checkpoint, AP printed, no threshold;
18. `bench_torch.py` as a subprocess: exactly one JSON line with the four
   keys and a positive value, printed with the card's name and power limit;
19. the tiny `pdm_ssd.yaml` (`synthetic.tiny_grid_cfg`: pillarize,
   GridPointBackbone, the grid PDM neck, circle NMS) on CUDA against the
   CPU at B=2, N=4096, the heatmap bias at 0 (`synthetic.open_score_gate`):
   forward outputs within FWD_RTOL of scale, detections matched by box and
   label; `ops/iou3d.circle_nms` on the card equal to the CPU's, slot order
   and keep mask, on the same candidates (a lattice with ties and pairs at
   exactly the radius, and 800 boxes a cloud at B=8);
20. `pdm_ssd.yaml` as shipped, `predict` at B=8, N=16384, the heatmap bias
   at 0: shapes, finite values, no launch of any kernel of the port (counted,
   0 expected), frames/s, peak memory, then `torch.profiler`'s device time
   and busy share, every kernel of cuDNN's FFT route, and each convolution
   stage's peak memory beyond its input (the kernels of a stage above 1 GiB
   named);
21. five training steps of `pdm_ssd.yaml` at B=8, N=16384 (as phase 8): ms
   per step and peak memory, no launch;
22. and 23. phases 16 and 17 with `pdm_ssd.yaml` (the heatmap bias at 0 in
   the eval loop): the eval loop at B=8, the 2-epoch train loop with
   checkpoint, resume and bit-equal reload (no CUDA-vs-CPU eval pass: see
   `grid_family_phases`);
24. `pdm_ssd_large.yaml` as shipped, `predict` at B=4 on clouds of 163840
   points over its +-75.2 m range (`synthetic.large_scene_points`), the
   heatmap bias at 0: frames/s, peak memory, device time, busy share;
25. five training steps of `pdm_ssd_aux.yaml` (the flagship with the
   train-only PointHeadSimple) at B=8: 1 FPS, 3 selection, 6 gather and 4
   scatter-add launches a step, ms per step;
26. the flagship with TTA_FLIP ['y']: the tiny model on CUDA against the CPU
   (detections matched by box and label), then as shipped at B=8: twice a
   predict's launches, frames/s.

The line before the last is the card's name and power limit; before it, one
JSON line describing each kernel, with the launches of each path of phases 20
to 26 (`launches_<path>`). The last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import pickle
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
# launches of one full-width training step and of one predict; FPS's are
# also counted by path (the flagship's 8 clouds of 16384 points take a
# cluster per cloud)
NO_BALL_QUERY = {'ball query grid path': 0, 'ball query walk path': 0}
TRAIN_LAUNCHES = {'farthest_point_sample': 1, 'window_select': 3, 'gather_rows': 6,
                  'scatter_add_rows': 4, 'ball_query': 0, 'sparse_conv': 0,
                  'gather_rows_bf16': 0, 'fps cluster path': 1, 'fps block path': 0,
                  **NO_BALL_QUERY}
PREDICT_LAUNCHES = {'farthest_point_sample': 1, 'window_select': 3, 'gather_rows': 6,
                    'scatter_add_rows': 0, 'ball_query': 0, 'sparse_conv': 0,
                    'gather_rows_bf16': 0, 'fps cluster path': 1, 'fps block path': 0,
                    **NO_BALL_QUERY}
# one PointRCNN predict. FPS: backbone level 1 is 'random' without a generator
# (a prefix), level 2 runs FPS 4096 -> 1024, level 3 is its prefix; the ROI
# stack runs FPS 512 -> 128 and 128 -> 32, all three on the block path (clouds
# under 8192 points; 400 clouds). Ball query: one launch per SA level,
# 3 in the backbone on the grid path (clouds of 16384, 4096 and 1024 points)
# and 2 in the ROI stack on the walk path (512 and 128). Row gather: xyz and features per
# radius, 3 levels x 2 radii and 2 levels x 1 radius.
POINTRCNN_CFG = 'configs/kitti_models/pointrcnn.yaml'
POINTRCNN_PREDICT_LAUNCHES = {'farthest_point_sample': 3, 'window_select': 0, 'gather_rows': 16,
                              'scatter_add_rows': 0, 'ball_query': 5, 'sparse_conv': 0,
                              'gather_rows_bf16': 0, 'fps cluster path': 0,
                              'fps block path': 3, 'ball query grid path': 3,
                              'ball query walk path': 2}
# one SECOND predict: the reorder of the voxel features into slot order, then
# conv_input, conv1, three stages of one strided and two submanifold convs,
# conv_out
SECOND_CFG = 'configs/kitti_models/second_sparse.yaml'
SECOND_PREDICT_LAUNCHES = {'farthest_point_sample': 0, 'window_select': 0, 'gather_rows': 1,
                           'scatter_add_rows': 0, 'ball_query': 0, 'sparse_conv': 12,
                           'gather_rows_bf16': 0, 'fps cluster path': 0, 'fps block path': 0,
                           **NO_BALL_QUERY}
SECOND_POINTS = 50000
# the grid family (`pdm_ssd.yaml`, `pdm_ssd_large.yaml`) launches none of the
# port's kernels: pillarize is `index_add_`, the rest cuDNN convolutions and
# plain torch; the aux variant's train step launches the flagship's
GRID_CFG = 'configs/kitti_models/pdm_ssd.yaml'
LARGE_CFG = 'configs/kitti_models/pdm_ssd_large.yaml'
AUX_CFG = 'configs/kitti_models/pdm_ssd_aux.yaml'
NO_LAUNCHES = {k: 0 for k in PREDICT_LAUNCHES}
# a predict with TTA_FLIP ['y'] runs the forward twice
TTA_PREDICT_LAUNCHES = {k: 2 * v for k, v in PREDICT_LAUNCHES.items()}
# share of a ladder stage's sites that may fall to its capacity, and the
# least active input voxels per cloud of 40000 slots
SECOND_MAX_DROP = 0.01
SECOND_MIN_VOXELS = 30000


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
    """One call between two events after a synchronize, median over `reps`:
    the device idles while the call's Python runs, so the reading is host
    and device time together (the plain versions' and the `call_ms` reading)."""
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


# back-to-back launches per timed run: at least 20 and a run of at least
# 1 ms, at most 500 (CUDA queues about a thousand launches before the host
# blocks, and a call here launches at most two kernels)
RUN_MIN, RUN_MAX, RUN_MIN_MS = 20, 500, 1.0
_sleep_cycles_per_ms = None


def sleep_cycles_per_ms() -> float:
    """Clock cycles of `torch.cuda._sleep` per ms on this card, measured once."""
    global _sleep_cycles_per_ms
    if _sleep_cycles_per_ms is None:
        torch.cuda._sleep(1000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        torch.cuda.synchronize()
        _sleep_cycles_per_ms = 20_000_000 / start.elapsed_time(end)
    return _sleep_cycles_per_ms


def device_time(fn, runs: int = 5) -> dict:
    """`ms`: device time per launch of `fn`, median over `runs` runs of n
    back-to-back calls timed by events. A sleep kernel queued first keeps the
    device busy until every call of the run is queued, so the events see the
    launches end to end and none of the host time between them; `ahead` is
    False where a run's sleep ended before its last call was queued (then
    host gaps are in the reading). `host_us`: wall time of one call's
    enqueue on an idle device, median of 11. `call_ms`: `median_ms`, one
    call with host and device time together. The inputs stay in L2 between
    launches, as the model's do (each is made just before its kernel)."""
    fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(11):
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    host_us = statistics.median(host) * 1e6
    per_ms = sleep_cycles_per_ms()

    def run(n: int) -> tuple[float, bool]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(per_ms * (1.0 + 3e-3 * n * host_us)))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n, ahead

    first, _ = run(RUN_MIN)
    n = min(RUN_MAX, max(RUN_MIN, int(np.ceil(RUN_MIN_MS / max(first, 1e-4)))))
    reads = [run(n) for _ in range(runs)]
    return {'ms': statistics.median(t for t, _ in reads), 'host_us': host_us,
            'call_ms': median_ms(fn, runs), 'n': n, 'ahead': all(a for _, a in reads)}


def timing_note(t: dict) -> str:
    return (f'{t["ms"]:.4f} ms device ({t["n"]} launches a run'
            f'{"" if t["ahead"] else ", HOST GAPS"}), {t["host_us"]:.1f} us host, '
            f'{t["call_ms"]:.4f} ms one call')


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


def roi_clouds(n_clouds: int, n_points: int, seed: int) -> np.ndarray:
    """Canonical ROI clouds as PointRCNN's head pools them: points of a
    car-sized box around the origin, cyclic repeats where the box held fewer
    points than slots, and every seventh cloud an empty ROI: all origin."""
    rng = np.random.RandomState(seed)
    out = rng.uniform([-2.0, -0.8, -0.8], [2.0, 0.8, 0.8],
                      (n_clouds, n_points, 3)).astype(np.float32)
    for c in range(n_clouds):
        held = int(rng.randint(1, 2 * n_points))
        if held < n_points:
            out[c] = out[c, np.arange(n_points) % held]
    out[::7] = 0.0
    return out


def fps_paths(fps_mod, B: int, N: int, npoint: int) -> dict:
    """The layouts phase 3 holds against the plain version at one shape: the
    plan's own choice, the block path, and a cluster of 16 blocks per cloud
    (launched even where the plan would not take it: where not every cluster
    is resident at once the rest wait, and the result is the same)."""
    S = fps_mod.CLUSTER_SIZES[0]
    return {'plan': fps_mod.plan_for(torch.cuda.current_device(), B, N, npoint),
            'block': fps_mod.fps_plan(B, N, npoint, 1, lambda *a: 0, path='block'),
            'cluster': fps_mod.FpsPlan('cluster', S, *fps_mod.cluster_layout(N, S))}


def fps_phase(fps_mod, plain, kitti_points) -> dict:
    # PointRCNN launches FPS three times in a predict: backbone level 2 on the
    # 4096-point prefix of a 16384-point cloud, and the ROI stack on 400
    # canonical clouds of 512 points, then on the 128 points picked there;
    # the last two cases pick more points than a cloud holds
    rng = np.random.RandomState(13)
    cases = [('flagship', torch.from_numpy(kitti_points(8, 16384, 1)[..., :3].copy()), 4096),
             ('tie-heavy', torch.from_numpy(tie_heavy_xyz(8, 16384, 2)), 4096),
             ('odd N', torch.from_numpy(kitti_points(3, 10007, 3)[..., :3].copy()), 2000),
             ('PointRCNN SA level 2',
              torch.from_numpy(kitti_points(4, 16384, 12)[:, :4096, :3].copy()), 1024),
             ('ROI stack level 1', torch.from_numpy(roi_clouds(400, 512, 4)), 128),
             ('ROI stack level 2', None, 32),
             ('npoint > N', torch.from_numpy(rng.rand(2, 300, 3).astype(np.float32) * 9), 500),
             ('npoint > N, large', torch.from_numpy(rng.rand(2, 2500, 3).astype(np.float32) * 9),
              3000)]
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    occupancy = {S: fps_mod._max_active_clusters(0, S, *fps_mod.cluster_layout(16384, S))
                 for S in fps_mod.CLUSTER_SIZES if fps_mod.cluster_layout(16384, S)}
    log('3 fps', f'{sm} SMs; clusters resident at once, at the flagship cloud\'s layout of each '
        f'size: {occupancy}')
    for name, xyz, npoint in cases:
        if xyz is None:     # the points the previous case picked, in pick order
            xyz = torch.gather(x, 1, got.long()[..., None].expand(-1, -1, 3)).cpu()
        x = xyz.cuda().contiguous()
        want = plain.farthest_point_sample(x, npoint)
        torch.cuda.synchronize()
        paths = fps_paths(fps_mod, x.shape[0], x.shape[1], npoint)
        for label, plan in paths.items():
            got = fps_mod.farthest_point_sample_cuda(x, npoint, plan)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f'[3 fps] FAILED {name}, {label} {plan}: '
                                 f'{int((got != want).sum())} indices differ')
        log('3 fps', f'{name} {tuple(xyz.shape)} -> {npoint}: ' + ', '.join(
            f'{label} {tuple(plan)}' for label, plan in paths.items())
            + ': each == plain (exact)')
        got = fps_mod.farthest_point_sample_cuda(x, npoint)   # the plan's, for the next case
    # both paths at the flagship shape and at PointRCNN's level 2, in turns
    # (block, cluster, cluster, block), the cluster path as the plan would
    # take it (every cloud's cluster resident at once); then each path's chain
    # floor: its layout with one point a thread, so a step is the reduction alone
    x = cases[0][1].cuda().contiguous()
    res = {}
    for name, xyz, npoint in (cases[0], cases[3]):
        xyz = xyz.cuda().contiguous()
        B, N = xyz.shape[:2]
        paths = {'plan': fps_mod.plan_for(torch.cuda.current_device(), B, N, npoint),
                 'block': fps_mod.fps_plan(B, N, npoint, 1, lambda *a: 0, path='block'),
                 'cluster': fps_mod.plan_for(torch.cuda.current_device(), B, N, npoint,
                                             'cluster')}
        turns = {'block': [], 'cluster': []}
        for label in ('block', 'cluster', 'cluster', 'block'):
            turns[label].append(device_time(
                lambda: fps_mod.farthest_point_sample_cuda(xyz, npoint, paths[label])))
        res[name] = {label: min(t, key=lambda r: r['ms']) for label, t in turns.items()}
        log('3 fps', f'{name} {tuple(xyz.shape)} -> {npoint}, in turns block, cluster, cluster, '
            'block: ' + '; '.join(
                f'{label} {tuple(paths[label])} ' + ' / '.join(f'{r["ms"]:.4f}' for r in t)
                + f' ms device, {t[0]["host_us"]:.1f} us host' for label, t in turns.items())
            + f'; the plan takes {paths["plan"].path}')
    flag = fps_paths(fps_mod, 8, 16384, 4096)
    floors = {}
    for label, plan in (('block', fps_mod.FpsPlan('block', 1, 1024, 1)),
                        ('cluster', flag['plan']._replace(ppt=1))):
        n = plan.S * plan.threads
        cloud = x[:, :n].contiguous()
        floors[label] = device_time(
            lambda: fps_mod.farthest_point_sample_cuda(cloud, 4096, plan))['ms'] / 4095
        log('3 fps', f'chain floor of the {label} path, {tuple(plan)} on clouds of {n} points, '
            f'4096 picks: {floors[label] * 1e3:.4f} us a step, {floors[label] * 4095:.4f} ms for '
            '4095 steps')
    # the barrier's share: one warp a block, 4 clouds (resident at every S)
    by_size = {}
    for S in fps_mod.CLUSTER_SIZES:
        plan = fps_mod.FpsPlan('cluster', S, 32, 1)
        cloud = x[:4, :S * 32].contiguous()
        by_size[S] = device_time(
            lambda: fps_mod.farthest_point_sample_cuda(cloud, 4096, plan))['ms'] / 4095 * 1e3
    log('3 fps', 'a cluster step with one warp a block, 4 clouds of 32 points a block, us by '
        'cluster size: ' + ', '.join(f'S={S} {v:.4f}' for S, v in by_size.items()))
    if flag['plan'].path != 'cluster':
        raise SystemExit(f'[3 fps] FAILED: the flagship shape plans {flag["plan"]}, not a cluster')
    t = device_time(lambda: fps_mod.farthest_point_sample_cuda(x, 4096))
    plain_ms = median_ms(lambda: plain.farthest_point_sample(x, 4096), 5)
    # bound: the card-wide least time. Bytes: the cloud read once, the
    # indices written once. Operations: every step updates every point's
    # minimum (3 subtractions, 3 products, 2 sums, a minimum and a compare)
    B, N, npoint = 8, 16384, 4096
    t_bytes = (B * N * 12 + B * npoint * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = B * N * (npoint - 1) * 10 / FP32_FLOP_PER_S * 1e3
    block = res['flagship']['block']
    return {'max_abs_err': 0, 'ms': t['ms'], 'host_us': t['host_us'],
            'call_ms': t['call_ms'], 'plain_ms': plain_ms, 'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations', 'library_ms': None,
            'library_host_us': None, 'block_ms': block['ms'],
            'chain_floor_ms': floors['cluster'] * 4095,
            'block_chain_floor_ms': floors['block'] * 4095,
            'note': f'{timing_note(t)} ({flag["plan"].path} path); block path {block["ms"]:.4f} ms; '
                    f'chain floor {floors["cluster"] * 4095:.4f} ms (block path '
                    f'{floors["block"] * 4095:.4f} ms)'}


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


ROI_KEYS = ('rois', 'roi_scores', 'roi_labels', 'roi_mask', 'rcnn_cls_preds', 'rcnn_reg_preds')
# a proposal of one run is the other's when every box parameter agrees to this
# (metres, radians); the first stage's boxes agree to about 1e-5
ROI_MATCH_ATOL = 1e-3
# share of the CPU run's proposals that must have a twin in the CUDA run, and
# the most proposals of one cloud that may lack one (measured on an H100: 199
# of 200 have a twin)
ROI_MATCH_SHARE = 0.98
ROI_UNMATCHED_PER_CLOUD = 2


def match_rois(got: dict, want: dict, phase: str) -> tuple[dict, dict, str]:
    """Bring the per-ROI outputs of two runs into one slot order.

    The proposal layer sorts thousands of near-tied scores, so float32
    rounding permutes slots between the runs and moves a few proposals across
    the cut. Both runs must keep the same number of proposals in every cloud.
    Each valid ROI of `want` is paired with the valid ROI of `got` whose box is
    nearest; pairs further apart than ROI_MATCH_ATOL are dropped, at most
    ROI_UNMATCHED_PER_CLOUD of a cloud. Returns both dicts with the ROI keys
    cut to the pairs (clouds side by side along the first axis), and a note
    for the log."""
    n_want = n_pairs = 0
    g_rows, w_rows = {k: [] for k in ROI_KEYS}, {k: [] for k in ROI_KEYS}
    kept_g, kept_w = got['roi_mask'].sum(dim=1), want['roi_mask'].sum(dim=1)
    if not torch.equal(kept_g, kept_w):
        raise SystemExit(f'[{phase}] FAILED: proposals kept per cloud {kept_g.tolist()} on CUDA, '
                         f'{kept_w.tolist()} on the CPU')
    for b in range(want['rois'].shape[0]):
        w_slots = want['roi_mask'][b].nonzero()[:, 0]
        g_slots = got['roi_mask'][b].nonzero()[:, 0]
        dist = (want['rois'][b][w_slots][:, None] - got['rois'][b][g_slots][None]).abs().amax(-1)
        near, twin = dist.min(dim=1)
        paired = near <= ROI_MATCH_ATOL
        if len(set(twin[paired].tolist())) != int(paired.sum()):
            raise SystemExit(f'[{phase}] FAILED: two proposals of the CPU run match one of the '
                             'CUDA run')
        if len(w_slots) - int(paired.sum()) > ROI_UNMATCHED_PER_CLOUD:
            raise SystemExit(f'[{phase}] FAILED: cloud {b}: {len(w_slots) - int(paired.sum())} of '
                             f'{len(w_slots)} proposals of the CPU run have no twin in the CUDA '
                             f'run (at most {ROI_UNMATCHED_PER_CLOUD})')
        n_want += len(w_slots)
        n_pairs += int(paired.sum())
        for k in ROI_KEYS:
            w_rows[k].append(want[k][b][w_slots[paired]])
            g_rows[k].append(got[k][b][g_slots[twin[paired]]])
    if n_pairs < ROI_MATCH_SHARE * n_want:
        raise SystemExit(f'[{phase}] FAILED: {n_pairs} of {n_want} proposals of the CPU run have '
                         f'a twin among the {int(got["roi_mask"].sum())} of the CUDA run')
    got = {**got, **{k: torch.cat(v) for k, v in g_rows.items()}}
    want = {**want, **{k: torch.cat(v) for k, v in w_rows.items()}}
    return got, want, (f'; {kept_w.tolist()} proposals kept per cloud in both runs; ROIs matched '
                       f'by box, {n_pairs} of {n_want} have a twin (near-tied proposal scores '
                       'permute slots and move the cut)')


def cuda_vs_cpu_phase(cfg, dispatch, synthetic, phase: str = '4 cuda-vs-cpu',
                      fps_npoint: int | None = 4096, adjust=None, predict: bool = False) -> None:
    """Forward of one model on CUDA against the same model on the CPU at B=2,
    N=4096: float outputs within FWD_RTOL of each output's scale, integer
    and bool outputs (indices, labels, masks) equal. The per-ROI outputs of a
    two-stage model are compared ROI by ROI after `match_rois`. FPS indices
    first, unless `fps_npoint` is None; `adjust` is done to the seeded model
    on both sides; with `predict`, the detections of both runs are matched
    by box and label (`match_detections`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pts = torch.from_numpy(synthetic.kitti_points(2, 4096, 4))
    note = ''
    if fps_npoint is not None:
        want_idx = dispatch.farthest_point_sample(pts[..., :3].contiguous(), fps_npoint)
        got_idx = dispatch.farthest_point_sample(pts[..., :3].contiguous().cuda(),
                                                 fps_npoint).cpu()
        if not torch.equal(want_idx, got_idx):
            raise SystemExit(f'[{phase}] FAILED: FPS indices differ between CUDA and CPU')
        note = '; FPS indices equal'
    cpu_net = synthetic.random_model(cfg, 'cpu')
    if adjust is not None:
        adjust(cpu_net)
    gpu_net = synthetic.random_model(cfg, 'cuda')
    gpu_net.load_state_dict(cpu_net.state_dict())
    with torch.inference_mode():
        want = flatten(cpu_net({'points': pts}))
        got = {k: v.cpu() for k, v in flatten(gpu_net({'points': pts.cuda()})).items()}
    if 'rois' in want:
        got, want, roi_note = match_rois(got, want, phase)
        note += roi_note
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if g.dtype.is_floating_point:
            scale = max(float(w.abs().max()), 1e-6)
            rel = float((g - w).abs().max()) / scale
            worst = max(worst, rel)
            if not rel <= FWD_RTOL:
                raise SystemExit(f'[{phase}] FAILED {k}: max |diff| / max |cpu| = {rel:.3e}')
        elif not torch.equal(g, w):
            raise SystemExit(f'[{phase}] FAILED {k}: integer outputs differ')
    if predict:
        note += '; predict: ' + match_detections(
            {k: v.cpu() for k, v in gpu_net.predict({'points': pts.cuda()}).items()},
            cpu_net.predict({'points': pts}), phase)
    log(phase, f'{cfg.MODEL.NAME} B=2 N=4096 forward: {len(want)} outputs agree, worst '
        f'max|diff|/max|cpu| = {worst:.3e} (bound {FWD_RTOL:g}), integer and bool outputs '
        f'equal{note}')


def reset_launches(wrappers: dict) -> None:
    """wrappers: kernel entry point -> (wrapper, the name of its counter)."""
    for fn, counter in wrappers.values():
        setattr(fn, counter, 0)


def read_launches(wrappers: dict) -> dict:
    return {name: getattr(fn, counter) for name, (fn, counter) in wrappers.items()}


def check_detections(phase: str, det: dict, B: int, P: int = 100) -> None:
    want = {'pred_boxes': (B, P, 7), 'pred_scores': (B, P), 'pred_labels': (B, P),
            'pred_mask': (B, P)}
    for k, shape in want.items():
        if tuple(det[k].shape) != shape:
            raise SystemExit(f'[{phase}] FAILED {k}: shape {tuple(det[k].shape)} != {shape}')
        if det[k].dtype.is_floating_point and not bool(torch.isfinite(det[k]).all()):
            raise SystemExit(f'[{phase}] FAILED {k}: non-finite values')


def predict_phase(cfg, wrappers, synthetic, card: str, phase: str = '5 predict', B: int = 8,
                  expected: dict = PREDICT_LAUNCHES, N: int = 16384, points=None, adjust=None,
                  profile: bool = False) -> dict:
    """One model's `predict` at full width: shapes, finite values, the
    kernels' launches in the first run, then frames/s and peak memory.
    `points(B, N, seed)` makes the clouds (default `synthetic.kitti_points`),
    `adjust` is done to the seeded model; with `profile`, `torch.profiler`
    reads device time, the busy share and any kernel of cuDNN's FFT route,
    and each convolution stage of a grid model its memory beyond its input."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = synthetic.random_model(cfg, 'cuda', seed=7)
    if adjust is not None:
        adjust(net)
    pts = torch.from_numpy((points or synthetic.kitti_points)(B, N, 5)).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(wrappers)
    det = net.predict({'points': pts})
    torch.cuda.synchronize()
    launches = read_launches(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_detections(phase, det, B, cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    if launches != expected:
        raise SystemExit(f'[{phase}] FAILED: kernel launches {launches}, expected {expected}')
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
    log(phase, f'{cfg.MODEL.NAME} B={B} N={N}: shapes ok, finite, '
        f'{int(det["pred_mask"].sum())} kept boxes, launches {launches}; median '
        f'{med * 1e3:.3f} ms/batch = {B / med:.2f} frames/s (5 runs), peak allocated '
        f'{peak:.3f} GiB on {card}')
    if profile:
        profile_note(phase, net, pts, med)
    return launches


# a convolution stage that allocates more than this beyond its input is named
# with the kernels it ran (cuDNN's workspace)
WORKSPACE_GIB = 1.0


def profile_note(phase: str, net, pts: torch.Tensor, wall_s: float) -> None:
    """Device time per predict, busy share and cuDNN's FFT kernels
    (`tools/profile_predict.trace`); for a grid model, each convolution
    stage's peak memory beyond its input, and the kernels of any stage above
    WORKSPACE_GIB."""
    from pdm_ssd_torch.models.backbones_3d.grid_point_backbone import GridPointBackbone
    from pdm_ssd_torch.tools.profile_predict import grid_conv_stages, peak_extra_gib, trace
    with torch.inference_mode():
        prof = trace(net, {'points': pts})
        fft = prof['fft_kernels']
        fft_note = ('no FFT-route kernel' if not fft else 'FFT route: ' + '; '.join(
            f'{r["name"]} x{r["calls_per_predict"]:g} {r["ms_per_predict"]:.3f} ms'
            for r in fft))
        log(phase, f'device {prof["device_ms_per_predict"]:.3f} ms per predict '
            f'({prof["device_activities_per_predict"]:.0f} activities), busy '
            f'{prof["device_ms_per_predict"] / (wall_s * 1e3):.3f}; top kernels: '
            + '; '.join(f'{r["name"][:60]} {r["ms_per_predict"]:.3f} ms'
                        for r in prof['top_kernels'][:5]) + f'; {fft_note}')
        if not isinstance(net.backbone_3d, GridPointBackbone):
            return
        stages, _ = grid_conv_stages(net, pts)
        peaks = {name: peak_extra_gib(fn) for name, fn in stages}
        log(phase, 'peak GiB beyond the input per convolution stage: ' + ', '.join(
            f'{k} {v:.3f}' for k, v in peaks.items()))
        for name, fn in stages:
            if peaks[name] > WORKSPACE_GIB:
                from torch.profiler import ProfilerActivity, profile
                with profile(activities=[ProfilerActivity.CUDA]) as p:
                    fn()
                    torch.cuda.synchronize()
                names = sorted({e.key[:80] for e in p.key_averages()
                                if e.self_device_time_total > 0})
                log(phase, f'{name} allocates {peaks[name]:.3f} GiB: kernels {names}')


def shipped_predict_phase(cfg, synthetic, B: int = 4) -> None:
    """`pointrcnn.yaml` as shipped: its two FP modules stop one level short,
    so the heads read the raw 1-channel input features. One predict: shapes
    and finite values."""
    net = synthetic.random_model(cfg, 'cuda', seed=7)
    width = net.backbone_3d.num_point_features
    det = net.predict({'points': torch.from_numpy(synthetic.kitti_points(B, 16384, 5)).cuda()})
    torch.cuda.synchronize()
    check_detections('11 pointrcnn predict', det, B)
    log('11 pointrcnn predict', f'the file as shipped (heads on {width}-channel features) '
        f'B={B} N=16384: shapes ok, finite, {int(det["pred_mask"].sum())} kept boxes')


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
               group, sa_fused, spoil_idx=False, reps=5) -> tuple[dict, dict]:
    """One shape through the three grouping kernels and their plain
    versions. Returns per-kernel dicts of err, ms, plain_ms, library_ms,
    bound_ms summed over the shape's launches (one selection, one gather and
    one scatter-add per branch), and the counts of the plain emulations: the
    selection's walk ('walk') and the scatter-add's runs ('runs')."""
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
    # the plain emulation of the compacted walk, which counts its steps
    walk, occupied, steps = group.window_select_walk_plain(*sel_args)
    for g, w in zip(walk, want):
        if not all(torch.equal(a, b) for a, b in zip(g, w)):
            raise SystemExit(f'[6 group] FAILED {name} window_select: the walk emulation '
                             'differs from plain')
    sel_t = device_time(lambda: group.window_select_cuda(*sel_args), reps)
    res = {'window_select': {
        'err': 0.0, 'ms': sel_t['ms'], 'host_us': sel_t['host_us'], 'call_ms': sel_t['call_ms'],
        'plain_ms': median_ms(lambda: group.window_select_plain(*sel_args), reps),
        'library_ms': None, 'library_host_us': None,
        'bytes': (table.numel() * 4 + cells.numel() * 4 + xyz.numel() * 4 + new_xyz.numel() * 4
                  + sum(B * M * K * 16 + B * M for K in nsamples))}}
    walked = {'centers': B * M, 'occupied': int(occupied.sum()),
              'occupied_max': int(occupied.max()), 'steps': int(steps.sum()),
              'steps_max': int(steps.max()), 'uncompacted_steps': B * M * -(-9 * cap // 32)}
    counts = {'walk': walked, 'runs': {'rows': 0, 'runs': 0, 'sums': 0, 'atomics': 0}}
    log('6 group', f'{name} window_select: {sel_t["ms"]:.4f} ms device; plain emulation of the '
        f'walk: occupied slots per center {walked["occupied"] / (B * M):.2f} mean, '
        f'{walked["occupied_max"]} max; steps per center {walked["steps"] / (B * M):.3f} mean, '
        f'{walked["steps_max"]} max, against the {-(-9 * cap // 32)} of a walk over the '
        'uncompacted window')

    gen = torch.Generator(device='cpu').manual_seed(seed)
    payload = torch.randn((B, N, width), generator=gen).to(dev)
    zero = {'err': 0.0, 'ms': 0.0, 'host_us': 0.0, 'call_ms': 0.0, 'plain_ms': 0.0,
            'library_ms': 0.0, 'library_host_us': 0.0, 'bytes': 0}
    gather, scatter = dict(zero), dict(zero)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count

    def add(acc: dict, kern: dict, lib: dict) -> None:
        for key in ('ms', 'host_us', 'call_ms'):
            acc[key] += kern[key]
        acc['library_ms'] += lib['ms']
        acc['library_host_us'] += lib['host_us']
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
        g_t = device_time(lambda: group.gather_rows_cuda(feats, rows), reps)
        lib_t = device_time(lambda: torch.gather(feats, 1, safe), reps)
        add(gather, g_t, lib_t)
        gather['plain_ms'] += median_ms(lambda: group.gather_rows_plain(feats, rows), reps)
        g_bytes = B * N * C * 4 + rows.numel() * 4 + out.numel() * 4
        gather['bytes'] += g_bytes
        log('6 group', f'{name} gather_rows (B={B}, R={M * K}, C={C}, row stride {width}, slice '
            f'start {s0}): kernel {timing_note(g_t)}; torch.gather {timing_note(lib_t)}; bound '
            f'{g_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms')

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
        s_t = device_time(lambda: group.scatter_add_rows_cuda(vals, rows, N), reps)
        add(scatter, s_t,
            device_time(lambda: torch.zeros((B * N + 1, C), device=dev).index_add_(0, flat, v2),
                        reps))
        scatter['plain_ms'] += median_ms(lambda: group.scatter_add_rows_plain(vals, rows, N), reps)
        s_bytes = vals.numel() * 4 + rows.numel() * 4 + B * N * C * 4
        scatter['bytes'] += s_bytes
        # rows added, runs of equal indices, sums sent and the atomics they
        # take (one per unit of the row), counted by the plain emulation
        s_plan = group.scatter_plan(B, M * K, C, N, sm_count, vals.data_ptr() % 16)
        n_rows, n_runs, n_sums = group.scatter_runs(rows, N, s_plan.span)
        ran = {'rows': n_rows, 'runs': n_runs, 'sums': n_sums,
               'atomics': n_sums * C * 4 // s_plan.unit}
        for key, v in ran.items():
            counts['runs'][key] += v
        log('6 group', f'{name} scatter_add_rows (B={B}, R={M * K}, C={C}, {s_plan}): plain '
            f'emulation: rows {n_rows}, runs {n_runs}, sums sent {n_sums}, atomics '
            f'{ran["atomics"]} of {s_plan.unit // 4} floats; kernel {timing_note(s_t)}; bound '
            f'{s_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms')
    res['gather_rows'], res['scatter_add_rows'] = gather, scatter
    for r in res.values():
        r['bound_ms'] = r.pop('bytes') / HBM_BYTES_PER_S * 1e3
    log('6 group', f'{name} N={N} M={M} K={list(nsamples)} C={[b - a for a, b in slices]}: '
        f'selection and gather exact ({empty} empty balls), scatter-add within rounding '
        f'(kernel vs plain max |diff| {scatter["err"]:.2e}); kernel device ms / host us / one '
        'call ms, plain ms (one call), library device ms / host us, bound ms: '
        + '; '.join(f'{k} {r["ms"]:.4f}/{r["host_us"]:.1f}/{r["call_ms"]:.4f}, '
                    f'{r["plain_ms"]:.3f}, '
                    + ('-' if r['library_ms'] is None
                       else f'{r["library_ms"]:.4f}/{r["library_host_us"]:.1f}')
                    + f', {r["bound_ms"]:.4f}' for k, r in res.items()))
    return res, counts


def group_phase(cfg, fps_mod, group, sa_fused, synthetic) -> dict:
    """The grouping kernels at the flagship's SA levels and at a ragged shape.
    Returns per-kernel totals over the levels (the launches of one forward)."""
    pcr = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
    bev = (pcr[0], pcr[1], pcr[3], pcr[4])
    pts = torch.from_numpy(synthetic.kitti_points(8, 16384, 6)[..., :3].copy()).cuda()
    order = fps_mod.farthest_point_sample_cuda(pts, 4096).long()
    sampled = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))    # FPS order
    total, emulated = {}, {}
    for k, (name, n_in, m, radii, nsamples, width, slices, cap) in enumerate(sa_level_specs(cfg)):
        xyz = (pts if k == 0 else sampled[:, :n_in]).contiguous()
        new_xyz = sampled[:, :m].contiguous()
        res, counts = group_case(name, xyz, new_xyz, radii, nsamples, width, slices, cap, bev,
                                 20 + k, group, sa_fused)
        for kern, r in res.items():
            lib = None if r['library_ms'] is None else 0.0
            t = total.setdefault(kern, {'err': 0.0, 'ms': 0.0, 'host_us': 0.0, 'call_ms': 0.0,
                                        'plain_ms': 0.0, 'bound_ms': 0.0, 'library_ms': lib,
                                        'library_host_us': lib})
            t['err'] = max(t['err'], r['err'])
            for key in ('ms', 'host_us', 'call_ms', 'plain_ms', 'bound_ms'):
                t[key] += r[key]
            if lib is not None:
                t['library_ms'] += r['library_ms']
                t['library_host_us'] += r['library_host_us']
            t.setdefault('level_ms', []).append(r['ms'])
        for key, r in counts.items():    # the selection's walk, the scatter's runs
            acc = emulated.setdefault(key, dict.fromkeys(r, 0))
            for c, v in r.items():
                acc[c] = max(acc[c], v) if c.endswith('_max') else acc[c] + v
    walk, runs = emulated['walk'], emulated['runs']
    sc_ms = total['scatter_add_rows']['level_ms']
    log('6 group', f'flagship levels in total: window_select {total["window_select"]["ms"]:.4f} '
        f'ms device ({total["window_select"]["level_ms"]}), plain emulation of its walk: '
        f'occupied slots per center {walk["occupied"] / walk["centers"]:.2f} mean, '
        f'{walk["occupied_max"]} max, steps per center {walk["steps"] / walk["centers"]:.3f} '
        f'mean, {walk["steps_max"]} max, against the '
        f'{walk["uncompacted_steps"] / walk["centers"]:.0f} of a walk over the uncompacted window; '
        f'scatter_add_rows {total["scatter_add_rows"]["ms"]:.4f} ms device ({sc_ms}; the train '
        f'step\'s 4 launches, levels 2 and 3: {sum(sc_ms[1:]):.4f}), bound '
        f'{total["scatter_add_rows"]["bound_ms"]:.4f}, plain emulation of its runs: rows '
        f'{runs["rows"]}, runs {runs["runs"]}, sums sent {runs["sums"]}, atomics '
        f'{runs["atomics"]}')
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


def host_breakdown(group, kernels) -> dict:
    """Host microseconds a call of the parts of `gather_rows_cuda` at SA
    level 1's shape (B=8, R=65536, C=1): mean over 300 calls in a row, the
    device left to run behind (each launch is shorter than its enqueue)."""
    feats = torch.randn((8, 16384, 1), device='cuda')
    rows = torch.randint(0, 16384, (8, 65536), dtype=torch.int32, device='cuda')
    out = torch.empty((8, 65536, 1), device='cuda')
    safe = rows.long()[..., None]
    lib = kernels.load()
    ptr = feats.data_ptr()
    plan = group._gather_plan_on(0, 8, 16384, 65536, 1, 4, 1, ptr % 16)
    args = (ptr, rows.data_ptr(), out.data_ptr(), 8, 16384, 65536, 1, 1, plan.lanes, plan.passes,
            plan.unit, int(plan.wide_index), plan.blocks, kernels.stream(0))

    def enter_exit():
        with kernels.on_device(0):
            pass

    parts = {'wrapper': lambda: group.gather_rows_cuda(feats, rows),
             'torch.gather': lambda: torch.gather(feats, 1, safe),
             'torch.empty': lambda: torch.empty((8, 65536, 1), device=feats.device),
             'plan lookup': lambda: group._gather_plan_on(0, 8, 16384, 65536, 1, 4, 1, ptr % 16),
             'device context': enter_exit, 'stream': lambda: kernels.stream(0),
             'C launch': lambda: lib.gather_rows_launch(*args)}
    res = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(300):
            fn()
        res[name] = (time.perf_counter() - t0) / 300 * 1e6
        torch.cuda.synchronize()
    log('6 group', 'host us per call at SA level 1, mean of 300 in a row: '
        + ', '.join(f'{k} {v:.2f}' for k, v in res.items()))
    return res


def window_tests(xyz: torch.Tensor, new_xyz: torch.Tensor, cell: float) -> int:
    """The distance tests a ball query of radius at most `cell` needs on this
    data: for each center, the points in the 3x3 window of BEV cells of side
    `cell` around the center's own cell (the window the TPU kernel reads)."""
    B = xyz.shape[0]
    lo = torch.minimum(xyz[..., :2].amin((0, 1)), new_xyz[..., :2].amin((0, 1)))
    pc = ((xyz[..., :2] - lo) / cell).floor().long()
    cc = ((new_xyz[..., :2] - lo) / cell).floor().long()
    W = int(max(pc[..., 0].max(), cc[..., 0].max())) + 1
    H = int(max(pc[..., 1].max(), cc[..., 1].max())) + 1
    hist = torch.zeros((B, H * W), dtype=torch.long, device=xyz.device)
    hist.scatter_add_(1, pc[..., 1] * W + pc[..., 0], torch.ones_like(pc[..., 0]))
    pad = torch.nn.functional.pad(hist.view(B, H, W), (1, 1, 1, 1))
    window = sum(pad[:, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3))
    return int(window.reshape(B, -1).gather(1, cc[..., 1] * W + cc[..., 0]).sum())


def ball_query_case(name, xyz, new_xyz, radii, nsamples, bq, plain, feats=None, mask=None,
                    time_it=False):
    """One shape through both ball-query kernel paths, the grid and the walk,
    and the plain version: exact equality of the indices, then of the rows
    gathered by them from `xyz` and from `feats`, each in the layout the model
    hands to `dispatch.grouping_operation` (a contiguous tensor or a channel
    slice of a wider one), against the plain gather. With `time_it` the times
    of both paths (the grid's build and walk apart too) and the terms of the
    bound."""
    from pdm_ssd_torch.ops import dispatch
    xyz_c, new_xyz = xyz.contiguous(), new_xyz.contiguous()
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    plans = {path: bq.ball_query_plan(N, radii, path=path) for path in ('grid', 'walk')}
    chosen = bq.ball_query_plan(N, radii).path
    got = {path: bq.ball_query_cuda(radii, nsamples, xyz_c, new_xyz, mask, plan=plan)
           for path, plan in plans.items()}
    torch.cuda.synchronize()
    want = [plain.ball_query(r, k, xyz_c, new_xyz, mask=mask) for r, k in zip(radii, nsamples)]
    torch.cuda.synchronize()
    empty = 0
    sources = [('xyz', xyz)] + ([] if feats is None else [('features', feats)])
    for i, (r, w) in enumerate(zip(radii, want)):
        for path in plans:
            g = got[path][i]
            if not torch.equal(g, w):
                raise SystemExit(f'[9 ball query] FAILED {name} r={r}: {path} path: '
                                 f'{int((g != w).sum())} of {g.numel()} indices differ')
        g = got[chosen][i]
        for label, src in sources:
            rows = dispatch.grouping_operation(src, g)
            torch.cuda.synchronize()
            if not torch.equal(rows, plain.grouping_operation(src, w)):
                raise SystemExit(f'[9 ball query] FAILED {name} r={r}: {label} '
                                 f'{tuple(src.shape)} strides {src.stride()} gathered by the '
                                 'kernel differs from the plain gather')
        first_d2 = (torch.gather(xyz_c, 1, w[..., :1].long().expand(-1, -1, 3)) - new_xyz) ** 2
        empty += int((first_d2.sum(-1) >= r * r).sum())      # slot 0 outside the ball: no hit
    layouts = ', '.join(f'{label} C={src.shape[2]} row stride {src.stride(1)}'
                        for label, src in sources)
    log('9 ball query', f'{name} B={B} N={N} M={M} r={list(radii)} K={list(nsamples)}'
        f'{" masked" if mask is not None else ""}: grid and walk paths == plain (exact; the '
        f'plan takes the {chosen} path), gathered rows exact ({layouts}), {empty} empty balls')
    if not time_it:
        return None
    from pdm_ssd_torch.ops import group
    for label, src in sources:        # the row gather at this shape, largest K
        if src.stride(2) != 1 or src.stride(0) != src.shape[1] * src.stride(1):
            src = src.contiguous()    # as `dispatch.grouping_operation` hands it on
        rows = got[chosen][-1].reshape(B, -1).contiguous()
        C = src.shape[2]
        safe = rows.long()[..., None].expand(-1, -1, C)
        g_t = device_time(lambda: group.gather_rows_cuda(src, rows))
        lib_t = device_time(lambda: torch.gather(src, 1, safe))
        log('9 ball query', f'{name} gather_rows of {label} (B={B}, R={rows.shape[1]}, C={C}, row '
            f'stride {src.stride(1)}): kernel {timing_note(g_t)}; torch.gather '
            f'{timing_note(lib_t)}; bound '
            f'{(B * N * C + rows.numel() * (C + 1)) * 4 / HBM_BYTES_PER_S * 1e3:.5f} ms')
    # the walk path's test count: a center's walk ends at the K-th hit of its
    # slowest radius, or at the cloud's end where a ball stays underfull (its
    # last slot then repeats its first). The grid path's: the window's points
    # in point order up to the same hit, from the plain emulation of its walk
    walk = torch.zeros((B, M), dtype=torch.long, device=xyz.device)
    full = torch.ones((B, M), dtype=torch.bool, device=xyz.device)
    for w in want:
        filled = w[..., -1] != w[..., 0]
        walk = torch.maximum(walk, torch.where(filled, w[..., -1].long() + 1, N))
        full &= filled
    emulated, grid_tests = bq.ball_query_grid_plain(radii, nsamples, xyz_c, new_xyz, mask,
                                                    cell=plans['grid'].cell, count_tests=True)
    if not all(torch.equal(e, w) for e, w in zip(emulated, want)):
        raise SystemExit(f'[9 ball query] FAILED {name}: the plain emulation of the grid walk '
                         'differs from the plain version')
    cell = plans['grid'].cell
    grid = bq.build_grid(xyz_c, cell, mask)
    build_t = device_time(lambda: bq.build_grid(xyz_c, cell, mask))
    walk_only_t = device_time(lambda: bq.ball_query_cuda(radii, nsamples, xyz_c, new_xyz, mask,
                                                         plan=plans['grid'], grid=grid))
    t = {path: device_time(lambda: bq.ball_query_cuda(radii, nsamples, xyz_c, new_xyz, mask,
                                                      plan=plan))
         for path, plan in plans.items()}
    c = t[chosen]
    return {'ms': c['ms'], 'host_us': c['host_us'], 'call_ms': c['call_ms'],
            'grid_ms': t['grid']['ms'], 'walk_path_ms': t['walk']['ms'],
            'grid_build_ms': build_t['ms'], 'grid_walk_ms': walk_only_t['ms'],
            'plain_ms': median_ms(lambda: [plain.ball_query(r, k, xyz_c, new_xyz, mask=mask)
                                           for r, k in zip(radii, nsamples)], 5),
            'bytes': xyz.numel() * 4 + new_xyz.numel() * 4 + sum(B * M * K * 4 for K in nsamples),
            'window_tests': window_tests(xyz_c, new_xyz, float(max(radii))),
            'walk_tests': int(walk.sum()), 'grid_tests': int(grid_tests.sum()),
            'full': int(full.sum()), 'balls': B * M}


def ball_query_phase(cfg, bq, fps_mod, plain, synthetic) -> dict:
    """Returns the kernel's totals over the backbone's three SA levels at B=4
    (the launches of one backbone forward)."""
    sa = cfg.MODEL.BACKBONE_3D.SA_CONFIG
    gen = torch.Generator().manual_seed(10)

    def features(B, N, C):
        return torch.randn((B, N, C), generator=gen).cuda()

    def fps_centers(x, npoint):
        order = fps_mod.farthest_point_sample_cuda(x.contiguous(), npoint).long()
        return torch.gather(x, 1, order[..., None].expand(-1, -1, 3))

    # the levels' inputs as the backbone makes them. Level 1 groups channel
    # slices of the (B, N, 4) cloud around its prefix; level 2 the prefix
    # around FPS picks of it; level 3 those picks around their prefix
    cloud = torch.from_numpy(synthetic.kitti_points(4, 16384, 8)).cuda()
    pts = cloud[..., :3]
    l1 = pts[:, :sa.NPOINTS[0]]
    l2 = fps_centers(l1, sa.NPOINTS[1])
    clouds = [pts, l1, l2, l2[:, :sa.NPOINTS[2]]]
    widths = [sum(mlp[-1] for mlp in level) for level in sa.MLPS]
    feats = [cloud[..., 3:], features(4, sa.NPOINTS[0], widths[0]),
             features(4, sa.NPOINTS[1], widths[1])]
    total = {'ms': 0.0, 'host_us': 0.0, 'call_ms': 0.0, 'plain_ms': 0.0, 'grid_ms': 0.0,
             'walk_path_ms': 0.0, 'grid_build_ms': 0.0, 'grid_walk_ms': 0.0, 'bytes': 0,
             'window_tests': 0, 'walk_tests': 0, 'grid_tests': 0, 'full': 0, 'balls': 0}
    for k in range(3):
        r = ball_query_case(f'backbone SA level {k + 1}', clouds[k], clouds[k + 1],
                            list(sa.RADIUS[k]), list(sa.NSAMPLE[k]), bq, plain, feats=feats[k],
                            time_it=True)
        if bq.ball_query_plan(clouds[k].shape[1], sa.RADIUS[k]).path != 'grid':
            raise SystemExit(f'[9 ball query] FAILED: backbone SA level {k + 1} does not take '
                             'the grid path')
        log('9 ball query', f'backbone SA level {k + 1}: grid path {r["grid_ms"]:.4f} ms device '
            f'(build {r["grid_build_ms"]:.4f}, walk {r["grid_walk_ms"]:.4f}; {r["grid_tests"]} '
            f'tests walked), walk path {r["walk_path_ms"]:.4f} ms ({r["walk_tests"]} tests); '
            f'{r["window_tests"]} tests in the 3x3 BEV windows')
        for key in total:
            total[key] += r[key]
    # the ROI stack's input: 400 canonical clouds, xyz the first 3 of the 5
    # channels of the pooled block, features of the width `merge_down` gives
    roi = cfg.MODEL.ROI_HEAD
    width = roi.XYZ_UP_LAYER[-1]
    canon = torch.cat([torch.from_numpy(roi_clouds(400, 512, 9)).cuda(),
                       features(400, 512, 2)], dim=-1)[..., :3]
    for k in range(2):
        centers = fps_centers(canon, roi.SA_CONFIG.NPOINTS[k])
        ball_query_case(f'ROI stack level {k + 1}', canon, centers, [roi.SA_CONFIG.RADIUS[k]],
                        [roi.SA_CONFIG.NSAMPLE[k]], bq, plain,
                        feats=features(400, canon.shape[1], width))
        canon, width = centers, roi.SA_CONFIG.MLPS[k][-1]
    ball_query_case('backbone SA level 3', clouds[2], clouds[3], list(sa.RADIUS[2]),
                    list(sa.NSAMPLE[2]), bq, plain,
                    mask=(torch.rand(clouds[2].shape[:2], generator=gen) < 0.7).cuda())
    rng = np.random.RandomState(11)
    xyz = rng.uniform(0, 20, (3, 3001, 3)).astype(np.float32)
    xyz[:, 1500:2100] = xyz[:, :600]                               # duplicated points
    new_xyz = xyz[:, :333].copy()
    new_xyz[:, :9] += 500.0                                        # centers far outside
    ball_query_case('ragged', torch.from_numpy(xyz).cuda(), torch.from_numpy(new_xyz).cuda(),
                    [0.5, 1.3, 0.9], [5, 70, 3], bq, plain, feats=features(3, 3001, 37)[..., 3:22])
    zeros = torch.zeros((8, 512, 3), device='cuda')
    ball_query_case('512 origins', zeros, zeros[:, :128], [roi.SA_CONFIG.RADIUS[0]],
                    [roi.SA_CONFIG.NSAMPLE[0]], bq, plain)
    # the uniform cloud fills no ball of the smaller radius, so every walk runs
    # to the cloud's end; the same points drawn into a box of 2.1 x 2.4 x 2 m
    # fill the balls and time the early exit
    dense = pts * torch.tensor([0.03, 0.03, 0.5], device='cuda')
    d = ball_query_case('backbone SA level 1, dense box', dense, dense[:, :sa.NPOINTS[0]],
                        list(sa.RADIUS[0]), list(sa.NSAMPLE[0]), bq, plain, time_it=True)
    log('9 ball query', f'dense box, level 1: grid path {d["grid_ms"]:.4f} ms device (build '
        f'{d["grid_build_ms"]:.4f}, walk {d["grid_walk_ms"]:.4f}; {d["grid_tests"]} tests '
        f'walked), walk path {d["walk_path_ms"]:.4f} ms ({d["walk_tests"]} tests), plain torch '
        f'{d["plain_ms"]:.3f} ms, {d["full"]} of {d["balls"]} balls full at both radii, 3x3 '
        f'windows {d["window_tests"]}')
    # bound: bytes (xyz and centers read once, indices written once), or the
    # distance tests the function needs on this data, 8 operations each: those
    # of the 3x3 window of radius-sized cells around each center. The tests
    # the grid path walks, and the walk path's over the whole cloud, are
    # reported beside it
    t_bytes = total['bytes'] / HBM_BYTES_PER_S * 1e3
    t_ops = total['window_tests'] * 8 / FP32_FLOP_PER_S * 1e3
    stats = {'max_abs_err': 0, 'ms': total['ms'], 'host_us': total['host_us'],
             'call_ms': total['call_ms'], 'plain_ms': total['plain_ms'],
             'bound_ms': max(t_bytes, t_ops),
             'bound_by': 'bytes' if t_bytes >= t_ops else 'operations', 'library_ms': None,
             'library_host_us': None,
             'walk_ms': total['grid_tests'] * 8 / FP32_FLOP_PER_S * 1e3,
             'grid_build_ms': total['grid_build_ms'], 'grid_walk_ms': total['grid_walk_ms'],
             'walk_path_ms': total['walk_path_ms'], 'window_tests': total['window_tests'],
             'grid_tests': total['grid_tests'], 'walk_tests': total['walk_tests']}
    log('9 ball query', f'backbone levels at B=4, as the plan takes them (grid): kernel '
        f'{stats["ms"]:.4f} ms device with the grid build ({total["grid_build_ms"]:.4f} build, '
        f'{total["grid_walk_ms"]:.4f} walk), {stats["host_us"]:.1f} us host, '
        f'{stats["call_ms"]:.4f} ms one call; the walk path {total["walk_path_ms"]:.4f} ms; plain '
        f'torch {stats["plain_ms"]:.3f} ms (one call, median of 5), bound {stats["bound_ms"]:.4f} '
        f'ms by {stats["bound_by"]} (bytes {t_bytes:.4f} ms; {total["window_tests"]} tests in the '
        f'3x3 windows {t_ops:.5f} ms); the grid path walks {total["grid_tests"]} tests, '
        f'{stats["walk_ms"]:.5f} ms at the peak rate, the walk path {total["walk_tests"]}; '
        f'{total["full"]} of {total["balls"]} balls full at both radii')
    return stats


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


def train_phase(cfg, wrappers, synthetic, card: str, phase: str = '8 train',
                expected: dict = TRAIN_LAUNCHES) -> dict:
    """Five steps of `make_train_step` at B=8, N=16384, 8 boxes a cloud:
    finite losses, the last below the first, parameters changed, `expected`
    launches a step, ms per step and peak memory."""
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
        raise SystemExit(f'[{phase}] FAILED: losses {losses}')
    if not losses[-1] < losses[0]:
        raise SystemExit(f'[{phase}] FAILED: the loss did not fall: {losses}')
    want = {k: v * steps for k, v in expected.items()}
    if launches != want:
        raise SystemExit(f'[{phase}] FAILED: kernel launches {launches}, expected {want}')
    changed = sum(not torch.equal(p.detach(), before[k]) for k, p in net.named_parameters())
    finite = all(bool(torch.isfinite(p).all()) for p in net.parameters())
    if not finite or changed < 0.9 * len(before):
        raise SystemExit(f'[{phase}] FAILED: {changed} of {len(before)} parameter tensors '
                         f'changed, all finite: {finite}')
    med = statistics.median(times)
    log(phase, f'{cfg.MODEL.NAME} B={B} N={N}, {M} boxes per cloud, {steps} steps: losses '
        + ' '.join(f'{x:.4f}' for x in losses)
        + f'; {changed} of {len(before)} parameter tensors changed; launches per step '
        f'{expected}; median {med * 1e3:.3f} ms/step (first {times[0] * 1e3:.1f} ms); '
        f'peak allocated {peak:.3f} GiB on {card}')
    return launches


def second_inputs(cfg, synthetic, B: int, N: int, seed: int, device='cuda') -> dict:
    """A voxelized, map-prepared serving batch of a SECOND config."""
    from pdm_ssd_torch.models import get_host_prepare
    return get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG)(
        synthetic.voxel_batch(B, N, cfg, seed=seed, device=device))


def sparse_conv_check(name, sc, feats, nbr, w, plan=None) -> dict:
    """Kernel (through `plan`, or the plan it builds) and plain version each
    against float64, within the rounding of a float32 sum of K * Cin products
    (each at most 2^-24 of the sum of magnitudes); two kernel runs bit-equal;
    rows with no present tap exactly zero. Returns the taps present and the
    largest kernel-plain difference."""
    B, Vin, Cin = feats.shape
    K = nbr.shape[2]
    got = sc.sparse_conv_cuda(feats, nbr, w, plan)
    torch.cuda.synchronize()
    again = sc.sparse_conv_cuda(feats, nbr, w, plan)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise SystemExit(f'[12 sparse conv] FAILED {name}: two runs of the kernel differ')
    want = sc.sparse_conv_plain(feats, nbr, w)
    exact = sc.sparse_conv_plain(feats.double(), nbr, w.double())
    mass = sc.sparse_conv_plain(feats.double().abs(), nbr, w.double().abs())
    tol = K * Cin * 2.0 ** -24 * mass + 1e-30
    worst = {}
    for label, t in (('kernel', got), ('plain', want)):
        ratio = (t.double() - exact).abs() / tol
        worst[label] = float(ratio.max())
        if not bool((ratio <= 1.0).all()):
            raise SystemExit(f'[12 sparse conv] FAILED {name}: {label} differs from the float64 '
                             f'evaluation by {worst[label]:.3f} of the rounding bound')
    present = (nbr >= 0) & (nbr < Vin)
    empty = ~present.any(dim=2)
    if bool(got[empty].any()):
        raise SystemExit(f'[12 sparse conv] FAILED {name}: a row with no present tap is not 0')
    return {'present': int(present.sum()), 'empty_rows': int(empty.sum()),
            'err': float((got - want).abs().max()), 'worst': worst}


# most operations the kernel may compute over those of the present taps,
# over the ladder's twelve layers (each weighted by its Cin * Cout)
SPARSE_WORK_LIMIT = 1.6


def sparse_conv_phase(net, inputs, sc, smi: str) -> dict:
    """Returns the kernel's totals over the ladder's twelve layers (the
    launches of one predict), each through the plan its forward built."""
    from pdm_ssd_torch.models.backbones_3d.sparse_backbone import SparseConvBNReLU
    bb = net.backbone_3d
    calls = {}
    hooks = [m.register_forward_pre_hook(lambda mod, args, name=name: calls.setdefault(name, args))
             for name, m in bb.named_modules() if isinstance(m, SparseConvBNReLU)]
    with torch.inference_mode():
        bb(net.vfe(dict(inputs)))
    for h in hooks:
        h.remove()
    modules = dict(bb.named_modules())
    if len(calls) != 12:
        raise SystemExit(f'[12 sparse conv] FAILED: the ladder has {len(calls)} layers, not 12')
    total = {'err': 0.0, 'ms': 0.0, 'host_us': 0.0, 'call_ms': 0.0, 'plain_ms': 0.0,
             'library_ms': 0.0, 'library_host_us': 0.0, 'bytes': 0, 'flops': 0, 'walk_bytes': 0,
             'computed_flops': 0, 'plan_ms': 0.0}
    planned = set()        # maps whose plan build is timed: each once, as a forward builds it
    with torch.inference_mode():
        for name, (feats, nbr, _, plan) in calls.items():
            w = modules[name].kernel.detach()
            feats, nbr = feats.contiguous(), nbr.contiguous()
            B, Vin, Cin = feats.shape
            Vout, K = nbr.shape[1], nbr.shape[2]
            Cout = w.shape[1]
            if not isinstance(plan, sc.SparseConvPlan) or plan.vin != Vin:
                raise SystemExit(f'[12 sparse conv] FAILED {name}: the forward handed it no plan '
                                 'of its map')
            r = sparse_conv_check(name, sc, feats, nbr, w, plan)
            computed, present = (int(x) for x in sc.plan_work(plan, nbr))
            if id(plan) not in planned:
                planned.add(id(plan))
                plan_t = device_time(lambda: sc.sparse_conv_plan(nbr, Vin))
                total['plan_ms'] += plan_t['ms']
                plan_note = (f'plan built {plan_t["ms"]:.4f} ms device, '
                             f'{plan_t["host_us"]:.1f} us host')
            else:
                plan_note = 'plan shared with the layer before'
            k_t = device_time(lambda: sc.sparse_conv_cuda(feats, nbr, w, plan))
            ms = k_t['ms']
            plain_ms = median_ms(lambda: sc.sparse_conv_plain(feats, nbr, w), 5)
            pair_t = device_time(lambda: torch.matmul(sc.gather_taps(feats, nbr), w))
            pair_ms = pair_t['ms']
            byts = (feats.numel() + nbr.numel() + w.numel() + B * Vout * Cout) * 4
            flops = 2 * r['present'] * Cin * Cout
            # what the kernel moves: the rows it gathers, its map, its outputs
            # and, per tile, the rows of W of the tile's taps
            walk = (r['present'] * Cin + nbr.numel() + B * Vout * Cout
                    + computed // sc.TILE_ROWS * Cin * Cout) * 4
            total['err'] = max(total['err'], r['err'])
            for key, v in (('ms', ms), ('host_us', k_t['host_us']), ('call_ms', k_t['call_ms']),
                           ('plain_ms', plain_ms), ('library_ms', pair_ms),
                           ('library_host_us', pair_t['host_us']), ('bytes', byts),
                           ('flops', flops), ('walk_bytes', walk),
                           ('computed_flops', 2 * computed * Cin * Cout)):
                total[key] += v
            log('12 sparse conv', f'{name} {Cin}->{Cout} K={K} Vin={Vin} Vout={Vout} B={B}: '
                f'{r["present"] / nbr.numel():.3f} of taps present, {r["empty_rows"]} rows with '
                f'none; taps computed / present {computed / max(present, 1):.3f} ({plan_note}); '
                f'kernel {r["worst"]["kernel"]:.3f} and plain {r["worst"]["plain"]:.3f} of the '
                f'rounding bound from float64, kernel vs plain max |diff| {r["err"]:.2e}, two '
                f'runs bit-equal; ms kernel/plain/gather+matmul {ms:.3f}/{plain_ms:.3f}/'
                f'{pair_ms:.3f}, {2 * computed * Cin * Cout / ms / 1e9:.2f} TFLOP/s computed; '
                f'bound bytes {byts / HBM_BYTES_PER_S * 1e3:.4f} ms, operations '
                f'{flops / FP32_FLOP_PER_S * 1e3:.4f} ms')
        work = total['computed_flops'] / total['flops']
        if work > SPARSE_WORK_LIMIT:
            raise SystemExit(f'[12 sparse conv] FAILED: the kernel computes {work:.3f} times the '
                             f'operations of the present taps, more than {SPARSE_WORK_LIMIT}')
        # the TPU microbench's layer: V = 52224, C = 64, K = 27, its make_maps
        rng = np.random.default_rng(0)
        V, C, K = 52224, 64, 27
        idx = np.clip(np.arange(V)[:, None] + rng.integers(-40, 40, size=(1, K))
                      + rng.integers(-8, 8, size=(V, K)), 0, V - 1)
        idx[rng.random((V, K)) < 0.10] = V
        feats = torch.from_numpy(rng.standard_normal((1, V, C)).astype(np.float32)).cuda()
        nbr = torch.from_numpy(idx.astype(np.int32))[None].cuda()
        w = torch.from_numpy((rng.standard_normal((K * C, C)) * 0.02).astype(np.float32)).cuda()
        plan = sc.sparse_conv_plan(nbr, V)
        r = sparse_conv_check('microbench shape', sc, feats, nbr, w, plan)
        ms = device_time(lambda: sc.sparse_conv_cuda(feats, nbr, w, plan))['ms']
        plain_ms = median_ms(lambda: sc.sparse_conv_plain(feats, nbr, w), 5)
        log('12 sparse conv', f'microbench shape V={V} C={C} K={K}: kernel {r["worst"]["kernel"]:.3f} '
            f'and plain {r["worst"]["plain"]:.3f} of the rounding bound; kernel {ms:.3f} ms, plain '
            f'{plain_ms:.3f} ms, {2 * r["present"] * C * C / ms / 1e9:.2f} TFLOP/s on {smi}')
        # ragged: a row count that is no multiple of the tile, odd widths,
        # entries on both sides of [0, Vin), whole rows absent
        for B, Vin, Vout, K, Cin, Cout in ((3, 1000, 1001, 27, 7, 100), (2, 301, 1, 3, 5, 3),
                                          (2, 5000, 4999, 27, 4, 16)):
            idx = rng.integers(0, Vin, size=(B, Vout, K))
            idx[rng.random((B, Vout, K)) < 0.5] = Vin
            idx[:, ::5] = Vin
            idx[:, -1, 0] = -1
            r = sparse_conv_check(
                'ragged', sc,
                torch.from_numpy(rng.standard_normal((B, Vin, Cin)).astype(np.float32)).cuda(),
                torch.from_numpy(idx.astype(np.int32)).cuda(),
                torch.from_numpy(rng.standard_normal((K * Cin, Cout)).astype(np.float32)).cuda())
            log('12 sparse conv', f'ragged B={B} Vin={Vin} Vout={Vout} K={K} {Cin}->{Cout}: within '
                f'the rounding bound ({r["worst"]["kernel"]:.3f}), {r["empty_rows"]} rows with no '
                'present tap exactly 0, two runs bit-equal')
    t_bytes = total['bytes'] / HBM_BYTES_PER_S * 1e3
    t_ops = total['flops'] / FP32_FLOP_PER_S * 1e3
    stats = {'max_abs_err': total['err'], 'ms': total['ms'], 'host_us': total['host_us'],
             'call_ms': total['call_ms'], 'plain_ms': total['plain_ms'],
             'bound_ms': max(t_bytes, t_ops),
             'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
             'library_ms': total['library_ms'], 'library_host_us': total['library_host_us'],
             'walk_ms': total['walk_bytes'] / HBM_BYTES_PER_S * 1e3, 'plan_ms': total['plan_ms'],
             'work_ratio': total['computed_flops'] / total['flops']}
    log('12 sparse conv', f'twelve layers at B=4: kernel {stats["ms"]:.3f} ms device, '
        f'{stats["host_us"]:.1f} us host, {stats["call_ms"]:.3f} ms one call each; the 8 plans '
        f'{stats["plan_ms"]:.4f} ms device; operations computed / present '
        f'{stats["work_ratio"]:.3f} ({total["computed_flops"] / 1e9:.2f} of '
        f'{total["flops"] / 1e9:.2f} GFLOP, {total["computed_flops"] / stats["ms"] / 1e9:.2f} '
        f'TFLOP/s computed); plain torch '
        f'{stats["plain_ms"]:.3f} ms (one call), gather + torch.matmul (two calls, no single '
        f'PyTorch call computes the function) {stats["library_ms"]:.3f} ms device, bound '
        f'{stats["bound_ms"]:.4f} ms by {stats["bound_by"]} (bytes {t_bytes:.4f} ms, '
        f'{total["flops"] / 1e9:.2f} GFLOP of present taps {t_ops:.4f} ms); the rows the kernel '
        f'gathers, its maps, outputs and per-tile weights are {stats["walk_ms"]:.4f} ms of bytes')
    return stats


def gather_bf16_phase(inputs, group, smi: str) -> dict:
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.standard_normal((1, 52000, 96)).astype(np.float32)).cuda() \
        .to(torch.bfloat16)
    idx = torch.from_numpy(rng.integers(0, 52000, size=(1, 52000)).astype(np.int32)).cuda()
    got = group.gather_rows_cuda(table, idx)
    torch.cuda.synchronize()
    want = group.gather_rows_plain(table, idx)
    err = float((got.float() - want.float()).abs().max())
    if not torch.equal(got, want):
        raise SystemExit('[13 bf16 gather] FAILED: (52000, 96) bf16 rows differ from the plain '
                         'gather')
    repeats = 52000 - int(torch.unique(idx).numel())
    feats = inputs['voxels'][:, :, 0, :].contiguous()            # (4, 40000, 4) float32
    perm = inputs['sp_perm1']
    if not torch.equal(group.gather_rows_cuda(feats, perm), group.gather_rows_plain(feats, perm)):
        raise SystemExit('[13 bf16 gather] FAILED: the sp_perm1 reorder differs from the plain '
                         'gather')
    long_idx = idx[0].long()
    k_t = device_time(lambda: group.gather_rows_cuda(table, idx))
    lib_t = device_time(lambda: torch.index_select(table[0], 0, long_idx))
    stats = {'max_abs_err': err, 'ms': k_t['ms'], 'host_us': k_t['host_us'],
             'call_ms': k_t['call_ms'],
             'plain_ms': median_ms(lambda: group.gather_rows_plain(table, idx), 5),
             'library_ms': lib_t['ms'], 'library_host_us': lib_t['host_us'],
             'bound_ms': (2 * table.numel() * 2 + idx.numel() * 4) / HBM_BYTES_PER_S * 1e3,
             'bound_by': 'bytes'}
    perm_t = device_time(lambda: group.gather_rows_cuda(feats, perm))
    perm_lib = device_time(lambda: torch.gather(
        feats, 1, perm.long().clamp(0, feats.shape[1] - 1)[..., None].expand(-1, -1, 4)))
    log('13 bf16 gather', f'(52000, 96) bf16, {repeats} repeated indices: kernel == plain '
        f'(exact, max |diff| {err:g}); kernel {timing_note(k_t)}; torch.index_select '
        f'{timing_note(lib_t)}; plain torch {stats["plain_ms"]:.4f} ms (one call); bound '
        f'{stats["bound_ms"]:.5f} ms by bytes; the sp_perm1 reorder {tuple(feats.shape)} float32: '
        f'exact, kernel {timing_note(perm_t)}; torch.gather {timing_note(perm_lib)} on {smi}')
    return stats


def match_detections(got: dict, want: dict, phase: str) -> str:
    """Kept boxes of two runs, matched by box and label, held as the ROIs of
    phase 10 are: near-tied scores permute slots, so both runs must keep the
    same number of boxes in every cloud, each box of the CPU run is paired
    with the nearest of the CUDA run, at least ROI_MATCH_SHARE of them must
    have a twin within ROI_MATCH_ATOL with the same label, and at most
    ROI_UNMATCHED_PER_CLOUD of a cloud may lack one."""
    kept_g, kept_w = got['pred_mask'].sum(dim=1), want['pred_mask'].sum(dim=1)
    if not torch.equal(kept_g, kept_w):
        raise SystemExit(f'[{phase}] FAILED: boxes kept per cloud {kept_g.tolist()} on CUDA, '
                         f'{kept_w.tolist()} on the CPU')
    n_want = n_pairs = 0
    for b in range(want['pred_boxes'].shape[0]):
        w_slots, g_slots = want['pred_mask'][b], got['pred_mask'][b]
        w, g = want['pred_boxes'][b][w_slots], got['pred_boxes'][b][g_slots]
        if len(w) == 0:
            continue
        near, twin = (w[:, None] - g[None]).abs().amax(-1).min(dim=1)
        same = want['pred_labels'][b][w_slots] == got['pred_labels'][b][g_slots][twin]
        paired = (near <= ROI_MATCH_ATOL) & same
        if len(set(twin[paired].tolist())) != int(paired.sum()):
            raise SystemExit(f'[{phase}] FAILED: two boxes of the CPU run match one of the CUDA '
                             'run')
        if len(w) - int(paired.sum()) > ROI_UNMATCHED_PER_CLOUD:
            raise SystemExit(f'[{phase}] FAILED: cloud {b}: {len(w) - int(paired.sum())} of '
                             f'{len(w)} boxes of the CPU run have no twin in the CUDA run (at '
                             f'most {ROI_UNMATCHED_PER_CLOUD})')
        n_want += len(w)
        n_pairs += int(paired.sum())
    if n_want == 0 or n_pairs < ROI_MATCH_SHARE * n_want:
        raise SystemExit(f'[{phase}] FAILED: {n_pairs} of {n_want} boxes of the CPU run have a '
                         'twin in the CUDA run')
    return (f'{kept_w.tolist()} boxes kept per cloud in both runs, {n_pairs} of {n_want} have a '
            'twin by box and label')


def second_cuda_vs_cpu_phase(cfg, synthetic) -> None:
    from pdm_ssd_torch.ops.sparse_maps import LADDER_KEYS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = '14 second cuda-vs-cpu'
    cpu_in = second_inputs(cfg, synthetic, 2, 600, seed=4, device='cpu')
    gpu_in = second_inputs(cfg, synthetic, 2, 600, seed=4, device='cuda')
    for k in ('voxels', 'voxel_coords', 'voxel_num_points', 'voxel_mask', *LADDER_KEYS):
        if not torch.equal(gpu_in[k].cpu(), cpu_in[k]):
            raise SystemExit(f'[{phase}] FAILED: {k} built on CUDA differs from the CPU\'s')
    cpu_net = synthetic.open_score_gate(synthetic.random_model(cfg, 'cpu'))
    gpu_net = synthetic.random_model(cfg, 'cuda')
    gpu_net.load_state_dict(cpu_net.state_dict())
    with torch.inference_mode():
        want = cpu_net(cpu_in)
        got = gpu_net(gpu_in)
    worst = 0.0
    keys = ('voxel_features', 'spatial_features', 'spatial_features_2d', 'anchor_cls_preds',
            'anchor_box_preds', 'anchor_dir_preds')
    for k in keys:
        w, g = want[k], got[k].cpu()
        rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-6)
        worst = max(worst, rel)
        if not rel <= FWD_RTOL:
            raise SystemExit(f'[{phase}] FAILED {k}: max |diff| / max |cpu| = {rel:.3e}')
    note = match_detections({k: v.cpu() for k, v in gpu_net.predict(gpu_in).items()},
                            cpu_net.predict(cpu_in), phase)
    log(phase, f'tiny SECOND B=2: voxelizer and {len(LADDER_KEYS)} map tensors equal, '
        f'{len(keys)} outputs agree, worst max|diff|/max|cpu| = {worst:.3e} (bound {FWD_RTOL:g}); '
        f'{note}')


def second_predict_phase(cfg, net, inputs, wrappers, synthetic, card: str) -> dict:
    from pdm_ssd_torch.models import get_host_prepare
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = '15 second predict'
    B = inputs['voxels'].shape[0]
    caps = [inputs[k].shape[1] for k in ('sp_mask1', 'sp_mask2', 'sp_mask3', 'sp_mask4',
                                         'sp_mask_out')]
    sites = inputs['sp_sites']                                    # (B, 5), on the CPU
    dropped = (sites - torch.tensor(caps)).clamp(min=0)
    log(phase, f'caps {caps}; sites per stage and cloud {sites.tolist()}; dropped '
        f'{dropped.tolist()}')
    if int(sites[:, 0].min()) < SECOND_MIN_VOXELS:
        raise SystemExit(f'[{phase}] FAILED: a cloud fills {int(sites[:, 0].min())} of the '
                         f'{caps[0]} voxel slots, fewer than {SECOND_MIN_VOXELS}')
    if bool((dropped.float() > SECOND_MAX_DROP * sites.float()).any()):
        raise SystemExit(f'[{phase}] FAILED: a stage drops more than {SECOND_MAX_DROP:.0%} of '
                         'its sites')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(wrappers)
    det = net.predict(inputs)
    torch.cuda.synchronize()
    launches = read_launches(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_detections(phase, det, B)
    if launches != SECOND_PREDICT_LAUNCHES:
        raise SystemExit(f'[{phase}] FAILED: kernel launches {launches}, expected '
                         f'{SECOND_PREDICT_LAUNCHES}')
    width = net.backbone_3d.num_bev_features
    if width != 256 or tuple(net.backbone_3d.shapes[4]) != (2, 200, 176):
        raise SystemExit(f'[{phase}] FAILED: BEV width {width}, shape {net.backbone_3d.shapes[4]}')
    prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG)
    pts = inputs['points']
    proc = synthetic.voxel_processor(cfg)
    from pdm_ssd_torch.ops.voxelize import voxelize_batch

    def from_points() -> tuple[float, float]:
        """Seconds of voxelizer + map build, then of predict, in one pass."""
        t0 = time.perf_counter()
        batch = prepare(voxelize_batch(pts, cfg.DATA_CONFIG.POINT_CLOUD_RANGE,
                                       list(proc.VOXEL_SIZE), int(proc.MAX_POINTS_PER_VOXEL),
                                       int(proc.MAX_NUMBER_OF_VOXELS['test'])))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        net.predict(batch)
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    # both parts are timed inside each repetition, so their sum and their
    # difference are of one pass and not of two medians taken apart
    for _ in range(2):
        from_points()
    reps = [from_points() for _ in range(5)]
    prep = statistics.median(r[0] for r in reps)
    prepared = statistics.median(r[1] for r in reps)
    whole = statistics.median(sum(r) for r in reps)
    spread = [min(r[1] for r in reps), max(r[1] for r in reps)]
    log(phase, f'{cfg.MODEL.NAME} as shipped B={B} V={caps[0]} ({SECOND_POINTS} points per '
        f'cloud, BEV input width {width}): shapes ok, finite, {int(det["pred_mask"].sum())} kept '
        f'boxes, launches {launches}; 5 passes, each timed in two parts: voxelizer + map build '
        f'median {prep * 1e3:.3f} ms, predict on the prepared batch median {prepared * 1e3:.3f} '
        f'ms/batch = {B / prepared:.2f} frames/s (least {spread[0] * 1e3:.3f}, most '
        f'{spread[1] * 1e3:.3f} ms), from points (both) median {whole * 1e3:.3f} ms/batch = '
        f'{B / whole:.2f} frames/s; peak allocated {peak:.3f} GiB on {card}')
    return launches


# the mini-KITTI set of phases 16 and 17: the port's generator's defaults
KITTI_FRAMES = 64
KITTI_DIR = REPO / 'build' / 'chip_smoke_kitti'
# frames of the CUDA-vs-CPU eval loop of phase 16
EVAL_CPU_FRAMES = 8


def kitti_cfg(root: Path, num_points: int = 16384, cfg_file: str = CFG):
    """A config as shipped (default the flagship), reading the mini set at
    `root` with `num_points` points a cloud."""
    from pdm_ssd_torch.utils.config import cfg_from_yaml_file
    cfg = cfg_from_yaml_file(str(REPO / cfg_file))
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == 'sample_points':
            proc.NUM_POINTS = {'train': num_points, 'test': num_points}
    return cfg


def r40_note(ret: dict) -> str:
    return ', '.join(f'{c} 3d/bev R40 mod {ret[f"{c}_3d/moderate_R40"]:.4f}/'
                     f'{ret[f"{c}_bev/moderate_R40"]:.4f}'
                     for c in ('Car', 'Pedestrian', 'Cyclist'))


def check_eval(phase: str, ret: dict) -> None:
    """Recall and every AP R40 entry present and finite."""
    keys = [k for k in ret if k.startswith('recall/') or k.endswith('_R40')]
    if len(keys) < 3 + 3 * 9 or not all(np.isfinite(float(ret[k])) for k in keys):
        raise SystemExit(f'[{phase}] FAILED: recall / AP R40 missing or not finite: '
                         f'{ {k: ret[k] for k in keys} }')


def annos_as_detections(annos: list, class_names: list) -> dict:
    """KITTI det annos of a loop -> the padded layout `match_detections` reads."""
    P = max([len(a['name']) for a in annos] + [1])
    F = len(annos)
    out = {'pred_boxes': torch.zeros(F, P, 7), 'pred_labels': torch.zeros(F, P, dtype=torch.long),
           'pred_mask': torch.zeros(F, P, dtype=torch.bool)}
    for f, a in enumerate(annos):
        n = len(a['name'])
        out['pred_boxes'][f, :n] = torch.from_numpy(np.asarray(a['boxes_lidar'], np.float32))
        out['pred_labels'][f, :n] = torch.tensor([class_names.index(c) + 1 for c in a['name']],
                                                 dtype=torch.long)
        out['pred_mask'][f, :n] = True
    return out


def mini_kitti() -> Path:
    """The mini-KITTI set of the loop phases, generated on first use."""
    from pdm_ssd_torch.tools.make_mini_kitti import make
    if not (KITTI_DIR / 'kitti_infos_val.pkl').exists():
        t0 = time.perf_counter()
        make(KITTI_DIR, frames=KITTI_FRAMES)
        log('16 kitti eval', f'mini-KITTI: {KITTI_FRAMES} frames, 3 classes, generated with its '
            f'infos and GT database in {time.perf_counter() - t0:.1f} s')
    return KITTI_DIR


def kitti_eval_phase(wrappers, synthetic, card: str, cfg_file: str = CFG,
                     phase: str = '16 kitti eval', expected: dict = PREDICT_LAUNCHES,
                     adjust=None, cpu_check: bool = True) -> dict:
    """Phase 16 (and 22 for the grid config): `eval_one_epoch` of a config as
    shipped, seeded weights (`adjust` done to the model), at B=8 over the
    val split, then, with `cpu_check`, CUDA against the CPU at B=2 N=4096
    over 8 frames. Returns the launches of the B=8 eval loop."""
    from pdm_ssd_torch.datasets import build_dataloader
    from pdm_ssd_torch.runtime.eval_utils import eval_one_epoch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = mini_kitti()
    tag = Path(cfg_file).stem
    cfg = kitti_cfg(root, cfg_file=cfg_file)
    B = 8
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, B, root_path=root,
                                     workers=0, training=False)
    net = synthetic.random_model(cfg, 'cuda', seed=7)
    if adjust is not None:
        adjust(net)
    np.random.seed(0)
    reset_launches(wrappers)
    ret = eval_one_epoch(net, loader, ds, cfg.CLASS_NAMES, device='cuda',
                         result_dir=root / f'eval_b8_{tag}')
    launches = read_launches(wrappers)
    want = {k: v * len(loader) for k, v in expected.items()}
    if launches != want:
        raise SystemExit(f'[{phase}] FAILED: kernel launches {launches} over {len(loader)} '
                         f'batches, expected {want}')
    check_eval(phase, ret)
    annos = pickle.loads((root / f'eval_b8_{tag}' / 'result.pkl').read_bytes())
    n_det = sum(len(a['name']) for a in annos)
    log(phase, f'{tag}.yaml as shipped, seeded weights, B={B} N=16384 over {len(ds)} val frames '
        f'({len(loader)} batches): {n_det} detections; recall@0.3/0.5/0.7 '
        f'{ret["recall/rcnn_0.3"]:.4f}/{ret["recall/rcnn_0.5"]:.4f}/{ret["recall/rcnn_0.7"]:.4f}; '
        f'{r40_note(ret)}; predict alone {ret["infer_fps"]:.2f} frames/s, the loop with loading '
        f'{ret["loop_fps"]:.2f} frames/s; launches {launches} on {card}')

    if not cpu_check:
        return launches
    small = kitti_cfg(root, 4096, cfg_file=cfg_file)
    ds, loader, _ = build_dataloader(small.DATA_CONFIG, small.CLASS_NAMES, 2, root_path=root,
                                     workers=0, training=False)
    ds.kitti_infos = ds.kitti_infos[:EVAL_CPU_FRAMES]
    cpu_net = synthetic.random_model(small, 'cpu', seed=7)
    gpu_net = synthetic.random_model(small, 'cuda', seed=7)
    gpu_net.load_state_dict(cpu_net.state_dict())
    annos, rets = {}, {}
    for dev, model in (('cpu', cpu_net), ('cuda', gpu_net)):
        np.random.seed(1)
        rets[dev] = eval_one_epoch(model, loader, ds, small.CLASS_NAMES, device=dev,
                                   result_dir=root / f'eval_{dev}_{tag}')
        annos[dev] = pickle.loads((root / f'eval_{dev}_{tag}' / 'result.pkl').read_bytes())
    note = match_detections(annos_as_detections(annos['cuda'], small.CLASS_NAMES),
                            annos_as_detections(annos['cpu'], small.CLASS_NAMES), phase)
    log(phase, f'B=2 N=4096 over {EVAL_CPU_FRAMES} frames, CUDA vs CPU: {note}; Car 3d R40 mod '
        f'{rets["cuda"]["Car_3d/moderate_R40"]:.4f} on CUDA, '
        f'{rets["cpu"]["Car_3d/moderate_R40"]:.4f} on the CPU')
    return launches


def train_loop_phase(wrappers, synthetic, card: str, cfg_file: str = CFG,
                     phase: str = '17 train loop', expected: dict = TRAIN_LAUNCHES) -> dict:
    """Phase 17 (and 23 for the grid config). Returns the launches of the two
    training epochs."""
    from pdm_ssd_torch.datasets import build_dataloader
    from pdm_ssd_torch.runtime import trainer
    from pdm_ssd_torch.runtime.eval_utils import eval_one_epoch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = Path(cfg_file).stem
    cfg = kitti_cfg(mini_kitti(), cfg_file=cfg_file)
    B, epochs = 8, 2
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, B, root_path=KITTI_DIR,
                                     workers=0, training=True, seed=0)
    ckpt_dir = KITTI_DIR / f'ckpt_{tag}'
    net = synthetic.random_model(cfg, 'cuda', seed=7)
    optimizer, sched = trainer.create_train_state(net, cfg.OPTIMIZATION, len(loader), epochs)
    np.random.seed(0)
    torch.manual_seed(0)
    torch.cuda.synchronize()
    reset_launches(wrappers)
    t0 = time.perf_counter()
    losses = trainer.train_model(net, optimizer, sched, loader, 1, ckpt_dir=ckpt_dir,
                                 max_ckpt_save_num=1)
    names = [c.name for c in trainer.list_checkpoints(ckpt_dir)]
    if names != ['checkpoint_epoch_1.pth']:
        raise SystemExit(f'[{phase}] FAILED: checkpoints after epoch 1: {names}')
    fresh = synthetic.random_model(cfg, 'cuda', seed=11)
    fresh_opt, _ = trainer.create_train_state(fresh, cfg.OPTIMIZATION, len(loader), epochs)
    start = trainer.resume(ckpt_dir, fresh, fresh_opt)
    same = all(torch.equal(p, q) for p, q in zip(net.parameters(), fresh.parameters())) and all(
        torch.equal(b, c) for b, c in zip(net.buffers(), fresh.buffers())) and all(
        torch.equal(optimizer.optimizer.state[p][m], fresh_opt.optimizer.state[q][m])
        for p, q in zip(net.parameters(), fresh.parameters()) for m in ('exp_avg', 'exp_avg_sq'))
    if start != 1 or fresh_opt.count != optimizer.count or not same:
        raise SystemExit(f'[{phase}] FAILED: resume gave epoch {start}, iteration '
                         f'{fresh_opt.count} (want {optimizer.count}), state equal: {same}')
    losses += trainer.train_model(fresh, fresh_opt, sched, loader, epochs, ckpt_dir=ckpt_dir,
                                  max_ckpt_save_num=1, start_epoch=start)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(wrappers)
    steps = epochs * len(loader)
    want = {k: v * steps for k, v in expected.items()}
    names = [c.name for c in trainer.list_checkpoints(ckpt_dir)]
    if not all(np.isfinite(losses)) or names != [f'checkpoint_epoch_{epochs}.pth']:
        raise SystemExit(f'[{phase}] FAILED: losses {losses}, checkpoints {names}')
    if launches != want:
        raise SystemExit(f'[{phase}] FAILED: kernel launches {launches} over {steps} steps, '
                         f'expected {want}')
    log(phase, f'{tag}.yaml B={B} N=16384 over {len(ds)} train frames, {epochs} epochs of '
        f'{len(loader)} '
        f'steps (the second after a resume at epoch {start}, iteration '
        f'{fresh_opt.count - len(loader)}, moments and weights equal): mean losses '
        f'{" ".join(f"{x:.4f}" for x in losses)}; {seconds:.1f} s with loading; checkpoints '
        f'left {names}; launches {launches} on {card}')

    reloaded = synthetic.random_model(cfg, 'cuda', seed=13)
    trainer.load_checkpoint(ckpt_dir / names[-1], reloaded)
    vds, vloader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, B, root_path=KITTI_DIR,
                                       workers=0, training=False)
    np.random.seed(0)
    points = {'points': torch.from_numpy(next(iter(vloader))['points']).cuda()}
    # the PDM neck's index_add_ sums with atomics unless deterministic
    # algorithms are asked for
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        fresh.eval()
        with torch.inference_mode():
            want_fwd, got_fwd = flatten(fresh(points)), flatten(reloaded(points))
        want_det = fresh.predict(points)
        again = fresh.predict(points)
        got_det = reloaded.predict(points)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    repeat = all(torch.equal(again[k], want_det[k]) for k in want_det)
    differ = [k for k in want_fwd if not torch.equal(got_fwd[k], want_fwd[k])] + [
        k for k in want_det if not torch.equal(got_det[k], want_det[k])]
    if differ:
        raise SystemExit(f'[{phase}] FAILED: the reloaded model differs from the trained one in '
                         f'{differ} (the trained model repeats its predict bit for bit: {repeat})')
    np.random.seed(0)
    ret = eval_one_epoch(reloaded, vloader, vds, cfg.CLASS_NAMES, device='cuda',
                         result_dir=KITTI_DIR / f'eval_trained_{tag}')
    check_eval(phase, ret)
    log(phase, f'the checkpoint of epoch {epochs} reloaded, on the first val batch: its '
        f'{len(want_fwd)} forward outputs and its predict bit-equal to the trained model\'s '
        f'({int(want_det["pred_mask"].sum())} kept boxes; the trained model repeats its predict '
        f'bit for bit: {repeat}); its eval over {len(vds)} val frames: recall@0.3/0.5/0.7 '
        f'{ret["recall/rcnn_0.3"]:.4f}/{ret["recall/rcnn_0.5"]:.4f}/{ret["recall/rcnn_0.7"]:.4f}; '
        f'{r40_note(ret)} (no threshold); predict alone '
        f'{ret["infer_fps"]:.2f} frames/s, with loading {ret["loop_fps"]:.2f} frames/s')
    return launches


BENCH_KEYS = {'metric', 'value', 'unit', 'vs_baseline'}


def bench_phase(smi: str) -> None:
    """Phase 18: bench_torch.py as a subprocess, its one JSON line."""
    phase = '18 bench'
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(REPO / 'bench_torch.py')], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or len(lines) != 1:
        raise SystemExit(f'[{phase}] FAILED: rc {res.returncode}, stdout {res.stdout!r}, '
                         f'stderr {res.stderr[-2000:]!r}')
    out = json.loads(lines[0])
    if set(out) != BENCH_KEYS or not float(out['value']) > 0:
        raise SystemExit(f'[{phase}] FAILED: {lines[0]}')
    note = res.stderr.strip().splitlines()[-1] if res.stderr.strip() else ''
    log(phase, f'{lines[0]} on {smi} ({time.perf_counter() - t0:.1f} s with start-up; {note})')


def circle_nms_phase(synthetic) -> None:
    """Phase 19: `ops/iou3d.circle_nms` on the card against the CPU on the
    same candidates, slot order and keep mask equal: boxes on a 0.5 m
    lattice with repeated scores (ties, pairs at exactly the radius), and
    the flagship's candidate count at B=8 (800 boxes, PRE 256, POST 100)."""
    from pdm_ssd_torch.ops import iou3d
    rng = np.random.RandomState(9)
    cases = []
    for B, N, pre, post, radius, lattice in ((3, 60, 32, 16, 0.5, True),
                                              (3, 60, 80, 100, 1.0, True),
                                              (8, 800, 256, 100, 0.8, False)):
        boxes = np.zeros((B, N, 7), np.float32)
        if lattice:
            boxes[..., :2] = rng.randint(0, 8, (B, N, 2)) * 0.5
            scores = rng.randint(0, 6, (B, N)).astype(np.float32) / 8
        else:
            boxes[..., :2] = rng.uniform(0, 12, (B, N, 2))
            scores = rng.rand(B, N).astype(np.float32)
        valid = rng.rand(B, N) > 0.2
        args = [torch.from_numpy(a) for a in (boxes, scores, valid)]
        want = iou3d.circle_nms(args[0], args[1], radius, pre, post, args[2])
        got = iou3d.circle_nms(args[0].cuda(), args[1].cuda(), radius, pre, post,
                               args[2].cuda())
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            raise SystemExit(f'[19 grid cuda-vs-cpu] FAILED: circle_nms at B={B} N={N} '
                             f'PRE {pre} POST {post} differs between CUDA and the CPU')
        cases.append(f'B={B} N={N} PRE {pre} POST {post}: {int(want[1].sum())} kept')
    log('19 grid cuda-vs-cpu', 'circle_nms on CUDA == CPU (slot order and keep mask) at '
        + '; '.join(cases))


def grid_family_phases(wrappers, dispatch, synthetic, smi: str, CfgNode,
                       cfg_from_yaml_file) -> dict:
    """Phases 19 to 26: the rest of the KITTI PDM family. Returns the kernel
    launches of each path, by name."""
    def load(cfg_file):
        return cfg_from_yaml_file(str(REPO / cfg_file), CfgNode())

    gate = synthetic.open_score_gate
    cuda_vs_cpu_phase(synthetic.tiny_grid_cfg(load(GRID_CFG)), dispatch, synthetic,
                      phase='19 grid cuda-vs-cpu', fps_npoint=None, adjust=gate, predict=True)
    circle_nms_phase(synthetic)
    grid = load(GRID_CFG)
    paths = {'grid_predict': predict_phase(grid, wrappers, synthetic, smi, '20 grid predict',
                                           expected=NO_LAUNCHES, adjust=gate, profile=True),
             'grid_train': train_phase(grid, wrappers, synthetic, smi, '21 grid train',
                                       expected=NO_LAUNCHES)}
    # no CUDA-vs-CPU pass here (phase 19 holds the model and phase 19's
    # circle NMS check the NMS): with seeded weights and the heatmap bias at
    # 0, every empty cell of the full-size map scores the same, and float32
    # rounding of cuDNN's sums reorders those exact ties among the top-100
    # candidates (measured: 57 against 58 boxes kept in a frame)
    paths['grid_eval_loop'] = kitti_eval_phase(wrappers, synthetic, smi, GRID_CFG,
                                               '22 grid eval loop', NO_LAUNCHES, adjust=gate,
                                               cpu_check=False)
    paths['grid_train_loop'] = train_loop_phase(wrappers, synthetic, smi, GRID_CFG,
                                                '23 grid train loop', NO_LAUNCHES)
    paths['large_predict'] = predict_phase(
        load(LARGE_CFG), wrappers, synthetic, smi, '24 large predict', B=4,
        expected=NO_LAUNCHES, N=163840, points=synthetic.large_scene_points, adjust=gate,
        profile=True)
    paths['aux_train'] = train_phase(load(AUX_CFG), wrappers, synthetic, smi, '25 aux train')
    tiny = synthetic.tiny_flagship_cfg(load(CFG))
    tiny.MODEL.POST_PROCESSING.TTA_FLIP = ['y']
    cuda_vs_cpu_phase(tiny, dispatch, synthetic, phase='26 tta', fps_npoint=None, adjust=gate,
                      predict=True)
    tta = load(CFG)
    tta.MODEL.POST_PROCESSING.TTA_FLIP = ['y']
    paths['tta_predict'] = predict_phase(tta, wrappers, synthetic, smi, '26 tta',
                                         expected=TTA_PREDICT_LAUNCHES)
    return paths


KERNEL_TABLE = (
    ('farthest_point_sample', 'pdm_ssd_torch/csrc/fps.cu', 'pdm_ssd_tpu/ops/pallas/fps.py:60'),
    ('window_select', 'pdm_ssd_torch/csrc/group.cu',
     'pdm_ssd_tpu/ops/pallas/retired/grid_query.py:239'),
    ('gather_rows', 'pdm_ssd_torch/csrc/group.cu',
     'pdm_ssd_tpu/ops/pallas/retired/onehot_gather.py:146'),
    ('scatter_add_rows', 'pdm_ssd_torch/csrc/group.cu',
     'pdm_ssd_tpu/ops/pallas/retired/onehot_gather.py:226'),
    ('ball_query', 'pdm_ssd_torch/csrc/ball_query.cu',
     'pdm_ssd_tpu/ops/pallas/retired/grid_query.py:112'),
    ('sparse_conv', 'pdm_ssd_torch/csrc/sparse_conv.cu',
     'tools/microbench_sparse_gather.py:175, tools/microbench_sparse_gather2.py:94 and :182, '
     'tools/microbench_sparse_gather3.py:156'),
    ('gather_rows_bf16', 'pdm_ssd_torch/csrc/group.cu', 'tools/microbench_pallas_gather.py:66'),
)


def main() -> None:
    name, smi = device_check()
    sys.path.insert(0, str(REPO))
    from pdm_ssd_torch.ops import ball_query as bq
    from pdm_ssd_torch.ops import dispatch, fps, group, kernels, sa_fused
    from pdm_ssd_torch.ops import pointnet2 as plain
    from pdm_ssd_torch.ops import sparse_conv as sc
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
    # the row gather has two entry points, float32 and bfloat16, each with
    # its own counter on the one wrapper; FPS and the ball query count their
    # launches by path too
    wrappers = {'farthest_point_sample': (fps.farthest_point_sample_cuda, 'launches'),
                'window_select': (group.window_select_cuda, 'launches'),
                'gather_rows': (group.gather_rows_cuda, 'launches'),
                'scatter_add_rows': (group.scatter_add_rows_cuda, 'launches'),
                'ball_query': (bq.ball_query_cuda, 'launches'),
                'sparse_conv': (sc.sparse_conv_cuda, 'launches'),
                'gather_rows_bf16': (group.gather_rows_cuda, 'launches_bf16'),
                'fps cluster path': (fps.farthest_point_sample_cuda, 'launches_cluster'),
                'fps block path': (fps.farthest_point_sample_cuda, 'launches_block'),
                'ball query grid path': (bq.ball_query_cuda, 'launches_grid'),
                'ball query walk path': (bq.ball_query_cuda, 'launches_walk')}

    stats = {'farthest_point_sample': fps_phase(fps, plain, synthetic.kitti_points)}
    fps_stats = stats['farthest_point_sample']
    log('3 fps', f'(8, 16384) -> 4096: kernel {fps_stats.pop("note")}; plain torch '
        f'{fps_stats["plain_ms"]:.3f} ms (one call, median of 5), bound '
        f'{fps_stats["bound_ms"]:.4f} ms by {fps_stats["bound_by"]} on {smi}')

    os.chdir(REPO)   # the config names its base config relative to the repo
    cfg = cfg_from_yaml_file(str(REPO / CFG), CfgNode())
    cuda_vs_cpu_phase(cfg, dispatch, synthetic)
    predict_launches = predict_phase(cfg, wrappers, synthetic, smi)
    for kern, r in group_phase(cfg, fps, group, sa_fused, synthetic).items():
        stats[kern] = {'max_abs_err': r.pop('err'), **r, 'bound_by': 'bytes'}
    host_breakdown(group, kernels)
    grads_cuda_vs_cpu_phase(cfg, synthetic)
    train_launches = train_phase(cfg, wrappers, synthetic, smi)

    shipped = cfg_from_yaml_file(str(REPO / POINTRCNN_CFG), CfgNode())
    rcnn = synthetic.pointrcnn_fp3(cfg_from_yaml_file(str(REPO / POINTRCNN_CFG), CfgNode()))
    stats['ball_query'] = ball_query_phase(rcnn, bq, fps, plain, synthetic)
    small = synthetic.pointrcnn_fp3(cfg_from_yaml_file(str(REPO / POINTRCNN_CFG), CfgNode()))
    small.MODEL.BACKBONE_3D.SA_CONFIG.NPOINTS = [1024, 256, 64]
    cuda_vs_cpu_phase(small, dispatch, synthetic, phase='10 pointrcnn cuda-vs-cpu',
                      fps_npoint=256)
    rcnn_launches = predict_phase(rcnn, wrappers, synthetic, smi, phase='11 pointrcnn predict',
                                  B=rcnn.OPTIMIZATION.BATCH_SIZE_PER_GPU,
                                  expected=POINTRCNN_PREDICT_LAUNCHES)
    shipped_predict_phase(shipped, synthetic)

    second = cfg_from_yaml_file(str(REPO / SECOND_CFG), CfgNode())
    second_net = synthetic.open_score_gate(synthetic.random_model(second, 'cuda', seed=7))
    second_in = second_inputs(second, synthetic, second.OPTIMIZATION.BATCH_SIZE_PER_GPU,
                              SECOND_POINTS, seed=5)
    stats['sparse_conv'] = sparse_conv_phase(second_net, second_in, sc, smi)
    stats['gather_rows_bf16'] = gather_bf16_phase(second_in, group, smi)
    second_cuda_vs_cpu_phase(synthetic.tiny_second_cfg(
        cfg_from_yaml_file(str(REPO / SECOND_CFG), CfgNode())), synthetic)
    second_launches = second_predict_phase(second, second_net, second_in, wrappers, synthetic,
                                           smi)
    del second_net, second_in
    eval_launches = kitti_eval_phase(wrappers, synthetic, smi)
    train_loop_launches = train_loop_phase(wrappers, synthetic, smi)
    bench_phase(smi)

    new_paths = grid_family_phases(wrappers, dispatch, synthetic, smi, CfgNode,
                                   cfg_from_yaml_file)

    # `launches` is the count from the run of a main path: the flagship's five
    # training steps of phase 8 for its four kernels, PointRCNN's predict of
    # phase 11 for the ball query, SECOND's predict of phase 15 for the sparse
    # conv and for the row gather's bfloat16 entry point. Every count is of the
    # entry point it stands under: no model of the port keeps bfloat16 tables,
    # so the bfloat16 entry is launched by phase 13 alone and every path counts
    # 0 for it, while SECOND's predict launches the float32 entry once. The
    # grouping kernels' times, bounds and library times are sums over the
    # flagship's three SA levels (the launches of one forward, and of one
    # backward for the scatter-add), the ball query's over PointRCNN's three
    # backbone levels, the sparse conv's over SECOND's twelve layers; `walk_ms`
    # is the time of what a kernel's own walk does, at the peak rate, beside
    # the bound of what the function needs; `launches_eval_loop` and
    # `launches_train_loop` are the counts of phases 16 and 17, each set to 0
    # just before its loop, and the `launches_<path>` of phases 20 to 26 the
    # counts of those paths (each set to 0 just before it: the grid family's
    # predict, train step, eval and train loops and the large scene read 0 for
    # every kernel, the aux train step's 5 steps the flagship's step's four
    # kernels, TTA's predict twice the flagship's); the sparse conv's `library_ms` is
    # a pair of PyTorch calls (gather, `torch.matmul`), since no single call
    # computes it; `max_abs_err` is kernel against plain version
    main_path = {kern: train_launches for kern, _, _ in KERNEL_TABLE}
    main_path.update(ball_query=rcnn_launches, sparse_conv=second_launches,
                     gather_rows_bf16=second_launches)
    for kern in main_path:
        if kern != 'gather_rows_bf16' and main_path[kern][kern] < 1:
            raise SystemExit(f'[kernels] FAILED: {kern} was not launched on its main path')
    print(json.dumps({'kernels': [{
        'name': kern, 'route': 'cuda', 'source': source, 'replaces': replaces,
        'launches': main_path[kern][kern],
        'launches_per_predict': predict_launches[kern],
        'launches_per_pointrcnn_predict': rcnn_launches[kern],
        'launches_per_second_predict': second_launches[kern],
        'launches_eval_loop': eval_launches[kern],
        'launches_train_loop': train_loop_launches[kern],
        **{f'launches_{path}': launches[kern] for path, launches in new_paths.items()},
        **stats[kern]} for kern, source, replaces in KERNEL_TABLE]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
