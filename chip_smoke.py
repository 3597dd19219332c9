"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Phases (each prints one line; any failure ends the run with a non-zero exit):

1. device check: CUDA must be available; prints the card's name and
   `nvidia-smi` name and power limit;
2. builds the CUDA kernels from `pdm_ssd_torch/csrc/`;
3. FPS kernel against the plain PyTorch FPS on the card, exact index
   equality, at the flagship shape (8, 16384) -> 4096, on a tie-heavy cloud
   (duplicated grid points and a zero-padded tail) and at an odd N; times
   both (median of 5, CUDA events);
4. the flagship (`configs/kitti_models/pdm_ssd_point.yaml`, seeded random
   weights and BatchNorm statistics) at B=2, N=4096: forward on CUDA against
   the same model on the CPU, TF32 off;
5. the unmodified flagship's `predict` at B=8, N=16384: output shapes,
   finite values, FPS launches counted in that run, and frames/s (median of
   10 timed runs after warm-up).

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
    fps_mod.farthest_point_sample_cuda(x, 4096)
    ms = median_ms(lambda: fps_mod.farthest_point_sample_cuda(x, 4096), 5)
    plain_ms = median_ms(lambda: plain.farthest_point_sample(x, 4096), 5)
    return {'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms}


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


def predict_phase(cfg, fps_mod, synthetic, card: str) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = synthetic.random_model(cfg, 'cuda', seed=7)
    B, N = 8, 16384
    pts = torch.from_numpy(synthetic.kitti_points(B, N, 5)).cuda()
    fps_mod.farthest_point_sample_cuda.launches = 0
    det = net.predict({'points': pts})
    torch.cuda.synchronize()
    launches = fps_mod.farthest_point_sample_cuda.launches
    want = {'pred_boxes': (B, 100, 7), 'pred_scores': (B, 100), 'pred_labels': (B, 100),
            'pred_mask': (B, 100)}
    for k, shape in want.items():
        if tuple(det[k].shape) != shape:
            raise SystemExit(f'[5 predict] FAILED {k}: shape {tuple(det[k].shape)} != {shape}')
        if det[k].dtype.is_floating_point and not bool(torch.isfinite(det[k]).all()):
            raise SystemExit(f'[5 predict] FAILED {k}: non-finite values')
    if launches < 1:
        raise SystemExit('[5 predict] FAILED: predict did not launch the FPS kernel')
    for _ in range(3):
        net.predict({'points': pts})
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        net.predict({'points': pts})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log('5 predict', f'B={B} N={N}: shapes ok, finite, {int(det["pred_mask"].sum())} kept boxes, '
        f'FPS launches {launches}; median {med * 1e3:.3f} ms/batch = {B / med:.2f} frames/s '
        f'(10 runs) on {card}')
    return launches


def main() -> None:
    name, smi = device_check()
    sys.path.insert(0, str(REPO))
    from pdm_ssd_torch.ops import dispatch, fps, kernels
    from pdm_ssd_torch.ops import pointnet2 as plain
    from pdm_ssd_torch.utils import synthetic
    from pdm_ssd_torch.utils.config import CfgNode, cfg_from_yaml_file

    t0 = time.perf_counter()
    so = kernels.build()
    kernels.load()
    log('2 build', f'{so.name} in {time.perf_counter() - t0:.1f} s')
    for line in kernels.build_log.splitlines():
        if 'registers' in line or 'spill' in line:
            print(f'    {line.strip()}')

    fps_stats = fps_phase(fps, plain, synthetic.kitti_points)
    log('3 fps', f'(8, 16384) -> 4096: kernel {fps_stats["ms"]:.3f} ms, plain torch '
        f'{fps_stats["plain_ms"]:.3f} ms (median of 5) on {smi}')

    os.chdir(REPO)   # the config names its base config relative to the repo
    cfg = cfg_from_yaml_file(str(REPO / CFG), CfgNode())
    cuda_vs_cpu_phase(cfg, dispatch, synthetic)
    launches = predict_phase(cfg, fps, synthetic, smi)

    print(json.dumps({'kernels': [{
        'name': 'farthest_point_sample', 'route': 'cuda',
        'source': 'pdm_ssd_torch/csrc/fps.cu',
        'replaces': 'pdm_ssd_tpu/ops/pallas/fps.py:60',
        'launches': launches, 'max_abs_err': fps_stats['max_abs_err'],
        'ms': fps_stats['ms'], 'plain_ms': fps_stats['plain_ms']}]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
