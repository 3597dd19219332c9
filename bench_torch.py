"""Benchmark of the PyTorch port: PDM-SSD inference throughput on one NVIDIA
GPU (the counterpart of `bench.py`).

    python3 bench_torch.py [--device cuda|cpu]

Runs the flagship as shipped (`configs/kitti_models/pdm_ssd_point.yaml`,
`predict` with its post-processing) with seeded weights at B=8, N=16384, in
float32 with TF32 off, on the card. `bench.py` runs its float32 matmuls in
bf16 (`bench.py:41`); the port does not until the quality budget of ROADMAP
Queue 1 item 4 (the main-path AP gate) allows it.

Inputs: the first 8 velodyne frames of `data/kitti` when present, cropped to
the KITTI range and sampled to 16384 points as `bench.py` does, else the
seeded uniform clouds of `pdm_ssd_torch.utils.synthetic.kitti_points`.
Timing: a warm-up predict (which also builds the kernels), then the median
of 3 rounds of 20 predicts, each round ended by a synchronize.

Prints exactly one JSON line on stdout: {"metric", "value", "unit",
"vs_baseline"}, against the reference paper's 68 frames/s (`BASELINE.md`);
which inputs it read goes to stderr.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CFG = 'configs/kitti_models/pdm_ssd_point.yaml'
BASELINE_FPS = 68.0
BATCH, POINTS, ITERS, ROUNDS = 8, 16384, 20, 3


def kitti_frames(B: int, N: int) -> np.ndarray | None:
    """The first B velodyne frames of data/kitti, cropped and sampled to N
    points as `bench.py:49-58` does, or None when the set is absent."""
    velo = REPO / 'data/kitti/training/velodyne'
    bins = sorted(velo.glob('*.bin'))[:B] if velo.exists() else []
    if len(bins) < B:
        return None
    clouds = []
    for f in bins:
        p = np.fromfile(str(f), dtype=np.float32).reshape(-1, 4)
        p = p[(p[:, 0] >= 0) & (p[:, 0] <= 70.4) & (np.abs(p[:, 1]) <= 40)]
        idx = np.random.RandomState(0).choice(len(p), N, replace=len(p) < N)
        clouds.append(p[idx])
    return np.stack(clouds).astype(np.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; fails where CUDA is unavailable) or 'cpu'")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from pdm_ssd_torch.runtime.trainer import resolve_device
    from pdm_ssd_torch.utils import synthetic
    from pdm_ssd_torch.utils.config import cfg_from_yaml_file

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cwd = os.getcwd()
    os.chdir(REPO)      # the config names its base config relative to the repo
    try:
        cfg = cfg_from_yaml_file(str(REPO / CFG))
    finally:
        os.chdir(cwd)
    net = synthetic.random_model(cfg, device)
    points = kitti_frames(BATCH, POINTS)
    source = 'the first 8 frames of data/kitti'
    if points is None:
        points = synthetic.kitti_points(BATCH, POINTS, seed=0)
        source = 'seeded uniform clouds (no data/kitti)'
    print(f'bench_torch: {source}, B={BATCH} N={POINTS}, {device}', file=sys.stderr)
    batch = {'points': torch.from_numpy(points).to(device)}

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    net.predict(batch)                  # warm-up: builds and loads the kernels
    sync()
    rates = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            net.predict(batch)
        sync()
        rates.append(BATCH * ITERS / (time.perf_counter() - t0))
    fps = statistics.median(rates)
    result = {'metric': 'kitti_inference_frames_per_sec_per_chip', 'value': round(fps, 2),
              'unit': 'frames/s', 'vs_baseline': round(fps / BASELINE_FPS, 3)}
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
