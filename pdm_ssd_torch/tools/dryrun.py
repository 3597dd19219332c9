"""Dry run of the port on one device: python3 -m pdm_ssd_torch.tools.dryrun

Builds the tiny point-exact flagship (the shrink of
`configs/kitti_models/pdm_ssd_point.yaml` in `utils/synthetic.tiny_flagship_cfg`),
takes one train step on a seeded synthetic batch and one predict, checks that
the loss is finite and the detections have the batch's size, and prints
`... OK, loss=...`. Runs on the card unless `--device cpu` is given.
The counterpart of `__graft_entry__.dryrun_multichip` on one device.
"""
from __future__ import annotations

import argparse
import math
import os
from pathlib import Path

import torch

from ..models import build_network
from ..runtime.trainer import create_train_state, make_predict_step, make_train_step
from ..utils import synthetic
from ..utils.config import CfgNode, cfg_from_yaml_file

REPO = Path(__file__).resolve().parents[2]
CFG = 'configs/kitti_models/pdm_ssd_point.yaml'


def dryrun(device: str | None = None, B: int = 2, N: int = 512, seed: int = 0) -> float:
    cwd = os.getcwd()
    os.chdir(REPO)   # the config names its base config relative to the repo
    try:
        cfg = synthetic.tiny_flagship_cfg(cfg_from_yaml_file(str(REPO / CFG), CfgNode()))
    finally:
        os.chdir(cwd)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device=device,
                          seed=seed)
    dev = next(model.parameters()).device
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic.kitti_batch(B, N, seed=seed).items()}
    optimizer, _ = create_train_state(model, cfg.OPTIMIZATION, total_iters_each_epoch=10,
                                      total_epochs=2)
    metrics = make_train_step(model, optimizer)(batch)
    loss = float(metrics['loss'])
    if not math.isfinite(loss):
        raise SystemExit(f'dryrun: loss is not finite: {loss}')
    dets = make_predict_step(model)({'points': batch['points']})
    if dets['pred_boxes'].shape[0] != B:
        raise SystemExit(f'dryrun: detections for {dets["pred_boxes"].shape[0]} clouds, not {B}')
    print(f'dryrun({dev}): point-exact flagship train step + predict OK, loss={loss:.4f}')
    return loss


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default=None, help="'cpu' to run without a card "
                    '(default: the card; fails where CUDA is unavailable)')
    ap.add_argument('--batch', type=int, default=2)
    ap.add_argument('--points', type=int, default=512)
    args = ap.parse_args()
    dryrun(args.device, args.batch, args.points)


if __name__ == '__main__':
    main()
