"""Dry run of the port on one device: python3 -m pdm_ssd_torch.tools.dryrun

Builds the tiny point-exact flagship (the shrink of
`configs/kitti_models/pdm_ssd_point.yaml` in `utils/synthetic.tiny_flagship_cfg`),
takes one train step on a seeded synthetic batch and one predict, checks that
the loss is finite and the detections have the batch's size, and prints
`... OK, loss=...`. With `--cfg_file configs/kitti_models/pdm_ssd.yaml`,
`pdm_ssd_aux.yaml` or `pdm_ssd_large.yaml` it does the same on that config's
tiny shrink (`utils/synthetic.tiny_pdmssd_cfg`). With `--cfg_file
configs/kitti_models/pointrcnn.yaml` it
builds the tiny PointRCNN (`utils/synthetic.tiny_pointrcnn_cfg`), with
`configs/kitti_models/second_sparse.yaml` the tiny SECOND on the sparse voxel
ladder (`utils/synthetic.tiny_second_cfg`; its batch is voxelized and given
its kernel maps on the device). A model
whose training path is not ported yet raises `NotImplementedError` from its
train step; the dry run then checks its predict only. Runs on the card
unless `--device cpu` is given. The counterpart of
`__graft_entry__.dryrun_multichip` on one device.
"""
from __future__ import annotations

import argparse
import math
import os
from pathlib import Path

import torch

from ..models import build_network, get_host_prepare
from ..runtime.trainer import create_train_state, make_predict_step, make_train_step
from ..utils import synthetic
from ..utils.config import CfgNode, cfg_from_yaml_file

REPO = Path(__file__).resolve().parents[2]
CFG = 'configs/kitti_models/pdm_ssd_point.yaml'


def dryrun(device: str | None = None, B: int = 2, N: int = 512, seed: int = 0,
           cfg_file: str = CFG) -> float | None:
    """Returns the train step's loss, or None for a model that only predicts."""
    cwd = os.getcwd()
    os.chdir(REPO)   # the config names its base config relative to the repo
    try:
        cfg = cfg_from_yaml_file(str(REPO / cfg_file), CfgNode())
    finally:
        os.chdir(cwd)
    name = cfg.MODEL.NAME
    if name not in synthetic.TINY_CFGS:
        raise SystemExit(f'dryrun: no tiny version of {name}')
    cfg = synthetic.TINY_CFGS[name](cfg)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device=device,
                          seed=seed)
    dev = next(model.parameters()).device
    prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG)
    if prepare is None:
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in synthetic.kitti_batch(B, N, seed=seed).items()}
        inputs = {'points': batch['points']}
    else:           # a voxel model: voxelize on the device, then its kernel maps
        batch = inputs = prepare(synthetic.voxel_batch(B, N, cfg, seed=seed, device=dev))
    optimizer, _ = create_train_state(model, cfg.OPTIMIZATION, total_iters_each_epoch=10,
                                      total_epochs=2)
    try:
        loss = float(make_train_step(model, optimizer)(batch)['loss'])
    except NotImplementedError:     # the detector says its training path is not ported
        loss = None
    if loss is not None and not math.isfinite(loss):
        raise SystemExit(f'dryrun: loss is not finite: {loss}')
    dets = make_predict_step(model)(inputs)
    if dets['pred_boxes'].shape[0] != B or not bool(torch.isfinite(dets['pred_boxes']).all()):
        raise SystemExit(f'dryrun: {name} detections are not finite boxes for {B} clouds')
    if loss is None:
        print(f'dryrun({dev}): {name} predict OK, {int(dets["pred_mask"].sum())} boxes kept')
    else:
        print(f'dryrun({dev}): {name} train step + predict OK, loss={loss:.4f}')
    return loss


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default=None, help="'cpu' to run without a card "
                    '(default: the card; fails where CUDA is unavailable)')
    ap.add_argument('--batch', type=int, default=2)
    ap.add_argument('--points', type=int, default=512)
    ap.add_argument('--cfg_file', default=CFG, help='the flagship (default), or '
                    'configs/kitti_models/pdm_ssd.yaml, pdm_ssd_aux.yaml, pdm_ssd_large.yaml, '
                    'pointrcnn.yaml or second_sparse.yaml')
    args = ap.parse_args()
    dryrun(args.device, args.batch, args.points, cfg_file=args.cfg_file)


if __name__ == '__main__':
    main()
