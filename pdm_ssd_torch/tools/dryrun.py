"""Dry run of the port on one device: python3 -m pdm_ssd_torch.tools.dryrun

Builds the tiny point-exact flagship (the shrink of
`configs/kitti_models/pdm_ssd_point.yaml` in `utils/synthetic.tiny_flagship_cfg`),
takes one train step on a seeded synthetic batch and one predict, checks that
the loss is finite and the detections have the batch's size, and prints
`... OK, loss=...`. With `--cfg_file configs/kitti_models/pdm_ssd.yaml`,
`pdm_ssd_aux.yaml`, `pdm_ssd_large.yaml` or
`configs/nuscenes_models/pdm_ssd_nuscenes.yaml` (on nuScenes-like clouds of
5 features) it does the same on that config's tiny shrink
(`utils/synthetic.tiny_pdmssd_cfg`). With `--cfg_file
configs/kitti_models/pointrcnn.yaml` it
builds the tiny PointRCNN (`utils/synthetic.tiny_pointrcnn_cfg`), with
`configs/kitti_models/second_sparse.yaml` the tiny SECOND on the sparse voxel
ladder (`utils/synthetic.tiny_second_cfg`; its batches are voxelized and given
their kernel maps on the device, the training batch with 8 boxes a cloud and
the transposed maps), with `second_focal.yaml` the tiny SECOND on the focal
ladder, with `voxelnext.yaml` the tiny VoxelNeXt (the sparse ladder and its
BEV slot table), with `second.yaml` the tiny SECOND on the dense ladder,
with `pointpillar.yaml`, `centerpoint_pillar.yaml` or `pillarnet.yaml` the
tiny shrink of that file, with `pv_rcnn.yaml`, `pv_rcnn_sparse.yaml`,
`voxel_rcnn.yaml` or `voxel_rcnn_sparse.yaml` the tiny two-stage model on
the dense or sparse ladder, with `dsvt.yaml` or `transfusion.yaml` the
tiny window-attention or query-head model, with
`configs/waymo_models/mppnet_mini.yaml` or `mppnet_16frame.yaml` the tiny
MPPNet on the batches of a mini-Waymo set it generates in a temporary
directory, with `configs/nuscenes_models/bevfusion.yaml` or
`bevfusion_mini.yaml` the tiny BEVFusion on camera batches of two cameras
(`utils/synthetic.camera_batch`), with `--cfg_file caddn` the tiny CaDDN
(`utils/synthetic.caddn_kitti`, which no file holds, shrunk by
`tiny_caddn_cfg`) on batches of two 64 x 96 images with their depth maps
(`utils/synthetic.caddn_batch`) (`utils/synthetic.TINY_CFGS`; a config
that voxelizes its points gets voxel batches, made on the device).
Runs on the card unless `--device cpu` is given. The counterpart of
`__graft_entry__.dryrun_multichip` on one device.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
from pathlib import Path

import torch

from ..models import build_network, get_host_prepare
from ..runtime.trainer import create_train_state, make_predict_step, make_train_step
from ..utils import synthetic

REPO = Path(__file__).resolve().parents[2]
CFG = 'configs/kitti_models/pdm_ssd_point.yaml'


def dryrun(device: str | None = None, B: int = 2, N: int = 512, seed: int = 0,
           cfg_file: str = CFG) -> float:
    """Returns the train step's loss."""
    cwd = os.getcwd()
    os.chdir(REPO)   # the config names its base config relative to the repo
    try:
        cfg = synthetic.load_cfg(cfg_file)
    finally:
        os.chdir(cwd)
    name = cfg.MODEL.NAME
    if name not in synthetic.TINY_CFGS:
        raise SystemExit(f'dryrun: no tiny version of {name}')
    cfg = synthetic.TINY_CFGS[name](cfg)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device=device,
                          seed=seed, class_names=cfg.CLASS_NAMES)
    dev = next(model.parameters()).device
    prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG)
    if cfg.DATA_CONFIG.get('DATASET') == 'WaymoDataset':
        # a sequence model: batches of a mini-Waymo set generated for the run
        with tempfile.TemporaryDirectory() as root:
            train_set = synthetic.waymo_set(cfg, root, frames=B + 3, training=True, seed=seed)
            batch = synthetic.waymo_batch(train_set, range(3, 3 + B), dev)
            test_set = synthetic.waymo_set(cfg, root, frames=B + 3, seed=seed)
            inputs = synthetic.waymo_batch(test_set, range(3, 3 + B), dev)
    elif cfg.DATA_CONFIG.get('CAMERA_CONFIG') is not None:
        # a camera model: voxels and two cameras' images, depth maps and transforms
        batch = synthetic.camera_batch(B, N, cfg, seed=seed, n_cam=2, M=8, device=dev,
                                       mode='train', image_wh=(192, 128))
        inputs = synthetic.camera_batch(B, N, cfg, seed=seed, n_cam=2, device=dev,
                                        image_wh=(192, 128))
    elif name == 'CaDDN':
        # a monocular camera model: images, their transforms and depth maps
        batch = synthetic.caddn_batch(B, N, cfg, seed=seed, M=8, device=dev)
        inputs = synthetic.caddn_batch(B, N, cfg, seed=seed, device=dev)
    elif cfg.DATA_CONFIG.get('DATASET') == 'NuScenesDataset':
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in synthetic.nuscenes_batch(B, N, seed=seed).items()}
        inputs = {'points': batch['points']}
    elif not synthetic.voxelizes(cfg):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in synthetic.kitti_batch(B, N, seed=seed).items()}
        inputs = {'points': batch['points']}
    else:           # a voxel model: voxelize on the device, then any kernel maps
        batch = synthetic.voxel_train_batch(B, N, cfg, seed=seed, device=dev)
        inputs = synthetic.voxel_batch(B, N, cfg, seed=seed, device=dev)
        if prepare is not None:
            inputs = prepare(inputs)
    optimizer, _ = create_train_state(model, cfg.OPTIMIZATION, total_iters_each_epoch=10,
                                      total_epochs=2)
    train_prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG, training=True)
    loss = float(make_train_step(model, optimizer, train_prepare)(batch)['loss'])
    if not math.isfinite(loss):
        raise SystemExit(f'dryrun: loss is not finite: {loss}')
    dets = make_predict_step(model)(inputs)
    if dets['pred_boxes'].shape[0] != B or not bool(torch.isfinite(dets['pred_boxes']).all()):
        raise SystemExit(f'dryrun: {name} detections are not finite boxes for {B} clouds')
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
                    'pointrcnn.yaml, second_sparse.yaml, second_focal.yaml, voxelnext.yaml, '
                    'second.yaml, pointpillar.yaml, centerpoint_pillar.yaml, pillarnet.yaml, '
                    'pv_rcnn.yaml, pv_rcnn_sparse.yaml, voxel_rcnn.yaml, '
                    'voxel_rcnn_sparse.yaml, configs/nuscenes_models/pdm_ssd_nuscenes.yaml, '
                    'configs/nuscenes_models/bevfusion.yaml, '
                    'configs/waymo_models/mppnet_mini.yaml or caddn (a config no file holds)')
    args = ap.parse_args()
    dryrun(args.device, args.batch, args.points, cfg_file=args.cfg_file)


if __name__ == '__main__':
    main()
