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

With `--nprocs N` (the counterpart of `dryrun_multichip(N)` itself) it
spawns N ranks of a process group on localhost (`parallel.spawn`): gloo
with `--device cpu`; on the card NCCL with one card a rank where there are
N cards, else gloo with every rank on card 0. Each rank takes one train step
of the tiny flagship (`--cfg_file` is ignored) on its share of a seeded
global batch of `--batch` clouds (default 2 a rank) under DistributedDataParallel,
then one predict on its share. The loss must equal that of one process's
step on the whole batch (relative 1e-5), and it prints
`dryrun_multichip(N): ... OK, loss=...`.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
from pathlib import Path

import torch

from ..models import build_network, get_host_prepare
from ..parallel import ddp
from ..runtime.trainer import (create_train_state, make_predict_step, make_train_step,
                               resolve_device)
from ..utils import synthetic

REPO = Path(__file__).resolve().parents[2]
CFG = 'configs/kitti_models/pdm_ssd_point.yaml'


def tiny_cfg(cfg_file: str = CFG):
    """The tiny shrink (`utils/synthetic.TINY_CFGS`) of `cfg_file`."""
    cwd = os.getcwd()
    os.chdir(REPO)   # the config names its base config relative to the repo
    try:
        cfg = synthetic.load_cfg(cfg_file)
    finally:
        os.chdir(cwd)
    name = cfg.MODEL.NAME
    if name not in synthetic.TINY_CFGS:
        raise SystemExit(f'dryrun: no tiny version of {name}')
    return synthetic.TINY_CFGS[name](cfg)


def dry_batches(cfg, B: int, N: int, seed: int, dev) -> tuple:
    """(training batch, serving batch) of the config's kind on `dev`, seeded:
    a serving batch of a voxel model comes with its maps."""
    name = cfg.MODEL.NAME
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
    return batch, inputs


def dryrun(device: str | None = None, B: int = 2, N: int = 512, seed: int = 0,
           cfg_file: str = CFG) -> float:
    """Returns the train step's loss."""
    cfg = tiny_cfg(cfg_file)
    name = cfg.MODEL.NAME
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device=device,
                          seed=seed, class_names=cfg.CLASS_NAMES)
    dev = next(model.parameters()).device
    batch, inputs = dry_batches(cfg, B, N, seed, dev)
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


# the multi-rank step's loss against one process's on the same global batch:
# float32 sums in another order (measured 2e-7 on the CPU)
MULTI_RTOL = 1e-5


def _flagship_step(dev, B: int, N: int, seed: int, shard: bool) -> tuple:
    """The tiny flagship's train step on the global batch of `B` seeded
    clouds, or with `shard` on this rank's share of it under
    DistributedDataParallel, then a predict on the same clouds. Returns
    (loss, the detections' boxes)."""
    cfg = tiny_cfg(CFG)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device=dev,
                          seed=seed, class_names=cfg.CLASS_NAMES)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic.kitti_batch(B, N, seed=seed).items()}
    if shard:
        b = B // ddp.world_size()
        batch = {k: v[ddp.rank() * b:(ddp.rank() + 1) * b] for k, v in batch.items()}
    optimizer, _ = create_train_state(model, cfg.OPTIMIZATION, total_iters_each_epoch=10,
                                      total_epochs=2)
    step = make_train_step(ddp.wrap_model(model) if shard else model, optimizer)
    loss = float(step(batch)['loss'])
    dets = make_predict_step(model)({'points': batch['points']})
    return loss, dets['pred_boxes']


def _rank_dryrun(dev, B: int, N: int, seed: int, out: str) -> None:
    loss, boxes = _flagship_step(dev, B, N, seed, shard=True)
    if boxes.shape[0] != B // ddp.world_size() or not bool(torch.isfinite(boxes).all()):
        raise RuntimeError(f'rank {ddp.rank()}: the detections are not finite boxes for its '
                           'clouds')
    if ddp.rank() == 0:
        Path(out).write_text(json.dumps({'loss': loss}))


def dryrun_multichip(nprocs: int, device: str | None = None, B: int | None = None,
                     N: int = 512, seed: int = 0) -> float:
    """`nprocs` ranks take one data-parallel train step of the tiny flagship
    and one predict; their loss must equal one process's on the whole
    batch. Returns the ranks' loss."""
    B = B or 2 * nprocs
    if B % nprocs:
        raise SystemExit(f'dryrun: a global batch of {B} does not split over {nprocs} ranks')
    dev = resolve_device(device)
    if dev.type == 'cuda':
        # NCCL refuses two ranks on one card: there gloo runs them side by side
        one_card = torch.cuda.device_count() < nprocs
        rank_device, backend = ('cuda:0', 'gloo') if one_card else ('cuda', 'nccl')
        dev = torch.device('cuda', 0)
    else:
        rank_device, backend = 'cpu', 'gloo'
    want, _ = _flagship_step(dev, B, N, seed, shard=False)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / 'rank0.json'
        threads = max(1, torch.get_num_threads() // nprocs) if dev.type == 'cpu' else None
        ddp.spawn(_rank_dryrun, nprocs, device=rank_device, backend=backend,
                  args=(B, N, seed, str(out)), threads=threads)
        loss = json.loads(out.read_text())['loss']
    if not math.isfinite(loss) or abs(loss - want) > MULTI_RTOL * abs(want):
        raise SystemExit(f'dryrun_multichip({nprocs}): loss {loss} on {nprocs} ranks, {want} in '
                         f'one process (rtol {MULTI_RTOL})')
    print(f'dryrun_multichip({nprocs}): PDMSSD train step on {nprocs} ranks ({backend}, '
          f'{rank_device}) + predict OK, loss={loss:.4f} (one process {want:.4f})')
    return loss


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default=None, help="'cpu' to run without a card "
                    '(default: the card; fails where CUDA is unavailable)')
    ap.add_argument('--batch', type=int, default=None,
                    help='clouds of the global batch (default 2, or 2 a rank)')
    ap.add_argument('--nprocs', type=int, default=1,
                    help='ranks of a data-parallel step of the tiny flagship')
    ap.add_argument('--points', type=int, default=512)
    ap.add_argument('--cfg_file', default=CFG, help='the flagship (default), or '
                    'configs/kitti_models/pdm_ssd.yaml, pdm_ssd_aux.yaml, pdm_ssd_large.yaml, '
                    'pointrcnn.yaml, second_sparse.yaml, second_focal.yaml, voxelnext.yaml, '
                    'second.yaml, pointpillar.yaml, centerpoint_pillar.yaml, pillarnet.yaml, '
                    'pv_rcnn.yaml, pv_rcnn_sparse.yaml, voxel_rcnn.yaml, '
                    'voxel_rcnn_sparse.yaml, configs/nuscenes_models/pdm_ssd_nuscenes.yaml, '
                    'configs/nuscenes_models/bevfusion.yaml, '
                    'configs/waymo_models/mppnet_mini.yaml or caddn (a config no file holds)')
    args = ap.parse_args(argv)
    if args.nprocs > 1:
        dryrun_multichip(args.nprocs, args.device, args.batch, args.points)
    else:
        dryrun(args.device, args.batch or 2, args.points, cfg_file=args.cfg_file)


if __name__ == '__main__':
    main()
