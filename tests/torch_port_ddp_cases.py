"""The cases of `test_torch_port_ddp.py`, in a module without JAX: each runs
in one process over the whole global batch, or on every rank of a process
group over the rank's share of it (`parallel.spawn` imports this module in
each rank). `run_ranks` runs them all on one pair of gloo ranks and writes
each rank's results to `rank<r>.pkl`; the test runs the same cases in its
own process, with no group, and compares."""
from __future__ import annotations

import contextlib
import os
import pickle
from pathlib import Path

import numpy as np
import torch

from pdm_ssd_torch.datasets import build_dataloader
from pdm_ssd_torch.models import build_network, get_host_prepare
from pdm_ssd_torch.models.backbones_3d.sparse_backbone import MaskedBatchNorm
from pdm_ssd_torch.models.layers import BatchNormLast
from pdm_ssd_torch.parallel import ddp
from pdm_ssd_torch.runtime import eval_utils
from pdm_ssd_torch.runtime.trainer import create_train_state, make_train_step
from pdm_ssd_torch.tools.dryrun import dry_batches, tiny_cfg
from pdm_ssd_torch.utils import synthetic
from pdm_ssd_torch.utils.config import CfgNode, cfg_from_yaml_file

REPO = Path(__file__).resolve().parents[1]
# the sparse families the JAX package holds on its mesh, in their tiny shrinks
SPARSE = ('second_sparse', 'voxel_rcnn_sparse', 'parta2_sparse')
SPARSE_B, SPARSE_N = 4, 2048
# the flagship's PDM-SSD siblings, in their tiny shrinks
SIBLINGS = ('configs/kitti_models/pdm_ssd.yaml', 'configs/kitti_models/pdm_ssd_aux.yaml',
            'configs/kitti_models/pdm_ssd_large.yaml',
            'configs/nuscenes_models/pdm_ssd_nuscenes.yaml')
SIBLING_B, SIBLING_N = 4, 1024
# detectors whose data parallelism is not held: each must refuse two ranks
REFUSED = ('pointpillar', 'second', 'pv_rcnn_sparse')
EVAL_FRAMES, EVAL_POINTS, EVAL_BATCH = 7, 2048, 2


def share(batch: dict, B: int) -> dict:
    """This rank's clouds of a global batch of `B` (every entry whose first
    axis is the batch's); the whole batch without a group."""
    W, r = ddp.world_size(), ddp.rank()
    b = B // W
    return {k: v[r * b:(r + 1) * b] if torch.is_tensor(v) and v.dim() and v.shape[0] == B
            else v for k, v in batch.items()}


# ---- BatchNorm statistics ---------------------------------------------------

def bn_inputs() -> dict:
    """Seeded inputs of the two BatchNorm cases: (8, 16, 4) rows for
    `BatchNormLast`; (8, 32, 4) slots with their mask for `MaskedBatchNorm`,
    clouds 6 and 7 without an active slot; the cotangents, the scale, shift
    and running statistics."""
    rng = np.random.RandomState(3)
    f = np.float32
    mask = rng.rand(8, 32) < 0.7
    mask[6:] = False
    return {'x': rng.randn(8, 16, 4).astype(f) * 2 + 1, 'g': rng.randn(8, 16, 4).astype(f),
            'xm': rng.randn(8, 32, 4).astype(f) * 3 - 1, 'mask': mask,
            'gm': rng.randn(8, 32, 4).astype(f),
            'scale': (rng.rand(4) + 0.5).astype(f), 'bias': rng.randn(4).astype(f),
            'mean': rng.randn(4).astype(f), 'var': (rng.rand(4) + 0.5).astype(f)}


def bn_case() -> dict:
    """Each BatchNorm in training mode on this rank's clouds: its output,
    the gradient of sum(y * g) over every rank in its input, and its running
    statistics after the step."""
    a = {k: torch.from_numpy(v) for k, v in bn_inputs().items()}
    out = {}
    for name, bn, x, extra, g in (
            ('last', BatchNormLast(4, eps=1e-5, momentum=0.1), a['x'], (), a['g']),
            ('masked', MaskedBatchNorm(4), a['xm'], (a['mask'],), a['gm'])):
        with torch.no_grad():
            bn.weight.copy_(a['scale'])
            bn.bias.copy_(a['bias'])
            bn.running_mean.copy_(a['mean'])
            bn.running_var.copy_(a['var'])
        bn.train()
        parts = share({'x': x, 'g': g, 'extra': extra[0] if extra else None}, 8)
        xs = parts['x'].clone().requires_grad_(True)
        y = bn(xs, parts['extra']) if extra else bn(xs)
        (y * parts['g']).sum().backward()
        out[name] = {'y': y.detach().numpy(), 'dx': xs.grad.numpy(),
                     'mean': bn.running_mean.numpy().copy(),
                     'var': bn.running_var.numpy().copy()}
    return out


def draw_case() -> torch.Tensor:
    """The ROI heads' target draw (`ddp.rank_rows`) of 2 clouds a rank, 5
    ROIs a cloud, from a generator seeded with 7."""
    return ddp.rank_rows(torch.rand, 4 // ddp.world_size(), 5,
                         generator=torch.Generator().manual_seed(7))


# ---- training steps ---------------------------------------------------------

def step_result(net, batch: dict, B: int, opt_cfg, prepare=None) -> dict:
    """One train step of `net` (under `wrap_model` where a group is up) on
    this rank's share of `batch`: the loss and metrics, every gradient, and
    the model's state (parameters after the update, BatchNorm buffers)."""
    optimizer, _ = create_train_state(net, opt_cfg, total_iters_each_epoch=10, total_epochs=2)
    metrics = make_train_step(ddp.wrap_model(net), optimizer, prepare)(share(batch, B))
    return {'tb': {k: float(v) for k, v in metrics.items()},
            'grads': {k: p.grad.clone() for k, p in net.named_parameters()
                      if p.grad is not None},
            'params': [k for k, _ in net.named_parameters()],
            'state': {k: v.clone() for k, v in net.state_dict().items()}}


def flagship_case(tmp: Path) -> dict:
    """The tiny flagship's step in float64 from the weights and the batch
    of B=8 clouds that the test saved (`flagship.pt`)."""
    saved = torch.load(tmp / 'flagship.pt', weights_only=False)
    cfg = CfgNode(saved['cfg'])
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device='cpu',
                        class_names=cfg.CLASS_NAMES)
    net.load_state_dict(saved['state'])
    net.double()
    batch = {k: torch.from_numpy(v) for k, v in saved['batch'].items()}
    batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    return step_result(net, batch, 8, cfg.OPTIMIZATION)


def sparse_case(name: str) -> dict:
    """The tiny shrink of `configs/kitti_models/<name>.yaml` (seeded weights,
    BatchNorm drawn) on a seeded voxel training batch of SPARSE_B clouds, its
    maps and their transposes built per rank as the train loop builds them,
    in float64."""
    cfg = tiny_cfg(f'configs/kitti_models/{name}.yaml')
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device='cpu',
                        seed=0, class_names=cfg.CLASS_NAMES)
    synthetic.randomize_bn(net, torch.Generator().manual_seed(1))
    net.double()
    batch = synthetic.voxel_train_batch(SPARSE_B, SPARSE_N, cfg, seed=0)
    batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    return step_result(net, batch, SPARSE_B, cfg.OPTIMIZATION,
                       get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG, training=True))


def sibling_case(cfg_file: str) -> dict:
    """The tiny shrink of a PDM-SSD sibling (seeded weights, BatchNorm
    drawn) on the dry run's seeded training batch of SIBLING_B clouds, in
    float64."""
    cfg = tiny_cfg(cfg_file)
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device='cpu',
                        seed=0, class_names=cfg.CLASS_NAMES)
    synthetic.randomize_bn(net, torch.Generator().manual_seed(1))
    net.double()
    batch, _ = dry_batches(cfg, SIBLING_B, SIBLING_N, 0, 'cpu')
    batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    return step_result(net, batch, SIBLING_B, cfg.OPTIMIZATION)


# ---- evaluation and samplers ------------------------------------------------

def eval_cfg(root: Path):
    """The tiny flagship on the mini set at EVAL_POINTS a cloud, its score
    thresholds at 0."""
    with in_repo():
        cfg = synthetic.tiny_flagship_cfg(
            cfg_from_yaml_file('configs/kitti_models/pdm_ssd_point.yaml'))
        cfg.DATA_CONFIG = cfg_from_yaml_file('configs/dataset_configs/kitti_dataset.yaml')
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    cfg.DATA_CONFIG.DATA_PROCESSOR[2]['NUM_POINTS'] = {'train': EVAL_POINTS,
                                                       'test': EVAL_POINTS}
    cfg.MODEL.POST_PROCESSING.SCORE_THRESH = 0.0
    cfg.MODEL.DENSE_HEAD.POST_PROCESSING.SCORE_THRESH = 0.0
    return cfg


@contextlib.contextmanager
def in_repo():
    """The configs name their base config relative to the repo."""
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        yield
    finally:
        os.chdir(cwd)


def seed_each_frame(dataset) -> None:
    """Seed `np.random` with a frame's index before the frame is read:
    `sample_points` draws a test frame's points from it, and the draw must
    not depend on the rank or the batch a frame lands in."""
    base = type(dataset)

    class FrameSeeded(base):
        def __getitem__(self, index):
            np.random.seed(index)
            return base.__getitem__(self, index)

    dataset.__class__ = FrameSeeded


def eval_case(root: Path, result_dir: Path) -> dict:
    """`eval_one_epoch` of the seeded tiny flagship over the mini set's val
    split, each rank on its shard: the result dict, and the set's
    detections in order from `result.pkl` (rank 0 writes it)."""
    cfg = eval_cfg(root)
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device='cpu', seed=0,
                        class_names=cfg.CLASS_NAMES)
    dataset, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, EVAL_BATCH,
                                          dist=ddp.is_distributed(), workers=0, training=False)
    seed_each_frame(dataset)
    ret = eval_utils.eval_one_epoch(net, loader, dataset, cfg.CLASS_NAMES, device='cpu',
                                    result_dir=result_dir)
    annos = None
    if ddp.rank() == 0:
        with open(result_dir / 'result.pkl', 'rb') as f:
            annos = pickle.load(f)
    return {'ret': {k: float(v) for k, v in ret.items() if np.isscalar(v)}, 'annos': annos}


def sampler_case(root: Path) -> dict:
    """This rank's training samples in epochs 0 and 1, its evaluation shard,
    and its training samples with MERGE_ALL_ITERS_TO_ONE_EPOCH over 3 epochs."""
    cfg = eval_cfg(root)
    dist = ddp.is_distributed()
    _, loader, sampler = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 1, dist=dist,
                                          workers=0, training=True, seed=5)
    epochs = []
    for epoch in (0, 1):
        sampler.set_epoch(epoch)
        epochs.append(list(sampler))
    _, _, eval_sampler = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 1, dist=dist,
                                          workers=0, training=False)
    merged_set, merged_loader, merged = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, 1, dist=dist, workers=0, training=True, seed=5,
        merge_all_iters_to_one_epoch=True, total_epochs=3)
    return {'epochs': epochs, 'eval': list(eval_sampler), 'merged': list(merged),
            'merged_len': len(merged_set), 'batches': len(loader),
            'merged_batches': len(merged_loader)}


def refusal_case() -> dict:
    """What `wrap_model` says of each detector of REFUSED (its message, or
    None where it wraps it)."""
    out = {}
    for name in REFUSED:
        cfg = tiny_cfg(f'configs/kitti_models/{name}.yaml')
        net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device='cpu',
                            seed=0, class_names=cfg.CLASS_NAMES)
        try:
            ddp.wrap_model(net)
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def clis_case(tmp: Path) -> dict:
    """The train CLI for one epoch, then the test CLI on its checkpoint, each
    with `--launcher pytorch` in this rank's process group (which both keep)
    on the tiny flagship's YAML the test wrote (`tiny_flagship.yaml`):
    the checkpoints written, the logs, the evaluation's numbers."""
    import torch.distributed as dist
    from pdm_ssd_torch.tools import test as test_cli
    from pdm_ssd_torch.tools import train as train_cli
    out = tmp / 'cli_out'
    common = ['--cfg_file', str(tmp / 'tiny_flagship.yaml'), '--batch_size', '2',
              '--workers', '0', '--device', 'cpu', '--output_dir', str(out),
              '--launcher', 'pytorch']
    train_cli.main(common + ['--epochs', '1'])
    dist.barrier()          # rank 0 writes the checkpoint the test CLI reads
    ret = test_cli.main(common + ['--ckpt', str(out / 'ckpt' / 'checkpoint_epoch_1.pth')])
    return {'ret': {k: float(v) for k, v in ret.items() if np.isscalar(v)},
            'ckpts': sorted(p.name for p in (out / 'ckpt').glob('*.pth')),
            'logs': sorted(p.name.split('_')[0] for p in out.glob('*.log')),
            'group_kept': ddp.is_initialized()}


def run_ranks(device, tmp: str) -> None:
    """Every case on this rank; its results to `<tmp>/rank<r>.pkl`."""
    tmp = Path(tmp)
    res = {'world': ddp.world_size(), 'bn': bn_case(), 'draw': draw_case(),
           'flagship': flagship_case(tmp)}
    for name in SPARSE:
        res[name] = sparse_case(name)
    for cfg_file in SIBLINGS:
        res[cfg_file] = sibling_case(cfg_file)
    res['eval'] = eval_case(tmp / 'kitti', tmp / 'eval_ranks')
    res['sampler'] = sampler_case(tmp / 'kitti')
    res['refusal'] = refusal_case()
    res['clis'] = clis_case(tmp)
    with open(tmp / f'rank{ddp.rank()}.pkl', 'wb') as f:
        pickle.dump(res, f)
