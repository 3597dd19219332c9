"""What the train and test CLIs share: their arguments, the launch (one
process, or one process a card under torchrun), config, output directory
and logger."""
from __future__ import annotations

import argparse
import datetime
from pathlib import Path

import torch

from ..parallel import ddp
from ..runtime import trainer
from ..utils import common_utils
from ..utils.config import cfg_from_list, cfg_from_yaml_file, log_config_to_file

REPO = Path(__file__).resolve().parents[2]


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument('--cfg_file', type=str, required=True)
    ap.add_argument('--batch_size', type=int, default=None,
                    help='default: OPTIMIZATION.BATCH_SIZE_PER_GPU')
    ap.add_argument('--workers', type=int, default=4)
    ap.add_argument('--extra_tag', type=str, default='default')
    ap.add_argument('--ckpt', type=str, default=None)
    ap.add_argument('--device', type=str, default='cuda',
                    help="'cuda' (default; fails where CUDA is unavailable) or 'cpu'")
    ap.add_argument('--output_dir', type=str, default=None,
                    help='default: output/<exp_group>/<tag>/<extra_tag> under the repo')
    ap.add_argument('--launcher', choices=['none', 'pytorch'], default='none',
                    help="'pytorch': one process a card under torchrun "
                         '(torchrun --nproc_per_node=N -m pdm_ssd_torch.tools.<cli> '
                         '--launcher pytorch ...); --batch_size is then a card\'s')
    ap.add_argument('--set', dest='set_cfgs', default=None, nargs=argparse.REMAINDER,
                    help='dotted config keys and their values')
    return ap


def launch(args) -> torch.device:
    """The device of this process: `--device` (the card unless 'cpu'), or
    with `--launcher pytorch` this rank's, after joining torchrun's process
    group (NCCL on the cards, gloo on the CPU; a group already up is kept,
    and `finish` leaves it up). Raises where the card is asked for and CUDA
    is unavailable."""
    device = trainer.resolve_device(args.device)
    args.joined = False
    if args.launcher != 'pytorch':
        return device
    if not ddp.is_initialized():
        args.joined = True
        return ddp.init_distributed(args.device)
    if device.type == 'cuda':
        return torch.device('cuda', torch.cuda.current_device())
    return device


def finish(args) -> None:
    """Leave the process group that `launch` joined."""
    if args.joined:
        ddp.shutdown()


def setup(args, log_name: str):
    """(cfg, output dir, logger) of the parsed arguments. The config's base
    config is named relative to the working directory, as in the JAX
    package's CLIs: run from the repo root."""
    cfg = cfg_from_yaml_file(args.cfg_file)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    output_dir = Path(args.output_dir) if args.output_dir else \
        REPO / 'output' / cfg.EXP_GROUP_PATH / cfg.TAG / args.extra_tag
    output_dir.mkdir(parents=True, exist_ok=True)
    stamp = datetime.datetime.now().strftime('%Y%m%d-%H%M%S')
    rank = ddp.rank()
    logger = common_utils.create_logger(
        output_dir / f'{log_name}_{stamp}.log' if rank == 0 else None, rank=rank)
    logger.info(f'device: {args.device}, ranks: {ddp.world_size()}')
    log_config_to_file(cfg, logger=logger)
    return cfg, output_dir, logger


# --matmul_precision: PyTorch's float32 matmul precision and the TF32 switches
MATMUL_PRECISIONS = {
    'float32': dict(precision='highest', cudnn_tf32=False),
    'tensorfloat32': dict(precision='high', cudnn_tf32=True),
    'bfloat16': dict(precision='medium', cudnn_tf32=True),
}


def set_matmul_precision(name: str, logger=None) -> dict:
    """Set how float32 matmuls and cuDNN convolutions compute (the JAX
    package's `jax_default_matmul_precision`): 'float32' turns TF32 off in
    both, 'tensorfloat32' on, 'bfloat16' lets matmuls run in bfloat16 too
    (`torch.set_float32_matmul_precision('medium')`; cuDNN's float32
    convolutions have no bfloat16 mode and take TF32). The precision sets
    `torch.backends.cuda.matmul.allow_tf32` with it. Returns what was set,
    read back."""
    want = MATMUL_PRECISIONS[name]
    torch.set_float32_matmul_precision(want['precision'])
    torch.backends.cudnn.allow_tf32 = want['cudnn_tf32']
    got = {'float32_matmul_precision': torch.get_float32_matmul_precision(),
           'cuda.matmul.allow_tf32': torch.backends.cuda.matmul.allow_tf32,
           'cudnn.allow_tf32': torch.backends.cudnn.allow_tf32}
    if logger is not None:
        logger.info(f'matmul precision {name}: {got}')
    return got
