"""What the train and test CLIs share: their arguments, config, output
directory and logger."""
from __future__ import annotations

import argparse
import datetime
from pathlib import Path

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
    ap.add_argument('--set', dest='set_cfgs', default=None, nargs=argparse.REMAINDER,
                    help='dotted config keys and their values')
    return ap


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
    logger = common_utils.create_logger(output_dir / f'{log_name}_{stamp}.log', rank=0)
    logger.info(f'device: {args.device}')
    log_config_to_file(cfg, logger=logger)
    return cfg, output_dir, logger
