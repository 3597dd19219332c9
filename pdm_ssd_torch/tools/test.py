"""Evaluation CLI (counterpart of `tools/test.py`): predict over the test
split, write result.pkl and the KITTI label files, print recall and KITTI AP.

    python -m pdm_ssd_torch.tools.test --cfg_file configs/kitti_models/pdm_ssd_point.yaml
        (or second_sparse.yaml, pdm_ssd.yaml, ...)
        --ckpt output/.../ckpt/checkpoint_epoch_<n>.pth [--batch_size B]
        [--device cuda|cpu] [--set KEY VALUE ...]

Writes output/<exp_group>/<tag>/<extra_tag>/eval/. Without `--ckpt` it
evaluates the seeded weights of `build_network`. Runs on the card unless
`--device cpu` is given.
"""
from __future__ import annotations

from pathlib import Path

from ..datasets import build_dataloader
from ..models import build_network, get_host_prepare
from ..runtime import eval_utils, trainer
from .cli_common import parser, setup


def main(argv=None) -> dict:
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    device = trainer.resolve_device(args.device)
    cfg, output_dir, logger = setup(args, 'eval')
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    test_set, test_loader, _ = build_dataloader(
        dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES, batch_size=batch_size,
        root_path=Path(cfg.DATA_CONFIG.DATA_PATH), workers=args.workers, logger=logger,
        training=False)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device=device,
                          class_names=cfg.CLASS_NAMES)
    if args.ckpt:
        epoch = trainer.load_checkpoint(args.ckpt, model)
        logger.info(f'loaded {args.ckpt} (epoch {epoch})')
    else:
        logger.warning('no --ckpt given: evaluating the seeded initial weights')
    ret = eval_utils.eval_one_epoch(model, test_loader, test_set, cfg.CLASS_NAMES, device=device,
                                    result_dir=output_dir / 'eval', logger=logger,
                                    host_prepare=get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG))
    logger.info(f'{ret}')
    return ret


if __name__ == '__main__':
    main()
