"""Training CLI (counterpart of `tools/train.py`): the epoch loop with a
checkpoint an epoch, resuming from the newest checkpoint of the output
directory.

    python -m pdm_ssd_torch.tools.train --cfg_file configs/kitti_models/pdm_ssd_point.yaml
        [--epochs N] [--batch_size B] [--workers W] [--extra_tag TAG]
        [--max_ckpt_save_num K] [--device cuda|cpu] [--set KEY VALUE ...]

Writes output/<exp_group>/<tag>/<extra_tag>/ckpt/checkpoint_epoch_<n>.pth.
Runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

from pathlib import Path

from ..datasets import build_dataloader
from ..models import build_network
from ..runtime import trainer
from .cli_common import parser, setup


def main(argv=None) -> None:
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument('--epochs', type=int, default=None, help='default: OPTIMIZATION.NUM_EPOCHS')
    ap.add_argument('--max_ckpt_save_num', type=int, default=5)
    args = ap.parse_args(argv)
    device = trainer.resolve_device(args.device)
    cfg, output_dir, logger = setup(args, 'train')
    if cfg.get('HOOK'):
        raise NotImplementedError('training hooks are not ported: no config of the repo sets one '
                                  '(ROADMAP Queue 1 item 3)')
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    epochs = args.epochs or cfg.OPTIMIZATION.NUM_EPOCHS

    train_set, train_loader, _ = build_dataloader(
        dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES, batch_size=batch_size,
        root_path=Path(cfg.DATA_CONFIG.DATA_PATH), workers=args.workers, logger=logger,
        training=True)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device=device,
                          class_names=cfg.CLASS_NAMES)
    optimizer, schedule = trainer.create_train_state(model, cfg.OPTIMIZATION,
                                                     len(train_loader), epochs)
    ckpt_dir = output_dir / 'ckpt'
    if args.ckpt:
        start_epoch = trainer.load_checkpoint(args.ckpt, model, optimizer)
    else:
        start_epoch = trainer.resume(ckpt_dir, model, optimizer)
    if start_epoch > 0:
        logger.info(f'resumed from epoch {start_epoch}')
    logger.info('**********************Start training**********************')
    trainer.train_model(model, optimizer, schedule, train_loader, epochs, ckpt_dir=ckpt_dir,
                        max_ckpt_save_num=args.max_ckpt_save_num, start_epoch=start_epoch,
                        logger=logger)
    logger.info('**********************End training**********************')


if __name__ == '__main__':
    main()
