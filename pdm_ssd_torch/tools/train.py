"""Training CLI (counterpart of `tools/train.py`): the epoch loop with a
checkpoint an epoch, resuming from the newest checkpoint of the output
directory.

    python -m pdm_ssd_torch.tools.train --cfg_file configs/kitti_models/pdm_ssd_point.yaml
        (or second_sparse.yaml, pdm_ssd.yaml, ...)
        [--epochs N] [--batch_size B] [--workers W] [--extra_tag TAG]
        [--max_ckpt_save_num K] [--pretrained_model CKPT] [--fix_random_seed]
        [--merge_all_iters_to_one_epoch] [--profile]
        [--device cuda|cpu] [--launcher none|pytorch] [--set KEY VALUE ...]

On several cards, one process a card (the batch size is a card's):

    torchrun --nproc_per_node=N -m pdm_ssd_torch.tools.train --launcher pytorch
        --cfg_file ...

Writes output/<exp_group>/<tag>/<extra_tag>/ckpt/checkpoint_epoch_<n>.pth
(rank 0 writes; every rank resumes). `--pretrained_model` overlays a
checkpoint's weights where names and shapes match and restores no optimizer
state; `--profile` writes a `torch.profiler` trace of the first steps under
<output>/profile. With `--merge_all_iters_to_one_epoch` one epoch holds every
epoch's passes over the set (`--epochs` of them) and ends with
checkpoint_epoch_1. Runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

from pathlib import Path

from ..datasets import build_dataloader
from ..models import build_network, get_host_prepare
from ..parallel import ddp
from ..runtime import trainer
from ..utils import common_utils
from .cli_common import finish, launch, parser, setup

SEED = 666


def main(argv=None) -> None:
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument('--epochs', type=int, default=None, help='default: OPTIMIZATION.NUM_EPOCHS')
    ap.add_argument('--max_ckpt_save_num', type=int, default=5)
    ap.add_argument('--pretrained_model', type=str, default=None,
                    help='a checkpoint file (or directory: its newest) whose weights are '
                         'overlaid where names and shapes match; no resume')
    ap.add_argument('--fix_random_seed', action='store_true', default=False,
                    help=f'seed random and numpy with {SEED} (plus the rank) and the loader '
                         f'workers and the sampler with {SEED}')
    ap.add_argument('--merge_all_iters_to_one_epoch', action='store_true', default=False)
    ap.add_argument('--profile', action='store_true', default=False,
                    help='a torch.profiler trace of the first training steps')
    args = ap.parse_args(argv)
    device = launch(args)
    try:
        _train(args, device)
    finally:
        finish(args)


def _train(args, device) -> None:
    cfg, output_dir, logger = setup(args, 'train')
    if args.fix_random_seed:
        common_utils.set_random_seed(SEED + ddp.rank())
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    epochs = args.epochs or cfg.OPTIMIZATION.NUM_EPOCHS

    train_set, train_loader, _ = build_dataloader(
        dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES, batch_size=batch_size,
        dist=ddp.is_distributed(), root_path=Path(cfg.DATA_CONFIG.DATA_PATH),
        workers=args.workers, logger=logger, training=True,
        seed=SEED if args.fix_random_seed else None,
        merge_all_iters_to_one_epoch=args.merge_all_iters_to_one_epoch, total_epochs=epochs)
    if args.merge_all_iters_to_one_epoch:
        epochs = 1
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device=device,
                          class_names=cfg.CLASS_NAMES)
    optimizer, schedule = trainer.create_train_state(model, cfg.OPTIMIZATION,
                                                     len(train_loader), epochs)
    if args.pretrained_model:
        trainer.load_pretrained(args.pretrained_model, model, logger=logger)
    ckpt_dir = output_dir / 'ckpt'
    if args.ckpt:
        start_epoch = trainer.load_checkpoint(args.ckpt, model, optimizer)
    else:
        start_epoch = trainer.resume(ckpt_dir, model, optimizer)
    if start_epoch > 0:
        logger.info(f'resumed from epoch {start_epoch}')
    logger.info('**********************Start training**********************')
    trainer.train_model(ddp.wrap_model(model), optimizer, schedule, train_loader, epochs,
                        ckpt_dir=ckpt_dir, max_ckpt_save_num=args.max_ckpt_save_num,
                        start_epoch=start_epoch, logger=logger,
                        host_prepare=get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG, training=True),
                        hook_cfg=cfg.get('HOOK'), dataset=train_set,
                        profile_dir=output_dir / 'profile' if args.profile else None)
    logger.info('**********************End training**********************')


if __name__ == '__main__':
    main()
