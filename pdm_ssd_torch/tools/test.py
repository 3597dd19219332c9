"""Evaluation CLI (counterpart of `tools/test.py`): predict over the test
split, write result.pkl and the KITTI label files, print recall and KITTI AP.

    python -m pdm_ssd_torch.tools.test --cfg_file configs/kitti_models/pdm_ssd_point.yaml
        (or second_sparse.yaml, pdm_ssd.yaml, ...)
        --ckpt output/.../ckpt/checkpoint_epoch_<n>.pth [--batch_size B]
        [--ckpt_step N] [--eval_all [--max_waiting_mins M]] [--profile]
        [--matmul_precision float32|tensorfloat32|bfloat16]
        [--device cuda|cpu] [--launcher none|pytorch] [--set KEY VALUE ...]

`--ckpt` names a checkpoint file, or a checkpoint directory (default: the
output directory's ckpt/): `--ckpt_step N` takes its checkpoint_epoch_N.pth,
`--eval_all` evaluates each of its checkpoints not yet listed in
eval/eval_list_val.txt, in epoch order, and polls it for new ones until
`--max_waiting_mins` pass without one. `--profile` writes a `torch.profiler`
trace of the evaluation under eval/profile. `--matmul_precision` sets how
float32 matmuls and cuDNN convolutions compute (PyTorch's default leaves
cuDNN's TF32 on). Under torchrun (`--launcher pytorch`) each rank predicts
its share of the set and rank 0 evaluates. Writes
output/<exp_group>/<tag>/<extra_tag>/eval/. Without a checkpoint it
evaluates the seeded weights of `build_network`. Runs on the card unless
`--device cpu` is given.
"""
from __future__ import annotations

import time
from pathlib import Path

from ..datasets import build_dataloader
from ..models import build_network, get_host_prepare
from ..parallel import ddp
from ..runtime import eval_utils, trainer
from .cli_common import finish, launch, parser, set_matmul_precision, setup

POLL_SECONDS = 30


def main(argv=None):
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument('--ckpt_step', type=int, default=None,
                    help='the epoch of the checkpoint to take from the --ckpt directory')
    ap.add_argument('--eval_all', action='store_true', default=False,
                    help='evaluate every checkpoint of the --ckpt directory, new ones too')
    ap.add_argument('--max_waiting_mins', type=float, default=30,
                    help='with --eval_all: minutes to wait for a new checkpoint')
    ap.add_argument('--profile', action='store_true', default=False,
                    help='a torch.profiler trace of the evaluation')
    ap.add_argument('--matmul_precision', default=None,
                    choices=['float32', 'tensorfloat32', 'bfloat16'])
    args = ap.parse_args(argv)
    device = launch(args)
    try:
        return _test(args, device)
    finally:
        finish(args)


def _test(args, device):
    cfg, output_dir, logger = setup(args, 'eval')
    if args.matmul_precision:
        set_matmul_precision(args.matmul_precision, logger)
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    test_set, test_loader, _ = build_dataloader(
        dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES, batch_size=batch_size,
        dist=ddp.is_distributed(), root_path=Path(cfg.DATA_CONFIG.DATA_PATH),
        workers=args.workers, logger=logger, training=False)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device=device,
                          class_names=cfg.CLASS_NAMES)
    eval_dir = output_dir / 'eval'
    host_prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG)

    def run_eval(tag=''):
        prof = trainer.start_profiler(device) if args.profile else None
        ret = eval_utils.eval_one_epoch(model, test_loader, test_set, cfg.CLASS_NAMES,
                                        device=device, result_dir=eval_dir, logger=logger,
                                        host_prepare=host_prepare)
        if prof is not None:
            trainer.stop_profiler(prof, eval_dir / 'profile', logger)
        logger.info(f'{tag}{ret}')
        return ret

    ckpt_dir = Path(args.ckpt) if args.ckpt and Path(args.ckpt).is_dir() else output_dir / 'ckpt'
    if args.eval_all:
        return _eval_all(args, ckpt_dir, eval_dir, model, run_eval, logger)
    ckpt = ckpt_dir / f'checkpoint_epoch_{args.ckpt_step}.pth' if args.ckpt_step is not None \
        else args.ckpt
    if ckpt and Path(ckpt).is_dir():
        found = trainer.list_checkpoints(ckpt)
        if not found:
            raise FileNotFoundError(f'no checkpoint under {ckpt}')
        ckpt = found[-1]
    if ckpt:
        epoch = trainer.load_checkpoint(ckpt, model)
        logger.info(f'loaded {ckpt} (epoch {epoch})')
    else:
        logger.warning('no --ckpt given: evaluating the seeded initial weights')
    return run_eval()


def _eval_all(args, ckpt_dir: Path, eval_dir: Path, model, run_eval, logger) -> dict:
    """Evaluate each checkpoint of `ckpt_dir` that eval/eval_list_val.txt
    does not list, in epoch order, adding it there; poll for new ones every
    POLL_SECONDS until `--max_waiting_mins` pass without one (the
    reference's `repeat_eval_ckpt`). Rank 0 reads the directory and the
    list for every rank. Returns {epoch: result}."""
    record = eval_dir / 'eval_list_val.txt'
    results, waited = {}, 0.0
    while True:
        todo = None
        if ddp.rank() == 0:
            done = set(int(x) for x in record.read_text().split()) if record.exists() else set()
            todo = [(epoch, str(p)) for p in trainer.list_checkpoints(ckpt_dir)
                    if (epoch := int(p.stem.rsplit('_', 1)[1])) not in done]
        todo = ddp.broadcast_from_rank0(todo)
        if not todo:
            if waited >= args.max_waiting_mins * 60:
                break
            time.sleep(POLL_SECONDS)
            waited += POLL_SECONDS
            continue
        waited = 0.0
        for epoch, path in todo:
            trainer.load_checkpoint(path, model)
            results[epoch] = run_eval(tag=f'[epoch {epoch}] ')
            if ddp.rank() == 0:
                with open(record, 'a') as f:
                    f.write(f'{epoch}\n')
    logger.info(f'evaluated epochs {sorted(results)} of {ckpt_dir}')
    return results


if __name__ == '__main__':
    main()
