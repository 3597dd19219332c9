"""Declarative training hooks (counterpart of `pdm_ssd_tpu/runtime/hooks.py`).

A config block

    HOOK:
        DisableAugmentationHook:
            DISABLE_AUG_LIST: ['gt_sampling', ...]
            NUM_LAST_EPOCHS: 5

rebuilds the augmentor queue without the listed augmentations for the last
epochs (GT sampling off at the end of training is the standard recipe).
"""
from __future__ import annotations


def apply_epoch_hooks(hook_cfg, dataset, cur_epoch: int, total_epochs: int,
                      logger=None):
    if hook_cfg is None:
        return
    disable = hook_cfg.get('DisableAugmentationHook')
    if disable is not None:
        num_last = disable.get('NUM_LAST_EPOCHS', 5)
        if cur_epoch >= total_epochs - num_last and dataset.data_augmentor is not None:
            aug_cfg = dataset.dataset_cfg.DATA_AUGMENTOR
            aug_cfg['DISABLE_AUG_LIST'] = disable.DISABLE_AUG_LIST
            dataset.data_augmentor.disable_augmentation(aug_cfg)
            if logger:
                logger.info(f'hook: disabled augs {list(disable.DISABLE_AUG_LIST)} '
                            f'from epoch {cur_epoch}')
