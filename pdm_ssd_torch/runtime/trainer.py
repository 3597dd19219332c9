"""Train and predict steps (counterpart of `pdm_ssd_tpu/runtime/trainer.py`).

Eager PyTorch in float32 on the model's device: one step is forward, target
assignment, losses, backward, gradient clip, optimizer update and the
BatchNorm statistics' update. No checkpointing, epoch loop or data
parallelism yet.
"""
from __future__ import annotations

import torch

from .optimization import build_optimizer_and_schedule


def create_train_state(model: torch.nn.Module, opt_cfg, total_iters_each_epoch: int,
                       total_epochs: int):
    """The optimizer for `model`'s parameters, on the model's device (build
    the model with `models.build_network`, which puts it on the card unless
    told otherwise). Returns (optimizer, lr schedule)."""
    return build_optimizer_and_schedule(model.parameters(), opt_cfg, total_iters_each_epoch,
                                        total_epochs)


def make_train_step(model: torch.nn.Module, optimizer):
    """Returns `train_step(batch) -> metrics`: 'loss' and the heads' entries
    as detached 0-d tensors on the model's device (no host synchronisation).
    `batch` holds 'points', 'gt_boxes' and 'gt_mask' on that device."""

    def train_step(batch: dict) -> dict:
        model.train()
        optimizer.zero_grad()
        loss, tb = model.forward_with_loss(batch)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in {'loss': loss, **tb}.items()}

    return train_step


def make_predict_step(model: torch.nn.Module):
    """Returns `predict_step(batch) -> detections` in eval mode."""

    def predict_step(batch: dict) -> dict:
        model.eval()
        return model.predict(batch)

    return predict_step
