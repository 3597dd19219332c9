"""Optimizers and their schedules (counterpart of
`pdm_ssd_tpu.runtime.optimization`).

- `adam_onecycle`: AdamW whose learning rate ramps by a cosine from
  `LR / DIV_FACTOR` to `LR` over the first `PCT_START` of the steps and then
  down to `LR / 1e4`, while beta1 goes `MOMS[0] -> MOMS[1] -> MOMS[0]`.
- `adam` / `sgd`: a flat rate with step decay at `DECAY_STEP_LIST` epochs.
- Every optimizer first clips the gradients' global norm at `GRAD_NORM_CLIP`,
  and decays only tensors with two or more dimensions (no BatchNorm scale
  and no bias), decoupled from the gradient for the Adam variants.

Schedules are read at the number of updates already made (0 at the first
step). `torch.optim.AdamW` with `lr` and `betas` set before each step makes
the update `-(lr) * (m_hat / (sqrt(v_hat) + eps) + wd * p)`, which is the JAX
package's; `torch.optim.SGD` with `weight_decay` makes `-(lr) * trace(g + wd * p)`.
"""
from __future__ import annotations

import math

import torch


def cos_ramp(start: float, end: float, steps: int):
    def sched(count: int) -> float:
        t = math.pi * min(count / steps, 1.0)
        return end + (start - end) / 2.0 * (math.cos(t) + 1.0)
    return sched


def _join(first, second, boundary: int):
    return lambda count: first(count) if count < boundary else second(count - boundary)


def onecycle_lr_schedule(lr, total_steps, pct_start=0.4, div_factor=10.0):
    warm = max(int(total_steps * pct_start), 1)
    return _join(cos_ramp(lr / div_factor, lr, warm),
                 cos_ramp(lr, lr / 1e4, max(total_steps - warm, 1)), warm)


def onecycle_mom_schedule(total_steps, moms=(0.95, 0.85), pct_start=0.4):
    warm = max(int(total_steps * pct_start), 1)
    return _join(cos_ramp(moms[0], moms[1], warm),
                 cos_ramp(moms[1], moms[0], max(total_steps - warm, 1)), warm)


def step_decay_schedule(lr, decay_step_list, lr_decay, lr_clip, steps_per_epoch):
    """The rate times the product of the factors of every boundary already
    passed (`boundary < count`). As in the JAX package, each factor is that
    epoch's decayed rate over the initial one, so the factors compound."""
    factors, cur = {}, lr
    for epoch in sorted(decay_step_list):
        cur = max(cur * lr_decay, lr_clip)
        factors[int(epoch * steps_per_epoch)] = cur / lr if lr > 0 else 1.0

    def sched(count: int) -> float:
        return lr * math.prod(f for b, f in factors.items() if b < count)
    return sched


class ScheduledOptimizer:
    """A torch optimizer driven by schedules, with the global-norm clip in
    front. `step()` reads the gradients in `.grad`, clips them in place,
    sets this update's hyper-parameters and applies the update."""

    def __init__(self, optimizer: torch.optim.Optimizer, lr_schedule, clip: float,
                 beta1_schedule=None):
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.beta1_schedule = beta1_schedule
        self.clip = float(clip)
        self.count = 0
        self.params = [p for g in optimizer.param_groups for p in g['params']]

    def clip_gradients(self) -> torch.Tensor:
        """Scale all gradients by clip / norm when the global norm exceeds the
        clip (no epsilon in the divisor). Returns the norm before clipping."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
        torch._foreach_mul_(grads, scale)
        return norm

    def step(self) -> None:
        self.clip_gradients()
        lr = self.lr_schedule(self.count)
        for group in self.optimizer.param_groups:
            group['lr'] = lr
            if self.beta1_schedule is not None:
                group['betas'] = (self.beta1_schedule(self.count), group['betas'][1])
        self.optimizer.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)


def build_optimizer_and_schedule(params, opt_cfg, total_iters_each_epoch, total_epochs):
    """`params`: the tensors to train. Returns (ScheduledOptimizer, lr schedule)."""
    params = list(params)
    total_steps = total_iters_each_epoch * total_epochs
    name = opt_cfg.OPTIMIZER
    wd = opt_cfg.get('WEIGHT_DECAY', 0.0)
    clip = opt_cfg.get('GRAD_NORM_CLIP', 10.0)
    groups = [{'params': [p for p in params if p.ndim >= 2], 'weight_decay': wd},
              {'params': [p for p in params if p.ndim < 2], 'weight_decay': 0.0}]
    groups = [g for g in groups if g['params']]
    beta1 = None
    if name == 'adam_onecycle':
        pct = opt_cfg.get('PCT_START', 0.4)
        lr_sched = onecycle_lr_schedule(opt_cfg.LR, total_steps, pct_start=pct,
                                        div_factor=opt_cfg.get('DIV_FACTOR', 10.0))
        beta1 = onecycle_mom_schedule(total_steps, tuple(opt_cfg.get('MOMS', [0.95, 0.85])),
                                      pct_start=pct)
    elif name in ('adam', 'sgd'):
        lr_sched = step_decay_schedule(
            opt_cfg.LR, opt_cfg.get('DECAY_STEP_LIST', [35, 45]), opt_cfg.get('LR_DECAY', 0.1),
            opt_cfg.get('LR_CLIP', 1e-7), total_iters_each_epoch)
    else:
        raise NotImplementedError(name)
    if name == 'sgd':
        opt = torch.optim.SGD(groups, lr=opt_cfg.LR, momentum=opt_cfg.get('MOMENTUM', 0.9))
    else:
        opt = torch.optim.AdamW(groups, lr=opt_cfg.LR, betas=(0.9, 0.999), eps=1e-8)
    return ScheduledOptimizer(opt, lr_sched, clip, beta1), lr_sched
