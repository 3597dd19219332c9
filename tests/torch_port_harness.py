"""Builds the JAX flagship and its PyTorch twin with the same weights.

Inputs come from numpy seeds; BatchNorm statistics and affine parameters are
randomized on the flax side (a fresh init leaves mean 0 / var 1 / scale 1,
which would hide epsilon and layout faults) and carried to the port through
`pdm_ssd_torch.utils.weights.from_flax`. Both sides run float32 on the CPU;
JAX runs jitted.
"""
from __future__ import annotations

import contextlib
from collections.abc import Mapping

import jax
import numpy as np
import torch

import __graft_entry__ as graft
from pdm_ssd_torch.models import build_network
from pdm_ssd_torch.utils.weights import from_flax


def make_points(B: int, N: int, seed: int = 0) -> np.ndarray:
    """Synthetic KITTI-range clouds (B, N, 4), as `__graft_entry__._make_batch`."""
    return graft._make_batch(B, N, seed=seed)['points']


def randomize_variables(variables: Mapping, seed: int) -> dict:
    """Random BatchNorm statistics, scales and biases (numpy, seeded)."""
    rng = np.random.RandomState(seed)

    def walk(tree, stats):
        out = {}
        for k, v in tree.items():
            if isinstance(v, Mapping):
                out[k] = walk(v, stats)
                continue
            a = np.asarray(v, np.float32)
            is_bn = 'scale' in tree or stats
            if stats and k == 'mean':
                a = rng.normal(0.0, 0.3, a.shape).astype(np.float32)
            elif stats and k == 'var':
                a = rng.uniform(0.3, 2.0, a.shape).astype(np.float32)
            elif is_bn and k == 'scale':
                a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            elif is_bn and k == 'bias':
                a = rng.normal(0.0, 0.2, a.shape).astype(np.float32)
            out[k] = a
        return out

    return {'params': walk(variables['params'], False),
            'batch_stats': walk(variables['batch_stats'], True)}


@contextlib.contextmanager
def jax_bf16_extraction():
    """Make the port round what the JAX package's selection extracts in bf16
    (pdm_ssd_tpu/ops/sa_fused.py:212-238): the grouped relative xyz at every
    SA level, and the payload of a level that carries it in the table
    (8 channels or fewer: the raw intensity at level 1). With it the two
    forwards differ by float32 rounding only, so a test can hold the port's
    algorithm tightly; without it they differ by that extraction."""
    from pdm_ssd_torch.ops import dispatch, sa_fused

    def bf16(x):
        return x.to(torch.bfloat16).to(torch.float32)

    select, group = dispatch.window_select, sa_fused.fused_query_group

    def rounded_select(*args, **kwargs):
        return [(bf16(rel), idx, hit) for rel, idx, hit in select(*args, **kwargs)]

    def rounded_group(radii, nsamples, xyz, features, *args, **kwargs):
        if features is not None and features.shape[-1] <= 8:
            features = bf16(features)
        return group(radii, nsamples, xyz, features, *args, **kwargs)

    dispatch.window_select, sa_fused.fused_query_group = rounded_select, rounded_group
    try:
        yield
    finally:
        dispatch.window_select, sa_fused.fused_query_group = select, group


def to_numpy(tree):
    """jax / torch arrays (nested in dicts and lists) -> numpy."""
    if isinstance(tree, Mapping):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().contiguous().numpy()
    if isinstance(tree, (int, float)):
        return tree
    return np.array(tree)


def to_torch(tree):
    if isinstance(tree, Mapping):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v) for v in tree]
    if isinstance(tree, (int, float)):
        return tree
    return torch.from_numpy(np.array(tree))


class FlagshipPair:
    """The tiny flagship in both packages with the same weights, plus the
    JAX forward of one batch (all intermediates) as numpy. `batch` also
    holds the batch's `gt_boxes` and `gt_mask` for the training path."""

    def __init__(self, B: int = 2, N: int = 512, seed: int = 0):
        self.jax_model, self.cfg = graft._flagship(tiny=True)
        self.batch = graft._make_batch(B, N, seed=seed)
        self.points = self.batch['points']
        init = jax.jit(lambda p: self.jax_model.init(
            {'params': jax.random.PRNGKey(seed)}, {'points': p}, training=False))
        self.variables = randomize_variables(init(self.points), seed + 1)
        self.net = build_network(self.cfg.MODEL, len(self.cfg.CLASS_NAMES),
                                 self.cfg.DATA_CONFIG, device='cpu')
        self.net.load_state_dict(from_flax(self.variables, self.net))
        fwd = jax.jit(lambda v, p: self.jax_model.apply(v, {'points': p}, training=False))
        self.jax_out = to_numpy(fwd(self.variables, self.points))

    def jax_method(self, method, *args):
        fn = jax.jit(lambda v, *a: self.jax_model.apply(v, *a, method=method))
        return to_numpy(fn(self.variables, *args))

    def jax_loss_and_grads(self, variables=None, batch=None):
        """Training-mode `forward_with_loss` and its gradient in the JAX
        package: (loss, tb, grads, new batch_stats) as numpy."""
        variables = self.variables if variables is None else variables
        batch = self.batch if batch is None else batch

        def loss_fn(params, stats, b):
            (loss, tb), mutated = self.jax_model.apply(
                {'params': params, 'batch_stats': stats}, b, training=True,
                mutable=['batch_stats'], method=self.jax_model.forward_with_loss)
            return loss, (tb, mutated['batch_stats'])

        fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (loss, (tb, stats)), grads = fn(variables['params'], variables['batch_stats'], batch)
        return to_numpy(loss), to_numpy(tb), to_numpy(grads), to_numpy(stats)

    def jax_train_forward(self):
        """The JAX forward in training mode (batch statistics), as numpy,
        with the batch's ground truth carried through."""
        fn = jax.jit(lambda v, b: self.jax_model.apply(v, b, training=True,
                                                       mutable=['batch_stats'])[0])
        return to_numpy(fn(self.variables, self.batch))

    def torch_batch(self) -> dict:
        return {k: torch.from_numpy(v) for k, v in self.batch.items()}
