"""Builds the JAX flagship and its PyTorch twin with the same weights.

Inputs come from numpy seeds; BatchNorm statistics and affine parameters are
randomized on the flax side (a fresh init leaves mean 0 / var 1 / scale 1,
which would hide epsilon and layout faults) and carried to the port through
`pdm_ssd_torch.utils.weights.from_flax`. Both sides run float32 on the CPU;
JAX runs jitted.
"""
from __future__ import annotations

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
    JAX forward of one batch (all intermediates) as numpy."""

    def __init__(self, B: int = 2, N: int = 512, seed: int = 0):
        self.jax_model, self.cfg = graft._flagship(tiny=True)
        self.points = make_points(B, N, seed)
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
