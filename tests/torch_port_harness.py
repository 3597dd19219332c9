"""Builds a model of the JAX package and its PyTorch twin with the same weights.

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

REPO = graft.REPO


def make_points(B: int, N: int, seed: int = 0) -> np.ndarray:
    """Synthetic KITTI-range clouds (B, N, 4), as `__graft_entry__._make_batch`."""
    return graft._make_batch(B, N, seed=seed)['points']


def randomize_variables(variables: Mapping, seed: int, bias_scale: float = 0.0) -> dict:
    """Random BatchNorm statistics, scales and biases (numpy, seeded); with
    `bias_scale`, the biases of the other layers too (flax starts them at 0)."""
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
            elif k == 'bias' and bias_scale:
                a = rng.normal(0.0, bias_scale, a.shape).astype(np.float32)
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
    if tree is None or isinstance(tree, (int, float)):
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


class ModelPair:
    """One config built in both packages with the same weights, plus the JAX
    forward of one batch (all intermediates) as numpy. `cfg` is a whole
    config (`MODEL`, `CLASS_NAMES`, `DATA_CONFIG`) of either package's
    CfgNode. `batch` also holds the batch's `gt_boxes` and `gt_mask` for a
    training path. With `voxels`, the batch is a seeded LiDAR-like cloud
    voxelized by the port (`synthetic.voxel_batch`) and prepared by each
    package's own `get_host_prepare`: `inputs` is what the JAX forward takes,
    `torch_inputs()` what the port's takes. With `train_boxes` as well, that
    batch is a training one (`synthetic.voxel_train_batch`: the train-time
    voxel cap and as many boxes a cloud), prepared for training by both
    packages (the transposed maps of the sparse conv's backward included)."""

    def __init__(self, cfg, B: int = 2, N: int = 512, seed: int = 0, jax_model=None,
                 points: np.ndarray | None = None, bias_scale: float = 0.0,
                 voxels: bool = False, train_boxes: int = 0):
        from pdm_ssd_tpu.models import build_network as j_build_network
        from pdm_ssd_tpu.models import get_host_prepare as j_get_host_prepare
        from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
        self.cfg = cfg
        jcfg = JCfgNode(cfg.to_dict())
        if jax_model is None:
            jax_model = j_build_network(jcfg.MODEL, num_class=len(jcfg.CLASS_NAMES),
                                        dataset_cfg=jcfg.DATA_CONFIG)
        self.jax_model = jax_model
        if voxels:
            from pdm_ssd_torch.models import get_host_prepare
            from pdm_ssd_torch.utils import synthetic
            training = train_boxes > 0
            raw = (synthetic.voxel_train_batch(B, N, cfg, train_boxes, seed) if training
                   else synthetic.voxel_batch(B, N, cfg, seed))
            self.batch = j_get_host_prepare(jcfg.MODEL, jcfg.DATA_CONFIG, training=training)(
                {k: v.numpy() for k, v in raw.items()})
            self.inputs = {k: np.asarray(v) for k, v in self.batch.items()}
            self._torch_inputs = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG,
                                                  training=training)(raw)
        else:
            self.batch = graft._make_batch(B, N, seed=seed)
            if points is not None:
                self.batch['points'] = points
            self.inputs = {'points': self.batch['points']}
            self._torch_inputs = to_torch(self.inputs)
        self.points = self.batch['points']
        init = jax.jit(lambda b: self.jax_model.init(
            {'params': jax.random.PRNGKey(seed)}, b, training=False))
        self.variables = randomize_variables(init(self.inputs), seed + 1, bias_scale)
        self.net = build_network(self.cfg.MODEL, len(self.cfg.CLASS_NAMES),
                                 self.cfg.DATA_CONFIG, device='cpu')
        self.net.load_state_dict(from_flax(self.variables, self.net))
        self._jax_out = self._jax_train = None

    @property
    def jax_out(self) -> dict:
        """The JAX forward of the batch in eval mode (all intermediates), as
        numpy; compiled and run on first use."""
        if self._jax_out is None:
            fwd = jax.jit(lambda v, b: self.jax_model.apply(v, b, training=False))
            self._jax_out = to_numpy(fwd(self.variables, self.inputs))
        return self._jax_out

    def torch_inputs(self) -> dict:
        """The port's forward input of the same batch (a fresh dict)."""
        return dict(self._torch_inputs)

    def jax_method(self, method, *args):
        fn = jax.jit(lambda v, *a: self.jax_model.apply(v, *a, method=method))
        return to_numpy(fn(self.variables, *args))

    def _jax_training(self) -> tuple:
        """One jitted program for the batch: the training-mode forward
        (batch statistics), then `get_training_loss` on its output, as
        `forward_with_loss` runs them, and the gradient. Returns (forward
        outputs, loss, tb, grads, new batch_stats) as numpy, computed once
        and shared by `jax_train_forward` and `jax_loss_and_grads`."""
        if self._jax_train is None:
            def forward_and_loss(module, b):
                out = module(b, training=True)
                loss, tb = module.get_training_loss(out)
                return loss, (tb, out)

            def loss_fn(params, stats, b):
                (loss, (tb, out)), mutated = self.jax_model.apply(
                    {'params': params, 'batch_stats': stats}, b, mutable=['batch_stats'],
                    method=forward_and_loss)
                return loss, (tb, mutated['batch_stats'], out)

            fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
            (loss, (tb, stats, out)), grads = fn(self.variables['params'],
                                                 self.variables['batch_stats'], self.batch)
            self._jax_train = (to_numpy(out), to_numpy(loss), to_numpy(tb), to_numpy(grads),
                               to_numpy(stats))
        return self._jax_train

    def jax_loss_and_grads(self):
        """Training-mode `forward_with_loss` and its gradient in the JAX
        package: (loss, tb, grads, new batch_stats) as numpy."""
        return self._jax_training()[1:]

    def jax_train_forward(self):
        """The JAX forward in training mode (batch statistics), as numpy,
        with the batch's ground truth carried through."""
        return self._jax_training()[0]

    def torch_batch(self) -> dict:
        return {k: torch.from_numpy(v) for k, v in self.batch.items()}


class FlagshipPair(ModelPair):
    """The tiny flagship (`__graft_entry__._flagship(tiny=True)`) as a `ModelPair`."""

    def __init__(self, B: int = 2, N: int = 512, seed: int = 0):
        jax_model, cfg = graft._flagship(tiny=True)
        super().__init__(cfg, B=B, N=N, seed=seed, jax_model=jax_model)
