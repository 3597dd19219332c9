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
            'batch_stats': walk(variables.get('batch_stats', {}), True)}


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


def arrays_only(out: dict) -> dict:
    """A forward's output without its entries of names (VoxelNeXt's
    'voxelnext_head_order'), which a jitted function cannot return."""
    return {k: v for k, v in out.items()
            if not (isinstance(v, (list, tuple)) and v and isinstance(v[0], str))}


class ModelPair:
    """One config built in both packages with the same weights, plus the JAX
    forward of one batch (all intermediates) as numpy. `cfg` is a whole
    config (`MODEL`, `CLASS_NAMES`, `DATA_CONFIG`) of either package's
    CfgNode. `batch` also holds the batch's `gt_boxes` and `gt_mask` for a
    training path. With `voxels`, the batch is a seeded LiDAR-like cloud
    voxelized by the port (`synthetic.voxel_batch`) and prepared by each
    package's own `get_host_prepare` where the model has one: `inputs` is what the JAX forward takes,
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
            j_prepare = j_get_host_prepare(jcfg.MODEL, jcfg.DATA_CONFIG, training=training)
            t_prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG, training=training)
            raw_np = {k: v.numpy() for k, v in raw.items()}
            self.batch = raw_np if j_prepare is None else j_prepare(raw_np)
            self.inputs = {k: np.asarray(v) for k, v in self.batch.items()}
            self._torch_inputs = raw if t_prepare is None else t_prepare(raw)
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
            fwd = jax.jit(lambda v, b: arrays_only(self.jax_model.apply(v, b, training=False)))
            self._jax_out = to_numpy(fwd(self.variables, self.inputs))
        return self._jax_out

    def torch_inputs(self) -> dict:
        """The port's forward input of the same batch (a fresh dict)."""
        return dict(self._torch_inputs)

    def jax_method(self, method, *args):
        fn = jax.jit(lambda v, *a: self.jax_model.apply(v, *a, method=method))
        return to_numpy(fn(self.variables, *args))

    def _jax_value_and_grad(self):
        """One jitted program: the training-mode forward (batch statistics),
        then `get_training_loss` on its output, as `forward_with_loss` runs
        them, and the gradient of the loss in the parameters."""
        def forward_and_loss(module, b):
            out = module(b, training=True)
            loss, tb = module.get_training_loss(out)
            return loss, (tb, arrays_only(out))

        def loss_fn(params, stats, b):
            (loss, (tb, out)), mutated = self.jax_model.apply(
                {'params': params, 'batch_stats': stats}, b, mutable=['batch_stats'],
                method=forward_and_loss)
            return loss, (tb, mutated['batch_stats'], out)

        return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    def _jax_training(self) -> tuple:
        """The training program on the batch: (forward outputs, loss, tb,
        grads, new batch_stats) as numpy, computed once and shared by
        `jax_train_forward` and `jax_loss_and_grads`."""
        if self._jax_train is None:
            (loss, (tb, stats, out)), grads = self._jax_value_and_grad()(
                self.variables['params'], self.variables['batch_stats'], self.batch)
            self._jax_train = (to_numpy(out), to_numpy(loss), to_numpy(tb), to_numpy(grads),
                               to_numpy(stats))
        return self._jax_train

    def jax_f64_loss_and_grads(self) -> tuple:
        """The same training program in float64 (`jax.enable_x64`, weights
        and batch cast): (tb, grads) as numpy. The reference that tells the
        JAX package's float32 rounding from a difference of algorithm."""
        def f64(tree):
            if isinstance(tree, Mapping):
                return {k: f64(v) for k, v in tree.items()}
            a = np.asarray(tree)
            return a.astype(np.float64) if a.dtype == np.float32 else a

        with jax.enable_x64(True):
            (_, (tb, _, _)), grads = self._jax_value_and_grad()(
                f64(self.variables['params']), f64(self.variables['batch_stats']),
                f64(self.batch))
            return to_numpy(tb), to_numpy(grads)

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


def load_cfg(name: str):
    """`configs/kitti_models/<name>.yaml` through the port's loader (its base
    config is named relative to the repo)."""
    import os
    from pdm_ssd_torch.utils.config import CfgNode, cfg_from_yaml_file
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        return cfg_from_yaml_file(f'configs/kitti_models/{name}.yaml', CfgNode())
    finally:
        os.chdir(cwd)


def leaves(tree, prefix=()):
    """(path 'a/b/c', numpy array) of every leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from leaves(v, prefix + (k,))
        else:
            yield '/'.join(prefix + (k,)), np.asarray(v)


def assert_close_to_scale(got, want, rtol, name=''):
    """Same shape, and every element within `rtol` of the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f'{name}: max |diff| {err:.3e} > {rtol} * {scale:.3e}'


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64).ravel(), np.asarray(want, np.float64).ravel()
    nw = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / nw) if nw > 0 else float(np.linalg.norm(got))


def match_detections(got: dict, want: dict, atol: float = 1e-3) -> int:
    """The same number of kept boxes in every cloud, each kept box of `want`
    paired with a distinct kept box of `got` with the same label and every
    box parameter within `atol`: matched by box, since near-tied scores may
    permute slots. Returns the number of pairs."""
    got, want = to_numpy(got), to_numpy(want)
    np.testing.assert_array_equal(got['pred_mask'].sum(1), want['pred_mask'].sum(1))
    n = 0
    for b in range(want['pred_mask'].shape[0]):
        wm, gm = want['pred_mask'][b], got['pred_mask'][b]
        w, g = want['pred_boxes'][b][wm], got['pred_boxes'][b][gm]
        wl, gl = want['pred_labels'][b][wm], got['pred_labels'][b][gm]
        free = np.ones(len(g), bool)
        for i in range(len(w)):
            d = np.where(free & (gl == wl[i]), np.abs(g - w[i]).max(axis=1), np.inf)
            j = int(np.argmin(d))
            assert d[j] <= atol, (b, i, d[j])
            free[j] = False
            n += 1
    return n


def open_score_gate_flax(variables: dict) -> dict:
    """`synthetic.open_score_gate` on a flax tree: the dense head's
    classification bias (an anchor head's `conv_cls`, a heatmap head's
    `head/hm_out`, VoxelNeXt's `head_0/hm_out`) at 0, in a copy."""
    import copy
    params = copy.deepcopy(variables['params'])
    head = params['dense_head']
    layer = (head['conv_cls'] if 'conv_cls' in head else
             head['head']['hm_out'] if 'head' in head else head['head_0']['hm_out'])
    layer['bias'] = np.zeros_like(layer['bias'])
    return {'params': params, 'batch_stats': variables['batch_stats']}


def port_loss_and_grads(pair, batch: dict) -> tuple:
    """The port's training-mode `forward_with_loss` of `batch` and every
    parameter's gradient in the flax layout, from the pair's weights; the
    BatchNorm statistics after that step, in the flax layout; the model is
    put back to the pair's weights in eval mode after. Returns (loss, tb,
    grads, batch_stats)."""
    from pdm_ssd_torch.utils.weights import to_flax
    net = pair.net
    net.load_state_dict(from_flax(pair.variables, net))
    net.train()
    net.zero_grad()
    try:
        loss, tb = net.forward_with_loss(batch)
        loss.backward()
        grads = to_flax(net, {k: p.grad for k, p in net.named_parameters()})['params']
        stats = to_flax(net)['batch_stats']
    finally:
        net.zero_grad()
        net.load_state_dict(from_flax(pair.variables, net))
        net.eval()
    return (float(loss.detach()), {k: float(v.detach()) for k, v in tb.items()}, grads, stats)


def hold_to_jax(got, want, exact, rtol: float, jax_rtol: float, max_apart: int) -> None:
    """Every leaf of `got` (the port's float32 losses or gradients, a dict or
    a tree) within `rtol` relative L2 of the JAX package's `want`. Where the
    JAX package's own float32 sums stray (a BatchNorm channel of a mostly
    empty map, whose mean lies far above its deviation; a reduction over a
    whole volume), at most `max_apart` leaves may be further apart: each is
    held to `exact()`, the JAX package's float64 value
    (`ModelPair.jax_f64_loss_and_grads`), the port's within `rtol` and the
    JAX package's float32 within `jax_rtol`."""
    got, want = dict(leaves(got)), dict(leaves(want))
    assert set(got) == set(want)
    apart = [k for k in want if rel_l2(got[k], want[k]) > rtol]
    assert len(apart) <= max_apart, apart
    if apart:
        ref = dict(leaves(exact()))
        for k in apart:
            assert rel_l2(got[k], ref[k]) <= rtol, (k, rel_l2(got[k], ref[k]))
            assert rel_l2(want[k], ref[k]) <= jax_rtol, (k, rel_l2(want[k], ref[k]))
