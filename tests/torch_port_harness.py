"""Builds a model of the JAX package and its PyTorch twin with the same weights.

Inputs come from numpy seeds; BatchNorm statistics and affine parameters are
randomized on the flax side (a fresh init leaves mean 0 / var 1 / scale 1,
which would hide epsilon and layout faults) and carried to the port through
`pdm_ssd_torch.utils.weights.from_flax`. Both sides run float32 on the CPU;
JAX runs jitted.
"""
from __future__ import annotations

import contextlib
import itertools
from collections.abc import Mapping

import jax
import numpy as np
import torch

import __graft_entry__ as graft
from pdm_ssd_torch.models import build_network
from pdm_ssd_torch.utils.weights import from_flax, to_flax
from torch_port_threads import one_torch_thread  # noqa: F401 (re-exported)

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


class _GridPoolBf16(torch.autograd.Function):
    """What PV-RCNN's grid pool extracts, (B * R, G^3, K, C) by the (B * R,
    G^3, K) indices into the P keypoint slots, rounded to bf16 as the JAX
    package rounds it, forward and backward. The JAX package's one-hot
    extraction contracts its bf16 table over the P slots, so the transpose
    sums a slot's cotangents over the K samples of a ball and rounds that sum
    to bf16 once: the first hit's slot takes the samples that repeat it (the
    ball's padding) along with its own. Rounding each sample's cotangent
    instead would round the padding's twice."""

    @staticmethod
    def forward(ctx, x, gi):
        ctx.save_for_backward(gi)
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        gi, = ctx.saved_tensors
        pad = (gi[..., 1:] == gi[..., :1])[..., None]
        first = g[..., :1, :] + torch.where(pad, g[..., 1:, :], 0.0).sum(-2, keepdim=True)
        g = torch.cat([first, torch.where(pad, 0.0, g[..., 1:, :])], dim=-2)
        return g.to(torch.bfloat16).to(g.dtype), None


class _Bf16(torch.autograd.Function):
    """x rounded to bf16 forward, and the cotangent rounded to bf16 backward:
    what the JAX package's cast of a bf16 operand into a one-hot matrix
    product does, where each element's cotangent is one product of the
    output's cotangent with a one-hot entry (Part-A2's average pool)."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def _roiaware_pool_bf16(pool_fn):
    """`ops/roiaware.roiaware_pool` with its average taken over the selected
    points' features rounded to bf16, forward and backward, as the JAX
    package's one-hot product takes it (pdm_ssd_tpu/ops/roiaware.py:61-66),
    and in float32 whatever the model's type, as its float32 product gives it
    even in a float64 run."""
    from pdm_ssd_torch.ops import roiaware

    def pool(points, feats, rois, grid_size, pool='max', num_sampled=128, roi_mask=None):
        if pool != 'avg':
            return pool_fn(points, feats, rois, grid_size, pool, num_sampled, roi_mask)
        B, R = rois.shape[:2]
        G, P, C = int(grid_size), int(num_sampled), feats.shape[-1]
        idx, valid, cid = roiaware.roi_cells(points, rois, G, P, roi_mask)
        pfeat = torch.gather(feats, 1, idx.reshape(B, R * P, 1).long().expand(-1, -1, C))
        pfeat = _Bf16.apply(pfeat).float().reshape(B * R, P, C)
        onehot = ((cid.reshape(B * R, P, 1) == torch.arange(G ** 3)) & valid.reshape(B * R, P, 1))
        onehot = onehot.float()
        sums = torch.bmm(onehot.transpose(1, 2), pfeat)
        cnt = onehot.sum(dim=1)[..., None]
        out = torch.where(cnt > 0, sums / cnt.clamp(min=1.0), 0.0)
        return out.reshape(B, R, G, G, G, C).to(feats.dtype)
    return pool


@contextlib.contextmanager
def jax_bf16_extraction():
    """Make the port round what the JAX package's selection extracts in bf16
    (pdm_ssd_tpu/ops/sa_fused.py:212-238): the grouped relative xyz at every
    SA level, and the payload of a level that carries it in the table
    (8 channels or fewer: the raw intensity at level 1); and what PV-RCNN's
    grid pool extracts in bf16 (pdm_ssd_tpu/models/roi_heads/
    pvrcnn_head.py:119, 145-147): each sample's offset from its grid point
    and its projected features, and their cotangents where the JAX
    package's backward rounds them (`_GridPoolBf16`); the features that
    Part-A2's average pool averages, forward and backward (`_Bf16`); and the
    means of PV-RCNN++'s VectorPool and of that pool in float32, as the JAX
    package's float32 products give them in a float64 run too. With it
    the two forwards and backwards differ by float32 rounding only, so a test
    can hold the port's algorithm tightly; without it they differ by that
    extraction."""
    from pdm_ssd_torch.models.backbones_3d.pfe import VectorPoolAgg
    from pdm_ssd_torch.models.roi_heads.pvrcnn_head import PVRCNNHead
    from pdm_ssd_torch.ops import dispatch, roiaware, sa_fused

    def bf16(x):
        return x.to(torch.bfloat16).to(x.dtype)

    select, group = dispatch.window_select, sa_fused.fused_query_group
    grid_group = PVRCNNHead.group_branch

    def rounded_select(*args, **kwargs):
        return [(bf16(rel), idx, hit) for rel, idx, hit in select(*args, **kwargs)]

    def rounded_group(radii, nsamples, xyz, features, *args, **kwargs):
        if features is not None and features.shape[-1] <= 8:
            features = bf16(features)
        return group(radii, nsamples, xyz, features, *args, **kwargs)

    def rounded_grid_group(self, sel_xyz, grid, pre, gi, empty):
        rel, gfeat = grid_group(self, sel_xyz, grid, pre, gi, empty)
        return _GridPoolBf16.apply(rel, gi), _GridPoolBf16.apply(gfeat, gi)

    pool, mean = roiaware.roiaware_pool, VectorPoolAgg.subvoxel_mean

    def float32_mean(self, neigh, cid, live):
        return mean(self, neigh.float(), cid, live).to(neigh.dtype)

    dispatch.window_select, sa_fused.fused_query_group = rounded_select, rounded_group
    PVRCNNHead.group_branch = rounded_grid_group
    roiaware.roiaware_pool = _roiaware_pool_bf16(pool)
    VectorPoolAgg.subvoxel_mean = float32_mean
    try:
        yield
    finally:
        dispatch.window_select, sa_fused.fused_query_group = select, group
        PVRCNNHead.group_branch = grid_group
        roiaware.roiaware_pool = pool
        VectorPoolAgg.subvoxel_mean = mean


@contextlib.contextmanager
def jax_pool_max_by_argmax():
    """While it is active, the JAX package's voxel pools
    (pdm_ssd_tpu/models/backbones_3d/pfe.py, `VoxelNeighborAgg` and
    `SparseVoxelNeighborAgg`, which PV-RCNN and Voxel R-CNN run) take the max
    over a window by its argmax: the same value, and the gradient routed to
    one maximum where `jnp.max` shares it among equal maxima (here only ReLU
    zeros tie, whose gradient is 0 either way). XLA:CPU's jitted gradient of
    `jnp.max` over BatchNorm'd features in training mode disagrees with the
    op-by-op gradient and with finite differences in float64 (0.26 of its
    norm on the dense pool's scene; the argmax form agrees with both, as
    `test_torch_port_two_stage.py::
    test_jax_pools_jitted_max_gradient_strays_and_the_argmax_route_agrees`
    pins), so without this the JAX package's jitted training gradients are
    no reference for those pools nor for anything upstream of them."""
    from pdm_ssd_tpu.models.backbones_3d import pfe
    jnp = pfe.jnp

    class _Routed:
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def max(h, axis):
            i = jnp.argmax(h, axis=axis, keepdims=True)
            return jnp.squeeze(jnp.take_along_axis(h, i, axis=axis), axis)

    pfe.jnp = _Routed()
    try:
        yield
    finally:
        pfe.jnp = jnp


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


def jax_value_and_grad(model):
    """One jitted program of the JAX package's `model`: the training-mode
    forward (batch statistics), then `get_training_loss` on its output, as
    `forward_with_loss` runs them, and the gradient of the loss in the
    parameters. `(params, batch_stats, batch) -> ((loss, (tb, new
    batch_stats, forward outputs)), grads)`."""
    def forward_and_loss(module, b):
        out = module(b, training=True)
        loss, tb = module.get_training_loss(out)
        return loss, (tb, arrays_only(out))

    def loss_fn(params, stats, b):
        (loss, (tb, out)), mutated = model.apply(
            {'params': params, 'batch_stats': stats}, b, mutable=['batch_stats'],
            method=forward_and_loss)
        return loss, (tb, mutated['batch_stats'], out)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


# XLA's CPU backend at optimization level 1 compiles the JAX package's init
# (a threefry draw per parameter) in 40 % of the time of its default level
# 2, to the same bits: every leaf equal on each pair built from the JAX init
# (the tiny flagship and grid model, PV-RCNN, Voxel R-CNN, Part-A2,
# SECOND-IoU, the dense and the sparse SECOND, the nuScenes six-group
# variant); level 0 changes some leaves' bits
INIT_COMPILER_OPTIONS = {'xla_backend_optimization_level': 1}


def jax_init_variables(model, inputs, seed: int) -> dict:
    """The JAX package's `model.init` on `inputs` with `PRNGKey(seed)`, eval
    mode, compiled at INIT_COMPILER_OPTIONS."""
    init = jax.jit(lambda b: model.init({'params': jax.random.PRNGKey(seed)}, b, training=False))
    return init.lower(inputs).compile(INIT_COMPILER_OPTIONS)(inputs)


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
    packages (the transposed maps of the sparse conv's backward included).
    `batch` (numpy 'points', 'gt_boxes', 'gt_mask') replaces the KITTI-range
    batch of points; `input_keys` are its entries that the forwards take
    (a Waymo sequence batch's voxels, frame stack and offline proposals,
    say). Both packages build the model with the config's
    CLASS_NAMES, as the CLIs build it (a CenterHead has one head per
    CLASS_NAMES_EACH_HEAD group). The weights start from the port model's
    seeded ones (`build_network(..., seed=seed)`, in the flax layout by
    `to_flax`), not from the JAX package's init, whose compile (a threefry
    draw per parameter) is most of a small pair's set-up;
    `check_weights_round_trip` holds their layout to that init's, traced by
    `jax.eval_shape`. `jax_init=True` takes the JAX package's init instead
    (seeded with `seed`), and `variables` (a flax tree) any other start.
    Either start is randomized: BatchNorm statistics, scales and biases
    (`randomize_variables`)."""

    def __init__(self, cfg, B: int = 2, N: int = 512, seed: int = 0, jax_model=None,
                 points: np.ndarray | None = None, bias_scale: float = 0.0,
                 voxels: bool = False, train_boxes: int = 0, batch: dict | None = None,
                 variables: dict | None = None, jax_init: bool = False,
                 input_keys: tuple = ('points',)):
        from pdm_ssd_tpu.models import build_network as j_build_network
        from pdm_ssd_tpu.models import get_host_prepare as j_get_host_prepare
        from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
        self.cfg = cfg
        jcfg = JCfgNode(cfg.to_dict())
        names = list(cfg.CLASS_NAMES)
        if jax_model is None:
            jax_model = j_build_network(jcfg.MODEL, num_class=len(jcfg.CLASS_NAMES),
                                        dataset_cfg=jcfg.DATA_CONFIG, class_names=names)
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
            self.batch = dict(batch) if batch is not None else graft._make_batch(B, N, seed=seed)
            if points is not None:
                self.batch['points'] = points
            self.inputs = {k: self.batch[k] for k in input_keys}
            self._torch_inputs = to_torch(self.inputs)
        self.points = self.batch['points']
        self.net = build_network(self.cfg.MODEL, len(self.cfg.CLASS_NAMES),
                                 self.cfg.DATA_CONFIG, device='cpu', class_names=names, seed=seed)
        if jax_init:
            variables = jax_init_variables(self.jax_model, self.inputs, seed)
        elif variables is None:
            variables = to_flax(self.net)
        self.variables = randomize_variables(variables, seed + 1, bias_scale)
        self.net.load_state_dict(from_flax(self.variables, self.net))
        self._jax_out = self._jax_train = self._jax_f64 = self._jax_vg = self._jax_fwd = None
        self._jax_methods = {}

    @property
    def jax_out(self) -> dict:
        """The JAX forward of the batch in eval mode (all intermediates), as
        numpy; compiled and run on first use."""
        if self._jax_out is None:
            self._jax_out = self.jax_eval_forward(self.variables)
        return self._jax_out

    def jax_eval_forward(self, variables: dict) -> dict:
        """The JAX forward of the batch in eval mode from `variables` (the
        pair's, or others of the same layout), as numpy: one compiled
        program a pair."""
        if self._jax_fwd is None:
            self._jax_fwd = jax.jit(
                lambda v, b: arrays_only(self.jax_model.apply(v, b, training=False)))
        return to_numpy(self._jax_fwd(variables, self.inputs))

    def torch_inputs(self) -> dict:
        """The port's forward input of the same batch (a fresh dict)."""
        return dict(self._torch_inputs)

    def jax_method(self, method, *args):
        """`method` of the JAX model on the pair's variables, jitted once a
        method for the pair (a second call with inputs of the same shapes
        runs the compiled program)."""
        if method not in self._jax_methods:
            self._jax_methods[method] = jax.jit(
                lambda v, *a: self.jax_model.apply(v, *a, method=method))
        return to_numpy(self._jax_methods[method](self.variables, *args))

    def _jax_value_and_grad(self):
        """`jax_value_and_grad` of the pair's model, made once a pair, so each
        dtype is traced once: on its first call (the two-stage checks make
        it under `jax_pool_max_by_argmax`)."""
        if self._jax_vg is None:
            self._jax_vg = jax_value_and_grad(self.jax_model)
        return self._jax_vg

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
        and batch cast): (tb, grads) as numpy, computed once. The reference
        that tells the JAX package's float32 rounding from a difference of
        algorithm."""
        def f64(tree):
            if isinstance(tree, Mapping):
                return {k: f64(v) for k, v in tree.items()}
            a = np.asarray(tree)
            return a.astype(np.float64) if a.dtype == np.float32 else a

        if self._jax_f64 is None:
            with jax.enable_x64(True):
                (_, (tb, _, _)), grads = self._jax_value_and_grad()(
                    f64(self.variables['params']), f64(self.variables['batch_stats']),
                    f64(self.batch))
                self._jax_f64 = to_numpy(tb), to_numpy(grads)
        return self._jax_f64

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
    """The tiny flagship (`__graft_entry__._flagship(tiny=True)`) as a
    `ModelPair`, by default from the JAX package's init, on which the
    slice's and the training's checks were measured (from the port's seeded
    weights its SA level 1 BatchNorm gradients lie 7e-2 apart and its
    predict keeps other boxes)."""

    def __init__(self, B: int = 2, N: int = 512, seed: int = 0, jax_init: bool = True):
        jax_model, cfg = graft._flagship(tiny=True)
        super().__init__(cfg, B=B, N=N, seed=seed, jax_model=jax_model, jax_init=jax_init)


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
    classification bias (an anchor head's `conv_cls`, or `hm_out` in every
    `head` / `head_<i>` group of a heatmap head) at 0, in a copy."""
    import copy
    params = copy.deepcopy(variables['params'])
    head = params['dense_head']
    layers = ([head['conv_cls']] if 'conv_cls' in head else
              [v['hm_out'] for k, v in head.items() if k == 'head' or k.startswith('head_')])
    for layer in layers:
        layer['bias'] = np.zeros_like(layer['bias'])
    return {'params': params, 'batch_stats': variables['batch_stats']}


def port_loss_and_grads(pair, batch: dict, dtype: torch.dtype = torch.float32) -> tuple:
    """The port's training-mode `forward_with_loss` of `batch` and every
    parameter's gradient in the flax layout, from the pair's weights; the
    BatchNorm statistics after that step, in the flax layout; the model is
    put back to the pair's weights in float32 and eval mode after. With
    `dtype` float64, the weights and the batch's floats are cast first (the
    port's counterpart of `ModelPair.jax_f64_loss_and_grads`). Returns
    (loss, tb, grads, batch_stats)."""
    net = pair.net
    net.to(dtype)
    net.load_state_dict(from_flax(pair.variables, net))
    net.train()
    net.zero_grad()
    batch = {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v
             for k, v in batch.items()}
    try:
        loss, tb = net.forward_with_loss(batch)
        loss.backward()
        grads = to_flax(net, {k: p.grad for k, p in net.named_parameters()})['params']
        stats = to_flax(net)['batch_stats']
    finally:
        net.zero_grad()
        net.float()
        net.load_state_dict(from_flax(pair.variables, net))
        net.eval()
    return (float(loss.detach()), {k: float(v.detach()) for k, v in tb.items()}, grads, stats)


# the port's float64 run against the JAX package's float64 run, both with
# the JAX package's bf16 rounding where it rounds: 5.4e-13 measured on the
# tiny dense PV-RCNN; rounding the grid pool's cotangent a sample at a time
# instead of as the JAX package does moves a gradient by 2.7e-4
F64_RTOL = 1e-9


def hold_to_jax(got, want, exact, rtol: float, jax_rtol: float, max_apart: int,
                port_exact=None, total: str | None = None) -> None:
    """Every leaf of `got` (the port's float32 losses or gradients, a dict or
    a tree) within `rtol` relative L2 of the JAX package's `want`. Where the
    JAX package's own float32 sums stray (a BatchNorm channel of a mostly
    empty map, whose mean lies far above its deviation; a reduction over a
    whole volume), at most `max_apart` leaves may be further apart: each is
    held to `exact()`, the JAX package's float64 value
    (`ModelPair.jax_f64_loss_and_grads`), the JAX package's float32 within
    `jax_rtol` of it and the port's within `rtol`. With `port_exact()`, the
    port's float64 value (`port_loss_and_grads` in float64), a leaf so
    conditioned that float32 rounding alone moves the port's further than
    `rtol` from that float64 is held instead by the same algorithm: the
    port's float64 within F64_RTOL of the JAX package's, and the port's
    float32 no further from the JAX package's float64 than the JAX
    package's own float32. (Where the JAX package casts to float32 inside
    its float64 run, as its sparse ladder does, sparse_backbone.py:53-57
    and 283-288, the two float64 runs differ by more than F64_RTOL: there
    only the first hold applies.)"""
    got, want = dict(leaves(got)), dict(leaves(want))
    assert set(got) == set(want)
    apart = [k for k in want if rel_l2(got[k], want[k]) > rtol]
    assert len(apart) <= max_apart, apart
    if apart:
        ref = dict(leaves(exact()))
        mine = None if port_exact is None else dict(leaves(port_exact()))
        for k in apart:
            jax_off = rel_l2(want[k], ref[k])
            assert jax_off <= jax_rtol, (k, jax_off)
            off = rel_l2(got[k], ref[k])
            if off > rtol and mine is not None:
                assert rel_l2(mine[k], ref[k]) <= F64_RTOL, (k, rel_l2(mine[k], ref[k]))
                if k == total:
                    budget = sum(abs(float(want[t]) - float(ref[t])) for t in want if t != k)
                    jax_off = max(jax_off, budget / abs(float(ref[k])))
                assert off <= jax_off, (k, off, jax_off)
            else:
                assert off <= rtol, (k, off)


def plant_ground_truth(pair, per_cloud: int = 3, shift: float = 0.0,
                       occupied: bool = False) -> None:
    """Put the ground truth of the pair's training batch on proposals of a
    training forward of the port (the proposals do not depend on the ground
    truth, and the JAX package's lie within float32 rounding of them), so
    that the targets hold foreground ROIs: the first `per_cloud` valid ROIs
    of each cloud, label 1, moved along x by `shift` times its length and
    turned by `shift` radians (a box on its ROI exactly is a degenerate case of the
    rotated IoU's polygon clipping, where the two packages' float32 give 1
    and 0.9975). With `occupied`, the valid ROIs that hold the most of the
    forward's 'point_coords' are taken instead (Part-A2's point targets need
    voxel points inside the boxes). The pair's JAX training results are
    dropped."""
    net = pair.net
    batch = dict(pair.torch_inputs()) if 'gt_boxes' in pair._torch_inputs else \
        pair.torch_batch()
    net.train()
    try:
        with torch.no_grad():
            out = net(batch)
    finally:
        net.eval()
        net.load_state_dict(from_flax(pair.variables, net))
    gt = np.zeros_like(pair.batch['gt_boxes'])
    mask = np.zeros_like(pair.batch['gt_mask'])
    for b in range(gt.shape[0]):
        rois = out['rois'][b][out['roi_mask'][b]]
        if occupied:
            from pdm_ssd_torch.ops import box_ops
            inside = box_ops.points_in_boxes(out['point_coords'][b:b + 1], rois[None])[0]
            held = torch.bincount(inside[inside >= 0].long(), minlength=len(rois))
            rois = rois[torch.argsort(-held, stable=True)]
        rois = rois[:per_cloud].numpy()
        gt[b, :len(rois), :7] = rois
        gt[b, :len(rois), 0] += shift * gt[b, :len(rois), 3]
        gt[b, :len(rois), 6] += shift
        gt[b, :len(rois), 7] = 1
        mask[b, :len(rois)] = True
    pair.batch['gt_boxes'], pair.batch['gt_mask'] = gt, mask
    if 'gt_boxes' in pair._torch_inputs:
        pair._torch_inputs = {**pair._torch_inputs, 'gt_boxes': torch.from_numpy(gt),
                              'gt_mask': torch.from_numpy(mask)}
    pair._jax_train = pair._jax_f64 = None


def jax_target_draw(pair) -> torch.Tensor:
    """The uniform draw of the JAX package's ROI targets when its apply has
    no 'targets' rng (`PRNGKey(0)`), one per ROI slot of the pair's batch:
    the port's 'roi_target_rand' for the same targets."""
    R = pair.cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE
    B = pair.batch['gt_boxes'].shape[0]
    return torch.from_numpy(np.array(jax.random.uniform(jax.random.PRNGKey(0), (B, R))))


# ---- the two-stage voxel models (PV-RCNN, Voxel R-CNN) ----------------------------

# the dense-ladder shrinks that start from the JAX package's init, on which
# their training checks were measured: from the port's seeded weights the
# JAX package's own float32 BatchNorm gradients over their mostly empty
# dense maps stray from its float64 ones by 2.4e-2 to 3.3e-2, past the
# bound `check_training` holds that stray to (PV-RCNN++'s dense shrink
# stays within it)
JAX_INIT_PAIRS = ('pv_rcnn', 'voxel_rcnn', 'parta2', 'second_iou')

def two_stage_pair(name: str, shift: float = 0.0, occupied: bool = False):
    """`configs/kitti_models/<name>.yaml` shrunk by `synthetic.TINY_CFGS` in
    both packages, on a training batch of two LiDAR-like clouds of 3000
    points, 8 boxes a cloud, then the ground truth planted on proposals
    (`plant_ground_truth`, moved by `shift`, on occupied ROIs with
    `occupied`). The weights start from the port's seeded ones, but for
    JAX_INIT_PAIRS (`ModelPair`)."""
    from pdm_ssd_torch.utils import synthetic
    cfg = load_cfg(name)
    synthetic.TINY_CFGS[cfg.MODEL.NAME](cfg)
    pair = ModelPair(cfg, B=2, N=3000, seed=0, voxels=True, bias_scale=0.1, train_boxes=8,
                     jax_init=name in JAX_INIT_PAIRS)
    plant_ground_truth(pair, shift=shift, occupied=occupied)
    return pair


def jax_init_layout(pair) -> dict:
    """{'params': {path: (shape, dtype)}, 'batch_stats': ...} of the JAX
    package's init of the pair's model on its inputs, traced by
    `jax.eval_shape` (not compiled)."""
    init = jax.eval_shape(lambda b: pair.jax_model.init(
        {'params': jax.random.PRNGKey(0)}, b, training=False), pair.inputs)
    return {kind: {'/'.join(str(getattr(p, 'key', p)) for p in path): (a.shape, a.dtype)
                   for path, a in jax.tree_util.tree_leaves_with_path(init.get(kind, {}))}
            for kind in ('params', 'batch_stats')}


def check_weights_round_trip(pair, names) -> None:
    """The port's tensors in the flax layout (`to_flax`) have the paths,
    shapes and dtypes of the JAX package's init (`jax_init_layout`);
    `from_flax` reached every tensor when the pair was built; `to_flax`
    gives the pair's tree back leaf for leaf; each of `names` (state-dict
    prefixes such as 'pfe.agg_x_conv3.fc0') is a module of the port."""
    layout = jax_init_layout(pair)
    back = to_flax(pair.net)
    for kind in ('params', 'batch_stats'):
        got = {k: (v.shape, v.dtype) for k, v in leaves(back[kind])}
        assert got == layout[kind], kind
    n_leaves = sum(a.size for tree in pair.variables.values() for _, a in leaves(tree))
    n_port = sum(t.numel() for k, t in pair.net.state_dict().items()
                 if not k.endswith('num_batches_tracked'))
    assert n_leaves == n_port
    for kind in ('params', 'batch_stats'):
        want, got = dict(leaves(pair.variables[kind])), dict(leaves(back[kind]))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    modules = dict(pair.net.named_modules())
    assert all(n in modules for n in names), [n for n in names if n not in modules]


def check_training(pair, loss_rtol: float, grad_rel_l2: float, jax_loss_rtol: float,
                   jax_grad_rel_l2: float,
                   roi_terms=('rcnn_reg_loss', 'rcnn_corner_loss'),
                   total: str | None = None) -> dict:
    """One training-mode `forward_with_loss` of the pair's planted batch on
    the JAX draw, with the JAX package's bf16 extraction emulated and its
    voxel pools' max by argmax (`jax_pool_max_by_argmax`): the targets exact
    (the masks, the matched ground truth), the ROIs and labels to the
    training forward's float32 rounding, every loss term and every gradient
    within the bounds, or held to the JAX package's float64 run by
    `hold_to_jax` beside the port's own float64 run; each of `roi_terms`
    positive in the JAX package's run; `total` as `hold_to_jax` takes it.
    Returns the port's loss terms."""
    import functools
    batch = pair.torch_inputs()
    batch['roi_target_rand'] = jax_target_draw(pair)
    with jax_pool_max_by_argmax():
        want = pair.jax_train_forward()
        _, j_tb, j_grads, _ = pair.jax_loss_and_grads()
    net = pair.net
    net.train()
    try:
        with torch.no_grad(), jax_bf16_extraction():
            out = net(dict(batch))
    finally:
        net.eval()
        net.load_state_dict(from_flax(pair.variables, net))
    got_t, want_t = to_numpy(out['roi_targets']), want['roi_targets']
    for k in ('roi_mask', 'reg_valid_mask', 'gt_of_roi'):
        np.testing.assert_array_equal(got_t[k], want_t[k], err_msg=k)
    np.testing.assert_allclose(got_t['rcnn_cls_labels'], want_t['rcnn_cls_labels'], atol=1e-2)
    assert_close_to_scale(got_t['rois'], want_t['rois'], 1e-3, 'rois')
    assert want_t['reg_valid_mask'].sum() >= 4
    with jax_bf16_extraction():
        _, tb, grads, _ = port_loss_and_grads(pair, batch)
    assert set(tb) == set(j_tb)
    assert all(j_tb[k] > 0 for k in roi_terms), {k: j_tb[k] for k in roi_terms}

    @functools.lru_cache
    def exact():
        with jax_pool_max_by_argmax():
            return pair.jax_f64_loss_and_grads()

    @functools.lru_cache
    def port_exact():
        with jax_bf16_extraction():
            return port_loss_and_grads(pair, batch, torch.float64)[1:3]

    hold_to_jax(tb, j_tb, lambda: exact()[0], loss_rtol, jax_loss_rtol, len(tb),
                lambda: port_exact()[0], total)
    hold_to_jax(grads, j_grads, lambda: exact()[1], grad_rel_l2, jax_grad_rel_l2,
                len(dict(leaves(grads))), lambda: port_exact()[1])
    return tb


def jax_train_steps(pair, n: int, iters_per_epoch: int = 10, epochs: int = 2) -> tuple:
    """`n` steps of the JAX package's training from the pair's weights on its
    batch, with the optimizer and schedule of its config: the pair's jitted
    value and gradient of the training forward and loss (compiled once a
    pair, shared with its loss and gradient checks), then the optax update,
    jitted apart. The JAX package's `make_train_step` does the same in one
    program, which would compile the model once more. Returns (the loss of
    each step, the params, the batch statistics), as numpy."""
    from pdm_ssd_tpu.runtime import optimization as j_opt
    from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
    params, stats = pair.variables['params'], pair.variables['batch_stats']
    tx, _ = j_opt.build_optimizer_and_schedule(params, JCfgNode(pair.cfg.OPTIMIZATION.to_dict()),
                                               iters_per_epoch, epochs)

    @jax.jit
    def update(params, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state, params)
        return jax.tree_util.tree_map(lambda p, u: p + u, params, updates), opt_state

    opt_state = jax.jit(tx.init)(params)          # one program, not one a leaf
    losses = []
    for _ in range(n):
        (loss, (_, stats, _)), grads = pair._jax_value_and_grad()(params, stats, pair.batch)
        params, opt_state = update(params, opt_state, grads)
        losses.append(float(loss))
    return losses, to_numpy(params), to_numpy(stats)


def twin_steps(jax_model, variables: dict, net, opt_cfg, batches, iters_per_epoch: int,
               epochs: int, rand: torch.Tensor, value_and_grad=None) -> tuple:
    """Training steps of both packages from the JAX package's `variables`
    (the port's `net` loads them), with the optimizer and schedule of
    `opt_cfg` over `epochs` epochs of `iters_per_epoch` steps, one step a
    pair of `batches` (the JAX package's batch, the port's batch): the JAX
    package's jitted value and gradient of the training forward and its loss
    (`value_and_grad`, default `jax_value_and_grad(jax_model)`), then its
    optax update, with its voxel pools' max by argmax; the port's
    `make_train_step` with the JAX package's bf16 extraction emulated. Both
    draw the targets of every step from `PRNGKey(0)` (the port takes that
    draw, `rand`, as 'roi_target_rand'), so the two runs see the same
    targets wherever their ROIs agree. The port's model is put back to
    `variables` in eval mode after. Returns the (JAX, port) loss terms of
    each step."""
    from pdm_ssd_torch.runtime.trainer import create_train_state, make_train_step
    from pdm_ssd_torch.utils.config import CfgNode as TCfgNode
    from pdm_ssd_tpu.runtime import optimization as j_opt
    from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
    value_and_grad = value_and_grad or jax_value_and_grad(jax_model)
    tx, _ = j_opt.build_optimizer_and_schedule(variables['params'],
                                               JCfgNode(opt_cfg.to_dict()), iters_per_epoch,
                                               epochs)

    @jax.jit
    def update(params, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state, params)
        return jax.tree_util.tree_map(lambda p, u: p + u, params, updates), opt_state

    params, stats = variables['params'], variables['batch_stats']
    opt_state = jax.jit(tx.init)(params)          # one program, not one a leaf
    net.load_state_dict(from_flax(variables, net))
    optimizer, _ = create_train_state(net, TCfgNode(opt_cfg.to_dict()), iters_per_epoch, epochs)
    t_step = make_train_step(net, optimizer)
    j_terms, t_terms = [], []
    try:
        for j_batch, t_batch in batches:
            with jax_pool_max_by_argmax():
                (loss, (tb, stats, _)), grads = value_and_grad(params, stats, j_batch)
            params, opt_state = update(params, opt_state, grads)
            with jax_bf16_extraction():
                t_tb = t_step({**t_batch, 'roi_target_rand': rand})
            j_terms.append({k: float(v) for k, v in {'loss': loss, **tb}.items()})
            t_terms.append({k: float(v) for k, v in t_tb.items()})
    finally:
        net.load_state_dict(from_flax(variables, net))
        net.eval()
    return j_terms, t_terms


def train_steps(pair, n: int) -> tuple:
    """`twin_steps` on the pair's planted batch `n` times, the schedule of
    its config at 10 steps an epoch, 2 epochs."""
    return twin_steps(pair.jax_model, pair.variables, pair.net, pair.cfg.OPTIMIZATION,
                      [(pair.batch, pair.torch_inputs())] * n, 10, 2, jax_target_draw(pair),
                      pair._jax_value_and_grad())


def mini_kitti_twin(name: str, root, steps: int) -> tuple:
    """The first `steps` steps of two epochs of training in both packages
    (`twin_steps`) on the generated mini-KITTI set at `root` (64 frames, 3
    classes; made when missing), the tiny shrink of
    `configs/kitti_models/<name>.yaml` (`synthetic.TINY_CFGS`) with 4096
    points a cloud, B=2: the JAX package's initial weights (seed 0) in both,
    the port's loader's batches (seed 0; `test_torch_port_kitti.py` holds
    the two packages' batches equal) prepared by each package's own
    `get_host_prepare`. Returns the (JAX, port) loss terms of each step.
    Run it for the whole two epochs with
    `python -c "import sys; sys.path[:0] = ['tests', '.'];
    import torch_port_harness as h; print(h.mini_kitti_twin('pv_rcnn',
    'build/mini_kitti_twin', 64))"`."""
    from pathlib import Path

    from pdm_ssd_torch.datasets import build_dataloader
    from pdm_ssd_torch.models import get_host_prepare
    from pdm_ssd_torch.runtime.trainer import to_device_batch
    from pdm_ssd_torch.tools.make_mini_kitti import make
    from pdm_ssd_torch.utils import synthetic
    from pdm_ssd_tpu.models import build_network as j_build_network
    from pdm_ssd_tpu.models import get_host_prepare as j_get_host_prepare
    from pdm_ssd_tpu.runtime.trainer import _filter_device_batch
    from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
    root = Path(root)
    cfg = load_cfg(name)
    synthetic.TINY_CFGS[cfg.MODEL.NAME](cfg)
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == 'sample_points':
            proc.NUM_POINTS = {'train': 4096, 'test': 4096}
    if not (root / 'kitti_infos_val.pkl').exists():
        make(root, frames=64)
    _, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, root_path=root,
                                    workers=0, training=True, seed=0)
    np.random.seed(0)
    torch.manual_seed(0)
    raw = list(itertools.islice(itertools.chain(loader, loader), steps))
    jcfg = JCfgNode(cfg.to_dict())
    j_prepare = j_get_host_prepare(jcfg.MODEL, jcfg.DATA_CONFIG, training=True)
    t_prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG, training=True)
    batches = []
    for b in raw:
        t_b = to_device_batch(b, 'cpu')
        with torch.no_grad():
            t_b = t_b if t_prepare is None else t_prepare(t_b)
        batches.append((_filter_device_batch(b if j_prepare is None else j_prepare(b)), t_b))
    model = j_build_network(jcfg.MODEL, num_class=len(cfg.CLASS_NAMES),
                            dataset_cfg=jcfg.DATA_CONFIG)
    variables = jax_init_variables(model, batches[0][0], 0)
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device='cpu')
    R = cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE
    rand = torch.from_numpy(np.array(jax.random.uniform(jax.random.PRNGKey(0), (2, R))))
    return twin_steps(model, variables, net, cfg.OPTIMIZATION, batches, len(loader), 2, rand)


def check_predict(pair, atol: float,
                  keys=('rois', 'rcnn_cls_preds', 'rcnn_reg_preds', 'roi_labels', 'roi_mask')) -> int:
    """`predict` of the port against the JAX package's post-processing of its
    own eval forward (`pair.jax_out`'s `keys`, what the post-processing
    reads), the bf16 extraction emulated: the same boxes kept per cloud,
    matched by box and label. Returns the number of pairs."""
    want = pair.jax_method(pair.jax_model.post_process, {k: pair.jax_out[k] for k in keys})
    with jax_bf16_extraction():
        got = pair.net.predict(pair.torch_inputs())
    return match_detections(got, want, atol)
