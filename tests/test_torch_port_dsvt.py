"""DSVT in the port against the JAX package, on the CPU: flax's `LayerNorm`
and `MultiHeadDotProductAttention` against `models/layers.LayerNorm` and
`MultiHeadAttention` (an all-empty window included), one DSVT block,
`DSVTBackbone` at sizes that are not window multiples and at strides 2 and
3, and the tiny `dsvt.yaml` (`synthetic.tiny_dsvt_cfg`: the JAX package's
zoo widths, D_MODEL [16, 16], NHEAD [2, 2]): weights, forward, predict,
losses and gradients.

Inputs come from numpy seeds; both packages run float32; JAX runs jitted.
Each tolerance stands beside its reason.
"""
import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from pdm_ssd_torch.models.backbones_2d.dsvt_backbone import DSVTBackbone as TDSVT
from pdm_ssd_torch.models.backbones_2d.dsvt_backbone import WindowSelfAttention as TBlock
from pdm_ssd_torch.models.layers import LayerNorm as TLayerNorm
from pdm_ssd_torch.models.layers import MultiHeadAttention as TAttention
from pdm_ssd_torch.models.layers import init_parameters
from pdm_ssd_torch.utils import synthetic
from pdm_ssd_torch.utils.config import CfgNode as TCfgNode
from pdm_ssd_torch.utils.weights import from_flax, to_flax
from pdm_ssd_tpu.models.backbones_2d.dsvt_backbone import DSVTBackbone as JDSVT
from pdm_ssd_tpu.models.backbones_2d.dsvt_backbone import WindowSelfAttention as JBlock
from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_harness import (ModelPair, assert_close_to_scale, leaves, load_cfg,
                                match_detections, open_score_gate_flax, port_loss_and_grads,
                                randomize_variables, rel_l2, to_numpy)

# one layer fed the same inputs: float32 sums in another order only
# (measured at most 4e-7 of scale)
LAYER_RTOL = 1e-5
# the backbone and the tiny model's maps: a few layers of the same
# (measured 6e-7 of scale on the backbone, 2e-7 on the model's heatmaps)
MODEL_RTOL = 1e-4
# the losses of one batch (measured 4e-7 apart)
LOSS_RTOL = 1e-5
# per-leaf gradients, relative L2 (measured at most 1e-5)
GRAD_REL_L2 = 1e-4
# an attention key's bias shifts all of a query's scores alike, which the
# softmax cancels: its gradient is 0 in exact arithmetic and float32 noise in
# both packages (2e-9 against a largest gradient of 660 on the tiny model),
# so it is held by its norm, on each side, against the largest gradient's
NULL_GRAD_RTOL = 1e-6
# decoded boxes matched between the two packages' detections
BOX_ATOL = 1e-3


def _jit_apply(module, variables, *args, **kwargs):
    return to_numpy(jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(variables, *args))


def _rows(rng, shape) -> np.ndarray:
    return rng.normal(0.0, 1.0, shape).astype(np.float32)


def _seeded(module: torch.nn.Module, seed: int, bias_scale: float) -> dict:
    """`module`'s seeded weights (`init_parameters`) in the flax layout, the
    LayerNorms' scales and every bias randomized (`randomize_variables`), and
    loaded back into it: the JAX side's weights without an init to compile."""
    init_parameters(module, torch.Generator().manual_seed(seed))
    variables = randomize_variables(to_flax(module), seed, bias_scale)
    module.load_state_dict(from_flax(variables, module))
    return variables


@pytest.mark.parametrize('deviation', [1.0, 1e-3])
def test_layer_norm_matches_flax(deviation):
    """flax's LayerNorm (epsilon 1e-6, the variance as E[x^2] - E[x]^2, the
    scale folded into the reciprocal deviation) with a random scale and
    bias, on rows of unit deviation and of deviation 1e-3 (a variance of
    1e-6, where torch's default epsilon 1e-5 moves the output by 40 %: the
    control). Far from zero mean the two packages' E[x^2] - E[x]^2 round
    apart with their orders of summation (2e-3 of scale at a mean of 100),
    so that case is not held here."""
    rng = np.random.RandomState(0)
    x = _rows(rng, (5, 7, 24)) * np.float32(deviation)
    variables = {'params': {'scale': rng.uniform(0.5, 1.5, 24).astype(np.float32),
                            'bias': rng.normal(0, 0.2, 24).astype(np.float32)}}
    want = _jit_apply(fnn.LayerNorm(), variables, x)
    ln = TLayerNorm(24)
    ln.load_state_dict(from_flax(variables, ln))
    assert ln.eps == 1e-6
    with torch.no_grad():
        got = ln(torch.from_numpy(x)).numpy()
        control = torch.nn.functional.layer_norm(torch.from_numpy(x), (24,), ln.weight, ln.bias,
                                                 1e-5).numpy()
    assert_close_to_scale(got, want, LAYER_RTOL, 'layer norm')
    if deviation < 1:
        assert np.abs(control - want).max() > 0.1 * np.abs(want).max()
    for k, v in variables['params'].items():
        np.testing.assert_array_equal(to_flax(ln)['params'][k], v, err_msg=k)


ATTENTION_CASES = {
    # self-attention of 6 windows of 8 cells, the keys masked by occupancy:
    # window 2 has no occupied cell (flax fills its scores with the float32
    # minimum and weighs its cells uniformly), window 4 a single one
    'masked self': dict(lq=8, lk=8, heads=2, masked=True, cross=False),
    # cross-attention of 5 queries to 33 tokens with the values taken from
    # the keys (flax 0.12 when inputs_v is None), 4 heads of 6
    'cross': dict(lq=5, lk=33, heads=4, masked=False, cross=True),
}


@pytest.mark.parametrize('case', list(ATTENTION_CASES))
def test_attention_matches_flax(case):
    """`MultiHeadAttention` against flax's `MultiHeadDotProductAttention`
    with the same weights (random biases): the query scaled by 1/sqrt(head
    dim), the masked scores at the float32 minimum, the values from the
    keys when none are given; finite where a window is all masked."""
    spec = ATTENTION_CASES[case]
    rng = np.random.RandomState(1)
    d, h = 24, spec['heads']
    xq = _rows(rng, (6, spec['lq'], d))
    xk = _rows(rng, (6, spec['lk'], d)) if spec['cross'] else None
    mask = None
    if spec['masked']:
        occ = rng.rand(6, spec['lk']) > 0.4
        occ[2] = False
        occ[4] = False
        occ[4, 3] = True
        mask = occ[:, None, None, :]
    flax_attn = fnn.MultiHeadDotProductAttention(num_heads=h, qkv_features=d)
    args = (xq,) if xk is None else (xq, xk)
    attn = TAttention(d, d, h)
    variables = _seeded(attn, 2, bias_scale=0.3)
    want = _jit_apply(flax_attn, variables, *args, mask=mask)
    with torch.no_grad():
        got = attn(*(torch.from_numpy(a) for a in args),
                   mask=None if mask is None else torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert_close_to_scale(got, want, LAYER_RTOL, case)
    back = to_flax(attn)['params']
    for k, v in leaves(variables['params']):
        np.testing.assert_array_equal(dict(leaves(back))[k], v, err_msg=k)
    if spec['masked']:       # the empty window's cells all read the mean of its values
        with torch.no_grad():
            v = attn.value(torch.from_numpy(xq[2])).mean(dim=0)
            mean_out = attn.out(v)
        np.testing.assert_allclose(got[2], np.broadcast_to(mean_out.numpy(), got[2].shape),
                                   atol=1e-5)


def test_window_block_matches_flax_on_empty_windows():
    """One DSVT block (`WindowSelfAttention`: LayerNorm, attention, FFN, two
    residuals) on windows of 64 cells, two of them with no occupied cell."""
    rng = np.random.RandomState(3)
    x = _rows(rng, (4, 64, 16))
    occ = rng.rand(4, 64) > 0.5
    occ[[0, 3]] = False
    t_block = TBlock(16, 2, 32)
    variables = _seeded(t_block, 4, bias_scale=0.2)
    want = _jit_apply(JBlock(16, 2, 32), variables, x, occ)
    with torch.no_grad():
        got = t_block(torch.from_numpy(x), torch.from_numpy(occ)).numpy()
    assert np.isfinite(got).all()
    assert_close_to_scale(got, want, LAYER_RTOL, 'block')


BACKBONE_CASES = {
    # 21 x 13 cells padded to 24 x 16 for 8 x 8 windows, pooled by 2 after
    # the second stage
    'pad, stride 2': dict(H=21, W=13, window=[8, 8], strides=[1, 2], d=[8, 16]),
    # 10 x 11 cells padded to 12 x 12 for 3-wide, 4-tall windows, then 3 x 3
    # strides whose 'SAME' pools pad (12 -> 4; the second stage pads 4 to 4
    # x 6 and pools to 2 x 2)
    'pad, stride 3': dict(H=10, W=11, window=[3, 4], strides=[3, 3], d=[8, 8]),
}


@pytest.mark.parametrize('case', list(BACKBONE_CASES))
def test_dsvt_backbone_matches_jax(case):
    """`DSVTBackbone` on a map with unoccupied cells (all channels 0), at
    sizes that are not window multiples: the padding, the projections, both
    window orientations, the zeroing at unoccupied cells, the strided 'SAME'
    max pool of features and occupancy."""
    spec = BACKBONE_CASES[case]
    rng = np.random.RandomState(5)
    x = _rows(rng, (2, spec['H'], spec['W'], 5))
    x[rng.rand(2, spec['H'], spec['W']) < 0.45] = 0.0
    cfg = {'WINDOW_SHAPE': spec['window'], 'D_MODEL': spec['d'], 'NHEAD': [2, 2],
           'DIM_FEEDFORWARD': [16, 16], 'BLOCKS_PER_STAGE': [2, 2],
           'STAGE_STRIDES': spec['strides']}
    t_bb = TDSVT(TCfgNode(cfg), 5)
    variables = _seeded(t_bb, 6, bias_scale=0.2)
    j_bb = JDSVT(model_cfg=JCfgNode(cfg), input_channels=5)
    want = _jit_apply(j_bb, variables, {'spatial_features': x})['spatial_features_2d']
    with torch.no_grad():
        got = t_bb({'spatial_features': torch.from_numpy(x)})['spatial_features_2d'].numpy()
    assert t_bb.num_bev_features == spec['d'][-1]
    assert (got == 0).any() and np.isfinite(got).all()
    assert_close_to_scale(got, want, MODEL_RTOL, case)


# ---- the tiny model ---------------------------------------------------------------

@pytest.fixture(scope='module')
def dsvt():
    """The tiny `dsvt.yaml` in both packages on two KITTI-range clouds of
    2048 points with 4 boxes each, its weights started from the seeded port
    model's (`to_flax`; `test_weights_have_the_jax_layout` holds them to the
    JAX package's init)."""
    cfg = synthetic.tiny_dsvt_cfg(load_cfg('dsvt'))
    batch = synthetic.kitti_batch(2, 2048, 4, seed=0)
    start = to_flax(synthetic.random_model(cfg, 'cpu', seed=0))
    return ModelPair(cfg, B=2, N=2048, seed=0, batch=batch, variables=start)


def test_weights_have_the_jax_layout(dsvt):
    """The port's tensors in the flax layout have the paths, shapes and
    dtypes of the JAX package's init (traced, not compiled: the LayerNorms'
    scale and bias, the attention's (in, heads, head_dim) and (heads,
    head_dim, out) kernels) and map back onto the port unchanged."""
    init = jax.eval_shape(lambda b: dsvt.jax_model.init(
        {'params': jax.random.PRNGKey(0)}, b, training=False), dsvt.inputs)
    back = to_flax(dsvt.net)
    for kind in ('params', 'batch_stats'):
        want = {'/'.join(str(getattr(p, 'key', p)) for p in path): (a.shape, a.dtype)
                for path, a in jax.tree_util.tree_leaves_with_path(init[kind])}
        got = dict(leaves(back[kind]))
        assert {k: (v.shape, v.dtype) for k, v in got.items()} == want, kind
        for k, v in leaves(dsvt.variables[kind]):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    attn = back['params']['module_list_1']['s1_block0']['attn']
    assert attn['query']['kernel'].shape == (16, 2, 8) and attn['out']['kernel'].shape == (2, 8, 16)


def test_forward_and_predict_match_jax(dsvt):
    """The eval forward: the pillar canvas, the backbone's map (the 100 x 88
    grid padded to 104 x 88, pooled to 52 x 44) and the heatmap head's maps
    within MODEL_RTOL of scale; then `predict` with the score gate open: the
    same detections by box and label."""
    J = dsvt.jax_out
    with torch.no_grad():
        T = to_numpy(dsvt.net(dsvt.torch_inputs()))
    assert T['spatial_features_2d'].shape == (2, 52, 44, 16)
    for k in ('spatial_features', 'spatial_features_2d'):
        assert_close_to_scale(T[k], J[k], MODEL_RTOL, k)
    for k, want in J['center_head_preds'][0].items():
        assert_close_to_scale(T['center_head_preds'][0][k], want, MODEL_RTOL, k)
    variables = dsvt.variables
    dsvt.variables = open_score_gate_flax(variables)
    dsvt.net.load_state_dict(from_flax(dsvt.variables, dsvt.net))
    try:
        want = dsvt.jax_method(dsvt.jax_model.predict, {'points': dsvt.points})
        got = dsvt.net.predict(dsvt.torch_inputs())
    finally:
        dsvt.variables = variables
        dsvt.net.load_state_dict(from_flax(variables, dsvt.net))
    assert match_detections(got, want, BOX_ATOL) >= 1


def test_training_loss_and_gradients_match_jax(dsvt):
    """The training loss and its terms within LOSS_RTOL, every gradient
    within GRAD_REL_L2 relative L2 of the JAX package's, the attention keys'
    biases (0 in exact arithmetic) held by their norm."""
    _, tb, grads, _ = port_loss_and_grads(dsvt, dsvt.torch_batch())
    _, j_tb, j_grads, _ = dsvt.jax_loss_and_grads()
    assert set(tb) == {'hm_loss', 'loc_loss', 'loss'} == set(j_tb)
    for k, want in j_tb.items():
        np.testing.assert_allclose(float(tb[k]), float(want), rtol=LOSS_RTOL, err_msg=k)
    got, want = dict(leaves(grads)), dict(leaves(j_grads))
    assert set(got) == set(want)
    largest = max(np.linalg.norm(v) for v in want.values())
    null = [k for k in want if k.endswith('attn/key/bias')]
    assert len(null) == 4
    for k in want:
        if k in null:
            assert max(np.linalg.norm(got[k]), np.linalg.norm(want[k])) \
                <= NULL_GRAD_RTOL * largest, k
        else:
            assert rel_l2(got[k], want[k]) <= GRAD_REL_L2, (k, rel_l2(got[k], want[k]))
