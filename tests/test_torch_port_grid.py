"""The rest of the KITTI PDM family in the port against the JAX package, on
the CPU: `pdm_ssd.yaml` (pillarize, GridPointBackbone, PDMNeckConv, circle
NMS), `pdm_ssd_aux.yaml` (PointHeadSimple), `pdm_ssd_large.yaml` and flip
TTA, with the flip TTA of `Detector3D` (a pillar config and the sparse
SECOND) beside the PDM family's.

The tiny configs are `utils/synthetic.tiny_grid_cfg` (the JAX package's flip
TTA test shrink of `pdm_ssd.yaml`), `tiny_large_cfg` and, for the aux
variant, `tiny_flagship_cfg` (the JAX dry run's shrink of its base). Inputs
come from numpy seeds; both packages run float32; JAX runs jitted. Each
tolerance stands beside its reason.
"""
import contextlib
import copy
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pdm_ssd_torch.models import build_network, get_host_prepare
from pdm_ssd_torch.models.backbones_2d import pdm_neck_conv as t_neck
from pdm_ssd_torch.models.layers import ConvBNReLU
from pdm_ssd_torch.ops import iou3d as t_iou3d
from pdm_ssd_torch.ops.pillarize import pillarize as t_pillarize
from pdm_ssd_torch.utils import synthetic
from pdm_ssd_torch.utils.config import CfgNode as TCfgNode
from pdm_ssd_torch.utils.config import cfg_from_yaml_file
from pdm_ssd_torch.utils.weights import from_flax, to_flax
from pdm_ssd_tpu.models import build_network as j_build_network
from pdm_ssd_tpu.models import layers as j_layers
from pdm_ssd_tpu.models.backbones_2d import pdm_neck_conv as j_neck
from pdm_ssd_tpu.ops import iou3d as j_iou3d
from pdm_ssd_tpu.ops.pillarize import pillarize as j_pillarize
from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_threads import default_torch_threads  # noqa: F401 (a fixture)
from torch_port_harness import (FlagshipPair, ModelPair, jax_bf16_extraction, jax_train_steps,
                                open_score_gate_flax, randomize_variables, to_numpy)

REPO = Path(__file__).resolve().parents[1]
KITTI_RANGE = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
# a module fed the same inputs: float32 sums in another order only
MODULE_RTOL = 1e-4
# the losses of one batch: float32 sums in another order
LOSS_RTOL = 1e-5
# per-leaf gradients of the grid model, relative L2: float32 rounding of the
# backward's sums (convolutions over whole maps, BatchNorm on batch statistics)
GRAD_REL_L2 = 1e-3
# a detection of one package is the other's when its box agrees to this
# (metres, radians) and its label is the same
BOX_ATOL = 1e-3


def load_cfg(name: str):
    cwd = os.getcwd()
    os.chdir(REPO)          # configs name their base config relative to the repo
    try:
        return cfg_from_yaml_file(f'configs/kitti_models/{name}.yaml', TCfgNode())
    finally:
        os.chdir(cwd)


def assert_close_to_scale(got, want, rtol, name=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f'{name}: max |diff| {err:.3e} > {rtol} * {scale:.3e}'


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield '/'.join(prefix + (k,)), np.asarray(v)


def match_detections(got: dict, want: dict, atol: float = BOX_ATOL) -> int:
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


@pytest.fixture(scope='module')
def grid():
    """From the JAX package's init, on which its checks were measured (from
    the port's seeded weights no box passes the score gate of its predict
    and TTA checks)."""
    return ModelPair(synthetic.tiny_grid_cfg(load_cfg('pdm_ssd')), B=2, N=512, seed=0,
                     jax_init=True)


@pytest.fixture(scope='module')
def aux():
    return ModelPair(synthetic.tiny_flagship_cfg(load_cfg('pdm_ssd_aux')), B=2, N=512, seed=1)


@contextlib.contextmanager
def score_gate_open(pair):
    """The heatmap head's classification bias at 0 in both packages (as
    `synthetic.open_score_gate` sets it), for the comparisons of detections:
    at its initial -2.19 every score lies near the PDM configs' SCORE_THRESH
    of 0.1, where float32 rounding decides which candidates pass."""
    variables = pair.variables
    params = copy.deepcopy(variables['params'])
    params['dense_head']['head']['hm_out']['bias'] = np.zeros_like(
        params['dense_head']['head']['hm_out']['bias'])
    pair.variables = {'params': params, 'batch_stats': variables['batch_stats']}
    pair.net.load_state_dict(from_flax(pair.variables, pair.net))
    try:
        yield pair
    finally:
        pair.variables = variables
        pair.net.load_state_dict(from_flax(variables, pair.net))


# ---- pillarize ---------------------------------------------------------------

def _pillar_points(pc_range, cell, W, H, seed):
    """(B, N, 4) points over the range and beyond it, with points exactly on
    cell edges, on the range's low edges (in), on its high edges (out), just
    below its low edges (out; the float32 below y0, and 1 mm below x0, since
    the float32 below an x0 of 0 is subnormal, which XLA on the CPU flushes
    to 0), and many in a few cells; and a mask that drops some of them."""
    rng = np.random.RandomState(seed)
    B, N = 2, 3000
    x0, y0, z0, x1, y1, z1 = pc_range
    pts = np.stack([rng.uniform(x0 - 3, x1 + 3, (B, N)), rng.uniform(y0 - 3, y1 + 3, (B, N)),
                    rng.uniform(z0, z1, (B, N)), rng.rand(B, N)], -1).astype(np.float32)
    k = np.arange(200)
    pts[:, :200, 0] = (x0 + (k % W) * cell).astype(np.float32)            # on cell edges
    pts[:, :200, 1] = (y0 + (k % H) * cell).astype(np.float32)
    pts[:, 200:210, :2] = [x0, y0]
    pts[:, 210:220, :2] = [x1, y1]
    pts[:, 220:230, :2] = [x0 - 1e-3, np.nextafter(np.float32(y0), np.float32(-1e9))]
    pts[:, 230:900, :2] = pts[:, 230:231, :2] + rng.uniform(0, 0.01, (B, 670, 2))
    mask = rng.rand(B, N) > 0.1
    return pts, mask


@pytest.mark.parametrize('which', ['kitti', 'large'])
def test_pillarize_matches_jax(which):
    """Counts per cell (hence the cell of every point) exact, means within
    1e-5 of their scale (the same float32 sums in another order)."""
    if which == 'kitti':
        pc_range, cell, (W, H) = KITTI_RANGE, 0.2, (352, 400)
    else:
        pc_range, cell, (W, H) = synthetic.LARGE_RANGE, 0.4, (376, 376)
    pts, mask = _pillar_points(pc_range, cell, W, H, seed=3)
    for m in (None, mask):
        want = np.asarray(j_pillarize(jnp.asarray(pts), (W, H), (cell, cell), pc_range,
                                      None if m is None else jnp.asarray(m)))
        got = t_pillarize(torch.from_numpy(pts), (W, H), (cell, cell), pc_range,
                          None if m is None else torch.from_numpy(m)).numpy()
        assert got.shape == want.shape == (2, H, W, 7)
        cnt_got, cnt_want = np.rint(np.expm1(got[..., -1])), np.rint(np.expm1(want[..., -1]))
        np.testing.assert_array_equal(cnt_got, cnt_want)
        assert cnt_want.max() > 100 and (cnt_want > 0).sum() > 1000
        assert cnt_want.sum() < (2 * 3000 if m is None else mask.sum())  # some fell out
        assert_close_to_scale(got[..., :-1], want[..., :-1], 1e-5, 'means')
        np.testing.assert_allclose(got[..., -1], want[..., -1], rtol=1e-6)


# ---- ConvBNReLU, the backbone, the neck -----------------------------------------

@pytest.mark.parametrize('size', [(16, 12), (15, 11)])
@pytest.mark.parametrize('stride', [1, 2])
def test_conv_bn_relu_same_padding_matches_flax(size, stride):
    """flax 'SAME' at stride 2 pads (0, 1) on an even size and (1, 1) on an
    odd one; the port's module agrees to float32 rounding at both, while
    torch's symmetric padding=1 shifts the windows by a cell on the even
    size."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, *size, 6).astype(np.float32)                     # NHWC
    module = j_layers.ConvBNReLU(5, kernel=3, stride=stride)
    variables = randomize_variables(module.init(jax.random.PRNGKey(0), jnp.asarray(x)), 6)
    want = np.asarray(module.apply(variables, jnp.asarray(x)))
    port = ConvBNReLU(6, 5, 3, stride=stride).eval()
    port.load_state_dict(from_flax(variables, port))
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = port(xt).permute(0, 2, 3, 1).numpy()
        naive = torch.relu(port.BatchNorm_0(torch.nn.functional.conv2d(
            xt, port.Conv_0.weight, None, stride, 1))).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, -(-size[0] // stride), -(-size[1] // stride), 5)
    assert_close_to_scale(got, want, MODULE_RTOL, 'ConvBNReLU')
    if stride == 2 and size[0] % 2 == 0:
        assert np.abs(naive - want).max() > 0.1
    else:
        assert_close_to_scale(naive, want, MODULE_RTOL, 'symmetric padding')


def test_weights_cover_every_leaf_and_to_flax_inverts_from_flax(grid):
    n_leaves = sum(a.size for tree in grid.variables.values() for _, a in _leaves(tree))
    n_port = sum(t.numel() for k, t in grid.net.state_dict().items()
                 if not k.endswith('num_batches_tracked'))
    assert n_leaves == n_port
    back = to_flax(grid.net)
    for kind in ('params', 'batch_stats'):
        want, got = dict(_leaves(grid.variables[kind])), dict(_leaves(back[kind]))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    eps = {n: m.eps for n, m in grid.net.named_modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)}
    assert eps['backbone_3d.lvl1_down.BatchNorm_0'] == eps['pdm_neck.bn'] == 1e-3


def test_grid_point_backbone_matches_jax(grid):
    J = grid.jax_out
    with torch.no_grad():
        out = grid.net.backbone_3d({'points': torch.from_numpy(grid.points)})
    assert len(out['multi_scale_bev']) == 3 and out['spatial_features_stride'] == 4
    assert [m.shape[1:3] for m in out['multi_scale_bev']] == [(50, 44), (25, 22), (13, 11)]
    assert 'point_coords' not in out and 'point_features' not in out
    for k in range(3):
        assert_close_to_scale(out['multi_scale_bev'][k].contiguous().numpy(),
                              J['multi_scale_bev'][k], MODULE_RTOL, f'multi_scale_bev[{k}]')


def test_sh_gaussian_kernel_init_is_bit_equal():
    for args in ((5, 9, 4, 1.2), (3, 9, 2, 0.7), (7, 9, 1, 2.0)):
        np.testing.assert_array_equal(t_neck.sh_gaussian_kernel_init(*args),
                                      j_neck.sh_gaussian_kernel_init(*args))


def test_initial_dilate_weight_is_the_jax_init(grid):
    """`build_network(seed=...)` gives `dilate` the JAX package's analytic
    initial kernel bit for bit, whatever the seed."""
    want = from_flax(grid.variables, grid.net)['pdm_neck.dilate.weight']
    cfg = grid.cfg
    for seed in (0, 3):
        net = build_network(cfg.MODEL, 3, cfg.DATA_CONFIG, device='cpu', seed=seed)
        assert torch.equal(net.pdm_neck.dilate.weight, want)
    assert int((want != 0).sum()) < want.numel() // 4


def test_pdm_neck_conv_matches_jax(grid):
    J = grid.jax_out
    with torch.no_grad():
        out = grid.net.pdm_neck({'spatial_features': torch.from_numpy(J['multi_scale_bev'][-1])})
    assert_close_to_scale(out['spatial_features'].contiguous().numpy(), J['spatial_features'],
                          MODULE_RTOL, 'spatial_features')


# ---- circle NMS ----------------------------------------------------------------

def _circle_case(seed):
    """Boxes on a 0.5 m lattice (exact float32 distances) with repeated
    scores: pairs at exactly the radius, chains of suppression, ties."""
    rng = np.random.RandomState(seed)
    B, N = 3, 60
    boxes = np.zeros((B, N, 7), np.float32)
    boxes[..., :2] = rng.randint(0, 8, (B, N, 2)) * 0.5
    boxes[..., 2:6] = 1.0
    scores = rng.randint(0, 6, (B, N)).astype(np.float32) / 8
    valid = rng.rand(B, N) > 0.2
    valid[2] = False
    valid[2, :3] = True
    return boxes, scores, valid


@pytest.mark.parametrize('pre,post', [(32, 16), (32, 40), (80, 100), (80, 8)])
@pytest.mark.parametrize('radius', [0.5, 1.0])
def test_circle_nms_matches_jax_exactly(pre, post, radius):
    """Slot order and keep mask equal to the JAX function's at K below and
    above N, with ties, pairs at exactly the radius and invalid slots."""
    for seed in (0, 1):
        boxes, scores, valid = _circle_case(seed)
        idx, keep = t_iou3d.circle_nms(torch.from_numpy(boxes), torch.from_numpy(scores), radius,
                                       pre, post, torch.from_numpy(valid))
        assert idx.shape == keep.shape == (3, post)
        for b in range(3):
            w_idx, w_keep = j_iou3d.circle_nms(jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                                               radius, pre, post, jnp.asarray(valid[b]))
            np.testing.assert_array_equal(keep[b].numpy(), np.asarray(w_keep), err_msg=str(b))
            np.testing.assert_array_equal(idx[b].numpy(), np.asarray(w_idx), err_msg=str(b))
        assert 0 < int(keep[2].sum()) <= 3 and int(keep[0].sum()) > 3


def test_greedy_suppress_is_the_sequential_greedy_pass():
    """The fixpoint equals the plain greedy loop on random overlap matrices,
    long suppression chains included."""
    rng = np.random.RandomState(8)
    K = 40
    overlap = torch.from_numpy(rng.rand(4, K, K) < 0.15)
    overlap[3] = torch.from_numpy(np.eye(K, k=-1, dtype=bool))       # a chain of K
    valid = torch.from_numpy(rng.rand(4, K) > 0.1)
    valid[3] = True
    got = t_iou3d.greedy_suppress(overlap, valid)
    for b in range(4):
        keep = valid[b].clone()
        for i in range(K):
            keep[i] = valid[b, i] and not bool((overlap[b, i, :i] & keep[:i]).any())
        assert torch.equal(got[b], keep), b
    assert got[3].tolist() == [i % 2 == 0 for i in range(K)]


# ---- the whole tiny pdm_ssd.yaml -------------------------------------------------

def test_forward_matches_jax(grid):
    J = grid.jax_out
    with torch.no_grad():
        T = to_numpy(grid.net(grid.torch_inputs()))
    for k in ('spatial_features', 'spatial_features_2d'):
        assert_close_to_scale(T[k], J[k], MODULE_RTOL, k)
    for k, want in J['center_head_preds'][0].items():
        assert_close_to_scale(T['center_head_preds'][0][k], want, MODULE_RTOL, k)


def test_predict_matches_jax(grid):
    """Circle NMS on the JAX package's own forward outputs: the same slots;
    then `predict` from points: the same detections by box and label."""
    preds = dict(grid.jax_out['center_head_preds'][0])
    preds['hm'] = preds['hm'] + 2.19         # the score gate open, as `score_gate_open` does
    J = {'center_head_preds': [preds]}
    want = grid.jax_method(grid.jax_model.post_process, J)
    with torch.no_grad():
        got = to_numpy(grid.net.post_process({'center_head_preds': [
            {k: torch.from_numpy(v) for k, v in J['center_head_preds'][0].items()}]}))
    for k in ('pred_mask', 'pred_labels'):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got['pred_boxes'], want['pred_boxes'], rtol=1e-6, atol=1e-5)
    assert got['pred_mask'].sum() > 8
    with score_gate_open(grid):
        want = grid.jax_method(grid.jax_model.predict, {'points': grid.points})
        assert match_detections(grid.net.predict(grid.torch_inputs()), want) > 8


@pytest.fixture(scope='module')
def grid_trained(grid):
    net = grid.net
    net.load_state_dict(from_flax(grid.variables, net))
    net.train()
    net.zero_grad()
    try:
        loss, tb = net.forward_with_loss(grid.torch_batch())
        loss.backward()
        grads = to_flax(net, {k: p.grad for k, p in net.named_parameters()})['params']
    finally:
        net.zero_grad()
        net.load_state_dict(from_flax(grid.variables, net))
        net.eval()
    return float(loss.detach()), {k: float(v.detach()) for k, v in tb.items()}, grads


def test_training_loss_and_gradients_match_jax(grid, grid_trained):
    loss, tb, grads = grid_trained
    j_loss, j_tb, j_grads, _ = grid.jax_loss_and_grads()
    assert set(tb) == set(j_tb) == {'hm_loss', 'loc_loss', 'loss'}
    np.testing.assert_allclose(loss, float(j_loss), rtol=LOSS_RTOL)
    for k, v in tb.items():
        np.testing.assert_allclose(v, float(j_tb[k]), rtol=LOSS_RTOL, err_msg=k)
    want, got = dict(_leaves(j_grads)), dict(_leaves(grads))
    assert set(got) == set(want) and len(got) > 40
    for k in sorted(want):
        g, w = got[k].astype(np.float64).ravel(), want[k].astype(np.float64).ravel()
        nw = np.linalg.norm(w)
        rel = np.linalg.norm(g - w) / nw if nw > 0 else np.linalg.norm(g)
        assert rel <= GRAD_REL_L2, f'{k}: relative L2 error {rel:.3e}'
    assert np.linalg.norm(want['pdm_neck/dilate/kernel']) > 0


# parameters after three Adam steps, relative L2 per leaf: Adam divides each
# element's gradient by its own running RMS, so elements whose gradients are
# small beside their leaf's (clipped to a global norm of 10, near Adam's eps)
# turn float32 rounding into a visible share of a step. Measured on this
# batch: 3.6e-4 against the JAX package, and 3.6e-4 between the port's own
# float32 and float64 runs, at the same leaf; worst element 0.38 of the sum
# of the three rates in both comparisons.
STEP_PARAM_REL_L2 = 1e-3
STEP_PARAM_RATE_SHARE = 0.5


def test_three_train_steps_track_jax(grid, default_torch_threads):
    """Three steps of each package's train step from the same state on one
    batch: the loss of each step within 1e-4 relative (measured 9e-6 at
    the third), every leaf of parameters and BatchNorm statistics within
    STEP_PARAM_REL_L2 relative L2, and no element apart by more than
    STEP_PARAM_RATE_SHARE of the three steps' summed rate (Adam moves an
    element by about the rate a step, so no element took a step that the
    other package's did not). It runs at torch's own thread count: on one
    thread torch's CPU sums round otherwise, and one element of
    `pdm_neck/dilate/kernel` then takes an Adam step the JAX package's does
    not."""
    from pdm_ssd_torch.runtime.trainer import create_train_state, make_train_step
    from pdm_ssd_tpu.runtime import optimization as j_opt
    _, sched = j_opt.build_optimizer_and_schedule(
        grid.variables['params'], JCfgNode(grid.cfg.OPTIMIZATION.to_dict()), 10, 2)
    j_losses, j_params, j_stats = jax_train_steps(grid, 3)
    net = grid.net
    net.load_state_dict(from_flax(grid.variables, net))
    optimizer, _ = create_train_state(net, grid.cfg.OPTIMIZATION, 10, 2)
    t_step = make_train_step(net, optimizer)
    try:
        for j_loss in j_losses:
            t_metrics = t_step(grid.torch_batch())
            np.testing.assert_allclose(float(t_metrics['loss']), j_loss, rtol=1e-4)
        got = to_flax(net)
    finally:
        net.load_state_dict(from_flax(grid.variables, net))
        net.eval()
    rates = sum(float(sched(s)) for s in range(3))
    for kind, tree in (('params', j_params), ('batch_stats', j_stats)):
        want = dict(_leaves(tree))
        for k, g in _leaves(got[kind]):
            w = want[k].astype(np.float64)
            rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
            assert rel <= STEP_PARAM_REL_L2, f'{kind}/{k}: relative L2 {rel:.3e}'
            if kind == 'params':
                assert np.abs(g - w).max() <= STEP_PARAM_RATE_SHARE * rates, f'{kind}/{k}'
    before = dict(_leaves(grid.variables['params']))
    assert np.abs(got['params']['pdm_neck']['dilate']['kernel']
                  - before['pdm_neck/dilate/kernel']).max() > 1e-5


# ---- flip TTA --------------------------------------------------------------------

@pytest.mark.parametrize('model,flips', [('grid', ['y']), ('grid', ['x', 'y']),
                                         ('flagship', ['x', 'y'])])
def test_tta_flip_predict_matches_jax(model, flips, grid):
    """`predict` with TTA_FLIP: a forward per flipped axis, boxes and heading
    mirrored back, one joint rotated NMS; detections matched by box and
    label. The flagship's JAX selection extracts in bf16, which the port
    emulates here (`jax_bf16_extraction`) so that both run the same
    arithmetic. Each case compiles its own JAX program, so the flagship
    takes only the case with both axes."""
    pair = grid if model == 'grid' else FlagshipPair(B=2, N=512, seed=3, jax_init=False)
    cfg = TCfgNode(pair.cfg.to_dict())
    cfg.MODEL.POST_PROCESSING.TTA_FLIP = flips
    jcfg = JCfgNode(cfg.to_dict())
    j_model = j_build_network(jcfg.MODEL, num_class=3, dataset_cfg=jcfg.DATA_CONFIG)
    net = build_network(cfg.MODEL, 3, cfg.DATA_CONFIG, device='cpu')
    with score_gate_open(pair):
        want = to_numpy(jax.jit(lambda v, b: j_model.apply(v, b, method=j_model.predict))(
            pair.variables, {'points': pair.points}))
        net.load_state_dict(pair.net.state_dict())
        with jax_bf16_extraction():
            got = net.predict({'points': torch.from_numpy(pair.points)})
            plain = to_numpy(pair.net.predict({'points': torch.from_numpy(pair.points)}))
    assert not np.array_equal(want['pred_boxes'], plain['pred_boxes'])   # the flips count
    assert match_detections(got, want) > 8


TTA_DETECTOR3D = {'centerpoint_pillar': (['x', 'y'], False, 4096),
                  'second_sparse': (['x'], True, 3000)}


def _detector3d_tta(name):
    """(the tiny config with TTA_FLIP, the JAX model of it, the pair of the
    config without it, the flax weights with the classification bias at 0)."""
    flips, voxels, N = TTA_DETECTOR3D[name]
    cfg = synthetic.TINY_CFGS[load_cfg(name).MODEL.NAME](load_cfg(name))
    if name == 'second_sparse':
        cfg.MODEL.BACKBONE_3D.pop('TABLE_DTYPE')      # the JAX ladder would run in bf16
    # the sparse SECOND from the JAX package's init, on which its detections
    # were matched (from the port's seeded weights, boxes of the plain and the
    # flipped pass tie exactly in score, and the two NMS keep different ones)
    pair = ModelPair(cfg, B=2, N=N, seed=3, voxels=voxels, jax_init=name == 'second_sparse')
    tta = TCfgNode(cfg.to_dict())
    tta.MODEL.POST_PROCESSING.TTA_FLIP = flips
    jcfg = JCfgNode(tta.to_dict())
    j_model = j_build_network(jcfg.MODEL, num_class=3, dataset_cfg=jcfg.DATA_CONFIG)
    return tta, j_model, pair, open_score_gate_flax(pair.variables)


@pytest.mark.parametrize('name', sorted(TTA_DETECTOR3D))
def test_detector3d_tta_flip_predict_matches_jax(name):
    """`Detector3D.predict` with TTA_FLIP (a forward per entry on the mirrored
    scene, boxes and heading mirrored back, one joint NMS of the config's
    type): on the tiny `centerpoint_pillar.yaml` (points, circle NMS) and the
    tiny sparse SECOND (a batch prepared once, rotated NMS), the
    classification bias at 0: detections matched by box and label, and the
    flips change them."""
    tta, j_model, pair, variables = _detector3d_tta(name)
    want = to_numpy(jax.jit(lambda v, b: j_model.apply(v, b, method=j_model.predict))(
        variables, pair.inputs))
    net = build_network(tta.MODEL, 3, tta.DATA_CONFIG, device='cpu')
    net.load_state_dict(from_flax(variables, net))
    got = net.predict(pair.torch_inputs())
    pair.net.load_state_dict(from_flax(variables, pair.net))
    plain = to_numpy(pair.net.predict(pair.torch_inputs()))
    assert not np.array_equal(want['pred_boxes'], plain['pred_boxes'])   # the flips count
    assert match_detections(got, want) >= 16


def test_tta_flip_runs_the_flipped_pass_on_the_unflipped_maps():
    """A fault of the reference, copied: the JAX package's `predict` takes a
    batch whose kernel maps were built before the flip and does not rebuild
    them, so the sparse SECOND's flipped pass runs the unflipped maps and
    reorder on features whose x mean is negated. The port's TTA predict is
    that: the joint NMS of the plain pass and of a forward on the flipped
    voxels with the batch's own maps, boxes mirrored back; a pass on maps
    rebuilt for the flipped scene gives other detections."""
    import math
    from pdm_ssd_torch.models import model_nms
    tta, _, pair, variables = _detector3d_tta('second_sparse')
    net = build_network(tta.MODEL, 3, tta.DATA_CONFIG, device='cpu')
    net.load_state_dict(from_flax(variables, net))
    batch = pair.torch_inputs()
    gw = net.grid_size[0]

    def flipped(b):
        b = dict(b)
        b['voxels'] = b['voxels'].clone()
        b['voxels'][..., 0] *= -1.0
        b['points'] = b['points'].clone()
        b['points'][..., 0] *= -1.0
        b['voxel_coords'] = b['voxel_coords'].clone()
        b['voxel_coords'][..., 2] = gw - 1 - b['voxel_coords'][..., 2]
        return b

    def merged(flip_det):
        boxes = flip_det['pred_boxes'].clone()
        boxes[..., 0] *= -1.0
        boxes[..., 6] = math.pi - boxes[..., 6]
        dets = [net.post_process(net(dict(batch))), {**flip_det, 'pred_boxes': boxes}]
        cat = [torch.cat([d[k] for d in dets], 1)
               for k in ('pred_boxes', 'pred_scores', 'pred_labels', 'pred_mask')]
        return dict(zip(('pred_boxes', 'pred_scores', 'pred_labels', 'pred_mask'),
                        model_nms.dispatch_nms(*cat, tta.MODEL.POST_PROCESSING.NMS_CONFIG, 3)))

    with torch.inference_mode():
        stale = merged(net.post_process(net(flipped(batch))))
        raw = {k: v for k, v in flipped(batch).items() if not k.startswith('sp_')}
        rebuilt = merged(net.post_process(net(get_host_prepare(tta.MODEL, tta.DATA_CONFIG)(raw))))
    got = net.predict(batch)
    for k in got:
        assert torch.equal(got[k], stale[k]), k
    assert not torch.equal(got['pred_boxes'], rebuilt['pred_boxes'])


# ---- the auxiliary head ------------------------------------------------------------

def _aux_head_inputs(seed):
    """Point features and coordinates with points inside gt boxes, in the
    0.2 m margin of the enlarged boxes (ignored) and outside both; the last
    box of each cloud masked out."""
    import __graft_entry__ as graft
    rng = np.random.RandomState(seed)
    gt = graft._make_batch(2, 8, M=4, seed=seed)['gt_boxes']
    B, M, P = 2, 4, 40
    local = rng.uniform(-0.65, 0.65, (B, M, P, 3)) * gt[:, :, None, 3:6]
    c, s = np.cos(gt[:, :, None, 6]), np.sin(gt[:, :, None, 6])
    pts = np.stack([gt[:, :, None, 0] + local[..., 0] * c - local[..., 1] * s,
                    gt[:, :, None, 1] + local[..., 0] * s + local[..., 1] * c,
                    gt[:, :, None, 2] + local[..., 2]], -1).reshape(B, M * P, 3)
    mask = np.ones((B, M), bool)
    mask[:, -1] = False
    feats = rng.randn(B, M * P, 24).astype(np.float32)
    return {'point_features': feats, 'point_coords': pts.astype(np.float32), 'gt_boxes': gt,
            'gt_mask': mask}


def test_point_head_simple_matches_jax():
    """Forward within 1e-4 of scale, targets exact (foreground, the ignored
    margin, masked boxes) and the loss within 1e-5 relative, the same
    randomized weights and inputs in both packages."""
    from pdm_ssd_torch.models.dense_heads.point_head_simple import PointHeadSimple
    from pdm_ssd_tpu.models.dense_heads.point_head_simple import PointHeadSimple as JHead
    head_cfg = load_cfg('pdm_ssd_aux').MODEL.POINT_HEAD
    batch = _aux_head_inputs(seed=2)
    j_head = JHead(model_cfg=JCfgNode(head_cfg.to_dict()), input_channels=24, num_class=1)
    variables = randomize_variables(j_head.init(jax.random.PRNGKey(0), dict(batch)), 3, 0.1)
    J = to_numpy(j_head.apply(variables, dict(batch)))
    head = PointHeadSimple(head_cfg, 24, 1).eval()
    head.load_state_dict(from_flax(variables, head))
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        out = head(dict(t_batch))
    for k in ('aux_point_cls_preds', 'aux_point_cls_scores'):
        assert_close_to_scale(out[k].numpy(), J[k], MODULE_RTOL, k)
    J_in = {k: jnp.asarray(v) for k, v in J.items()}
    want_t = to_numpy(j_head.apply(variables, J_in, method=JHead.assign_targets))
    got_t = head.assign_targets(out)
    labels = want_t['aux_point_cls_labels']
    np.testing.assert_array_equal(got_t['aux_point_cls_labels'].numpy(), labels)
    assert (labels == 1).sum() > 20 and (labels == -1).sum() > 5 and (labels == 0).sum() > 20
    j_loss, j_tb = j_head.apply(variables, J_in, want_t, method=JHead.get_loss)
    loss, tb = head.get_loss(out, got_t)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_RTOL)
    assert set(tb) == set(j_tb) == {'aux_point_loss_cls'}


def test_aux_training_loss_and_gradients_match_jax(aux):
    """The tiny aux model's training loss and per-leaf gradients, the JAX
    selection's bf16 extraction emulated, within the budgets pinned for the
    flagship (ROADMAP Queue 3): loss 1e-4 relative, gradients 4e-2 relative
    L2 and cosine 0.999 (the JAX backward rounds the grouping gradient to
    bf16; the port keeps float32)."""
    net = aux.net
    net.load_state_dict(from_flax(aux.variables, net))
    net.train()
    net.zero_grad()
    try:
        with jax_bf16_extraction():
            loss, tb = net.forward_with_loss(aux.torch_batch())
        loss.backward()
        grads = to_flax(net, {k: p.grad for k, p in net.named_parameters()})['params']
    finally:
        net.zero_grad()
        net.load_state_dict(from_flax(aux.variables, net))
        net.eval()
    j_loss, j_tb, j_grads, _ = aux.jax_loss_and_grads()
    assert set(tb) == set(j_tb) == {'aux_point_loss_cls', 'hm_loss', 'loc_loss', 'loss'}
    for k, v in tb.items():
        np.testing.assert_allclose(float(v.detach()), float(j_tb[k]), rtol=1e-4, err_msg=k)
    want, got = dict(_leaves(j_grads)), dict(_leaves(grads))
    assert set(got) == set(want)
    for k in sorted(want):
        g, w = got[k].astype(np.float64).ravel(), want[k].astype(np.float64).ravel()
        nw = np.linalg.norm(w)
        if nw == 0:
            assert np.linalg.norm(g) == 0, k
            continue
        assert np.linalg.norm(g - w) / nw <= 4e-2, k
        assert g @ w / (np.linalg.norm(g) * nw) >= 0.999, k
    assert np.linalg.norm(want['point_head/cls_layers/Dense_0/kernel']) > 0


def test_aux_predict_matches_jax(aux):
    """The auxiliary head is dropped at inference: no vote boxes, no
    calibration; detections matched by box and label."""
    with score_gate_open(aux):
        want = aux.jax_method(aux.jax_model.predict, {'points': aux.points})
        with jax_bf16_extraction():
            got = aux.net.predict({'points': torch.from_numpy(aux.points)})
    assert match_detections(got, want) > 8


# ---- pdm_ssd_large.yaml ------------------------------------------------------------

def test_large_forward_matches_jax_at_its_range():
    pts = synthetic.large_scene_points(2, 4096, seed=2)
    pair = ModelPair(synthetic.tiny_large_cfg(load_cfg('pdm_ssd_large')), B=2, N=4096, seed=2,
                     points=pts)
    J = pair.jax_out
    with torch.no_grad():
        T = to_numpy(pair.net(pair.torch_inputs()))
    assert (pts[..., :2] < 0).any() and np.abs(pts[..., :2]).max() > 70
    for k in range(3):
        assert_close_to_scale(T['multi_scale_bev'][k], J['multi_scale_bev'][k], MODULE_RTOL,
                              f'multi_scale_bev[{k}]')
    for k in ('spatial_features', 'spatial_features_2d'):
        assert_close_to_scale(T[k], J[k], MODULE_RTOL, k)
    for k, want in J['center_head_preds'][0].items():
        assert_close_to_scale(T['center_head_preds'][0][k], want, MODULE_RTOL, k)


# ---- the paths around the models ---------------------------------------------------

def test_tiny_grid_cfg_is_the_jax_tta_test_shrink():
    """`synthetic.tiny_grid_cfg` shrinks `pdm_ssd.yaml` as the JAX package's
    flip-TTA test does (`tests/test_tta_flip.py`), TTA_FLIP aside."""
    m = load_cfg('pdm_ssd').MODEL
    m.BACKBONE_3D.CELL_SIZE = 1.6
    m.BACKBONE_3D.GRID_SIZE = [44, 50]
    m.BACKBONE_3D.NUM_FILTERS = [8, 8, 16]
    m.PDM_NECK.BEV_SIZE = [22, 25]
    m.PDM_NECK.VOXEL_SIZE = [3.2, 3.2, 1.0]
    m.PDM_NECK.NUM_BEV_FEATURES = 8
    m.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 64
    m.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE = 16
    m.DENSE_HEAD.POST_PROCESSING.MAX_OBJ_PER_SAMPLE = 16
    assert synthetic.tiny_grid_cfg(load_cfg('pdm_ssd')).MODEL.to_dict() == m.to_dict()


@pytest.mark.parametrize('name', ['pdm_ssd', 'pdm_ssd_aux', 'pdm_ssd_large'])
def test_configs_as_shipped_build_and_need_no_host_prepare(name):
    cfg = load_cfg(name)
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device='cpu')
    assert get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG) is None
    assert not net.training
    kinds = {type(m).__name__ for m in net.modules()}
    assert ('PointHeadSimple' in kinds) == (name == 'pdm_ssd_aux')
    assert ('PDMNeckConv' in kinds) == (name != 'pdm_ssd_aux')


def test_dryrun_trains_and_predicts_the_grid_config_on_the_cpu(capsys):
    from pdm_ssd_torch.tools.dryrun import dryrun
    for cfg_file in ('configs/kitti_models/pdm_ssd.yaml',
                     'configs/kitti_models/pdm_ssd_large.yaml'):
        assert np.isfinite(dryrun('cpu', cfg_file=cfg_file))
    assert capsys.readouterr().out.count('PDMSSD train step + predict OK') == 2


def test_large_dataset_samples_match_jax(tmp_path):
    """`pdm_ssd_large.yaml`'s data path (its +-75.2 m range, 163840 points a
    cloud) on a 3-frame mini set: every sample of both splits equal to the
    JAX package's under one seed."""
    from pdm_ssd_torch.datasets.kitti import kitti_dataset as t_kitti
    from pdm_ssd_torch.datasets.kitti import synthetic as t_syn
    from pdm_ssd_tpu.datasets.kitti import kitti_dataset as j_kitti
    cfg = load_cfg('pdm_ssd_large')
    cfg.DATA_CONFIG.DATA_PATH = str(tmp_path)
    t_syn.make_mini_kitti(tmp_path)
    t_kitti.create_kitti_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, tmp_path, tmp_path, workers=1)
    for training in (True, False):
        t_ds = t_kitti.KittiDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=training,
                                    root_path=tmp_path)
        j_ds = j_kitti.KittiDataset(JCfgNode(cfg.DATA_CONFIG.to_dict()), cfg.CLASS_NAMES,
                                    training=training, root_path=tmp_path)
        assert len(t_ds) == len(j_ds) == 3
        for i in range(len(t_ds)):
            np.random.seed(40 + i)
            got = t_ds[i]
            np.random.seed(40 + i)
            want = j_ds[i]
            assert got['points'].shape == (163840, 4)
            assert set(got) == set(want)
            for k in want:
                if isinstance(want[k], np.ndarray):
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_train_and_test_clis_run_the_grid_config_on_the_cpu(tmp_path, monkeypatch):
    """`tools/train.py` and `tools/test.py` with the tiny `pdm_ssd.yaml` on a
    mini set: one epoch, its checkpoint, `result.pkl` and the AP lines
    (`runtime/trainer.train_model` and `eval_utils.eval_one_epoch` run
    unchanged)."""
    from pdm_ssd_torch.datasets.kitti import kitti_dataset as t_kitti
    from pdm_ssd_torch.datasets.kitti import synthetic as t_syn
    from pdm_ssd_torch.tools import test as test_cli
    from pdm_ssd_torch.tools import train as train_cli
    root = tmp_path / 'kitti'
    t_syn.make_mini_kitti(root)
    cfg = synthetic.tiny_grid_cfg(load_cfg('pdm_ssd'))
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == 'sample_points':
            proc.NUM_POINTS = {'train': 2048, 'test': 2048}
    t_kitti.create_kitti_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root, root, workers=1)
    d = cfg.to_dict()
    for k in ('TAG', 'EXP_GROUP_PATH'):
        d.pop(k, None)
    cfg_file = tmp_path / 'tiny_grid.yaml'
    cfg_file.write_text(yaml.safe_dump(d))
    out = tmp_path / 'out'
    common = ['--cfg_file', str(cfg_file), '--batch_size', '2', '--workers', '0',
              '--device', 'cpu', '--output_dir', str(out)]
    monkeypatch.chdir(REPO)
    train_cli.main(common + ['--epochs', '1'])
    ckpt = out / 'ckpt' / 'checkpoint_epoch_1.pth'
    assert ckpt.exists()
    test_cli.main(common + ['--ckpt', str(ckpt)])
    assert (out / 'eval' / 'result.pkl').exists()
    log = ''.join(p.read_text() for p in out.rglob('*.log'))
    assert 'Car AP_R40@0.70, 0.70, 0.70' in log and 'recall_rcnn_0.7' in log
