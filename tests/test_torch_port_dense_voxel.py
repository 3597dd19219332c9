"""The dense voxel family of `Detector3D` in the port against the JAX
package, on the CPU: `DenseVoxelBackBone8x` (flax's 'SAME' padding in 3D,
the occupancy pyramid, `REMAT`'s single BatchNorm update), the tiny shrink
of `second.yaml` (`synthetic.tiny_dense_second_cfg`), `HeightCompression`,
`Conv2DCollapse`, `BaseBEVBackbone`'s strided-conv and final-deconv
upsampling, `BaseBEVResBackbone`, `AnchorHeadMulti` and the ATSS assigner.
One set of randomized weights is carried by `from_flax`; inputs come from
numpy seeds; both packages run float32; JAX runs jitted. Each tolerance
stands beside its reason.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_ssd_torch.models.backbones_2d import base_bev_backbone as t_bev
from pdm_ssd_torch.models.backbones_2d import map_to_bev as t_m2b
from pdm_ssd_torch.models.backbones_3d import vfe as t_vfe
from pdm_ssd_torch.models.backbones_3d import voxel_backbone as t_vb
from pdm_ssd_torch.models.dense_heads import anchor_head as t_ah
from pdm_ssd_torch.models.detectors.detector3d import build_voxel_backbone_3d
from pdm_ssd_torch.utils import synthetic
from pdm_ssd_torch.utils.config import CfgNode as TCfgNode
from pdm_ssd_torch.utils.weights import from_flax, to_flax
from pdm_ssd_tpu.models.backbones_2d import base_bev_backbone as j_bev
from pdm_ssd_tpu.models.backbones_2d import map_to_bev as j_m2b
from pdm_ssd_tpu.models.backbones_3d import vfe as j_vfe
from pdm_ssd_tpu.models.backbones_3d import voxel_backbone as j_vb
from pdm_ssd_tpu.models.dense_heads import anchor_head as j_ah
from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_harness import (ModelPair, assert_close_to_scale, hold_to_jax,
                                leaves, load_cfg, match_detections,
                                open_score_gate_flax, port_loss_and_grads,
                                randomize_variables, rel_l2, to_numpy)

# a module or model fed the same inputs: float32 sums in another order only
MODULE_RTOL = 1e-4
# the losses of one batch: float32 sums in another order
LOSS_RTOL = 1e-5
# per-leaf gradients, relative L2: float32 rounding of the backward's sums
GRAD_REL_L2 = 1e-4
# a loss or gradient further than the bounds above from the JAX package's is
# held by `hold_to_jax` to the JAX package's float64 run: the port's float32
# within the bounds above of it, the JAX package's float32 within these.
# Measured on the tiny dense SECOND's batch: the JAX package's location and
# direction losses 1.2e-5 and 6.0e-5 from its float64, the port's 3e-8; its
# gradients up to 4.0e-4 from its float64 at most leaves (its float32 sums
# over the whole volume, 164k cells here), the port's float32 within 1.8e-5
# of it at every leaf, the port's float64 within 2.8e-12
JAX_F32_LOSS_RTOL = 3e-4
JAX_F32_GRAD_REL_L2 = 3e-3
# running statistics after one step, relative L2 per leaf
STATS_REL_L2 = 1e-5
BOX_ATOL = 1e-3


def module_pair(j_module, port, inputs, seed: int) -> tuple:
    """Init the flax module on `inputs`, randomize its variables, load them
    into `port`. Returns (variables, the eval output, the training-mode
    output, the new batch_stats), as numpy, from one jitted program."""
    def copy(b):
        return dict(b) if isinstance(b, dict) else b     # the modules write into a batch

    variables = jax.jit(lambda b: j_module.init(jax.random.PRNGKey(0), copy(b)))(inputs)
    variables = randomize_variables(variables, seed, 0.1)
    port.load_state_dict(from_flax(variables, port))

    def both(v, b):
        train_out, mutated = j_module.apply(v, copy(b), training=True, mutable=['batch_stats'])
        return j_module.apply(v, copy(b)), train_out, mutated.get('batch_stats', {})

    out, train_out, stats = jax.jit(both)(variables, inputs)
    return variables, to_numpy(out), to_numpy(train_out), to_numpy(stats)


# ---- Conv3DBlock, the occupancy pool ----------------------------------------------------

@pytest.mark.parametrize('size', [(6, 8, 10), (5, 7, 9)])
def test_conv3d_block_same_padding_matches_flax(size):
    """flax 'SAME' in 3D at stride 2 pads (0, 1) on an even size and (1, 1)
    on an odd one (D = 5 -> 3 in `second.yaml`'s ladder); the port agrees to
    float32 rounding on every axis, where torch's symmetric padding=1 shifts
    the windows of an even axis by a cell."""
    rng = np.random.RandomState(4)
    stride = 2
    x = rng.randn(2, *size, 3).astype(np.float32)                      # NDHWC
    j_mod = j_vb.Conv3DBlock(features=4, stride=(stride,) * 3)
    port = t_vb.Conv3DBlock(3, 4, stride).eval()
    want = module_pair(j_mod, port, jnp.asarray(x), 5)[1]
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        got = port(xt).permute(0, 2, 3, 4, 1).numpy()
        naive = torch.relu(port.BatchNorm_0(torch.nn.functional.conv3d(
            xt, port.Conv_0.weight, None, stride, 1))).permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == want.shape == (2, *(-(-n // stride) for n in size), 4)
    assert_close_to_scale(got, want, MODULE_RTOL, 'Conv3DBlock')
    if size[0] % 2 == 0:
        assert np.abs(naive - want).max() > 0.1
    else:
        assert_close_to_scale(naive, want, MODULE_RTOL, 'symmetric padding')


# ---- the tiny dense SECOND ----------------------------------------------------------------

def tiny_cfg():
    return synthetic.tiny_dense_second_cfg(load_cfg('second'))


@pytest.fixture(scope='module')
def pair():
    """The tiny dense SECOND in both packages on a training batch of
    LiDAR-like clouds, 8 boxes a cloud, from the JAX package's init, on which
    its training checks were measured (as `torch_port_harness.JAX_INIT_PAIRS`)."""
    return ModelPair(tiny_cfg(), B=2, N=3000, seed=0, voxels=True, bias_scale=0.1,
                     train_boxes=8, jax_init=True)


def test_weights_round_trip_with_conv3d(pair):
    """`from_flax` reaches every tensor, the Conv3d kernels included;
    `to_flax(from_flax(v)) == v`."""
    n_leaves = sum(a.size for tree in pair.variables.values() for _, a in leaves(tree))
    n_port = sum(t.numel() for k, t in pair.net.state_dict().items()
                 if not k.endswith('num_batches_tracked'))
    assert n_leaves == n_port
    back = to_flax(pair.net)
    for kind in ('params', 'batch_stats'):
        want, got = dict(leaves(pair.variables[kind])), dict(leaves(back[kind]))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert back['params']['module_list_1']['conv4']['Conv_0']['kernel'].shape == (3, 3, 3, 8, 8)


def test_dense_backbone_and_head_match_jax(pair):
    """Every stage's features within MODULE_RTOL of scale, the occupancy
    pyramid exact (the 2x2x2 pool with flax 'SAME', depth 20 -> 10 -> 5 ->
    3), the folded BEV map and the head."""
    J = pair.jax_out
    with torch.no_grad():
        T = to_numpy(pair.net(pair.torch_inputs()))
    for k in ('x_conv1', 'x_conv2', 'x_conv3', 'x_conv4'):
        (tf, to, ts), (jf, jo, js) = T['multi_scale_3d_features'][k], \
            J['multi_scale_3d_features'][k]
        assert ts == js
        assert_close_to_scale(tf, jf, MODULE_RTOL, k)
        np.testing.assert_array_equal(to, jo, err_msg=k)
    assert [T['multi_scale_3d_features'][k][1].shape[1] for k in
            ('x_conv1', 'x_conv2', 'x_conv3', 'x_conv4')] == [20, 10, 5, 3]
    assert T['multi_scale_3d_features']['x_conv4'][1].any()
    assert pair.net.backbone_3d.num_bev_features == 8 * 3
    for k in ('dense_voxel_features', 'spatial_features', 'spatial_features_2d',
              'anchor_cls_preds', 'anchor_box_preds', 'anchor_dir_preds'):
        assert_close_to_scale(T[k], J[k], MODULE_RTOL, k)


def test_training_loss_and_gradients_match_jax(pair):
    """The training-mode losses and gradients against the JAX package's;
    any leaf may be held to its float64 run (most stray in the dense
    ladder)."""
    batch = pair.torch_inputs()
    _, tb, grads, _ = port_loss_and_grads(pair, batch)
    _, j_tb, j_grads, _ = pair.jax_loss_and_grads()
    assert set(tb) == set(j_tb) == {'anchor_cls_loss', 'anchor_loc_loss', 'anchor_dir_loss',
                                    'loss'}
    exact = functools.lru_cache(pair.jax_f64_loss_and_grads)
    hold_to_jax(tb, j_tb, lambda: exact()[0], LOSS_RTOL, JAX_F32_LOSS_RTOL, len(tb))
    hold_to_jax(grads, j_grads, lambda: exact()[1], GRAD_REL_L2, JAX_F32_GRAD_REL_L2,
                len(dict(leaves(grads))))


@pytest.mark.parametrize('remat', [True, False])
def test_running_statistics_after_one_step_match_jax(remat, pair):
    """One training step with REMAT on (each 3D block recomputed in the
    backward, `layers.checkpoint_block`) and off: every BatchNorm's running
    statistics within STATS_REL_L2 of the JAX package's step (flax's
    `nn.remat` keeps one update, so its statistics are those of a step
    without it; a recomputation in torch's training mode would make a
    second update), each layer's counter up by 1."""
    j_stats = pair.jax_loss_and_grads()[3]
    bb = pair.net.backbone_3d
    norms = [m for m in bb.modules() if isinstance(m, torch.nn.BatchNorm3d)]
    before = [int(m.num_batches_tracked) for m in norms]
    bb.remat = remat
    try:
        stats = port_loss_and_grads(pair, pair.torch_inputs())[3]
    finally:
        bb.remat = True
    counts = [int(m.num_batches_tracked) - n for m, n in zip(norms, before)]
    want, got = dict(leaves(j_stats)), dict(leaves(stats))
    assert set(got) == set(want)
    for k in want:
        assert rel_l2(got[k], want[k]) <= STATS_REL_L2, k
    assert counts == [1] * 7


def test_remat_step_equals_a_step_without_it(pair):
    """The shipped BatchNorm under `layers.checkpoint_block`: one training
    step with REMAT on gives bit-equal running statistics, losses and
    gradients to one with it off (the recomputation normalises as the first
    pass and updates nothing), and each of the ladder's layers counts one
    update in each step."""
    bb = pair.net.backbone_3d
    norms = [m for m in bb.modules() if isinstance(m, torch.nn.BatchNorm3d)]
    steps = {}
    for remat in (True, False):
        before = [int(m.num_batches_tracked) for m in norms]
        bb.remat = remat
        try:
            steps[remat] = port_loss_and_grads(pair, pair.torch_inputs())
        finally:
            bb.remat = True
        assert [int(m.num_batches_tracked) - n for m, n in zip(norms, before)] == [1] * 7
    (loss, tb, grads, stats), (loss_off, tb_off, grads_off, stats_off) = steps[True], steps[False]
    assert loss == loss_off and tb == tb_off
    for tree, tree_off in ((stats, stats_off), (grads, grads_off)):
        want = dict(leaves(tree_off))
        for k, got in leaves(tree):
            np.testing.assert_array_equal(got, want[k], err_msg=k)
    moved = dict(leaves(pair.variables['batch_stats']['module_list_1']))
    assert all(np.abs(a - moved[k]).max() > 0 for k, a in leaves(stats['module_list_1']))


def test_predict_matches_jax(pair):
    """`predict` with the anchor bias at 0 in both packages: the same boxes
    kept per cloud, matched by box and label."""
    gated = open_score_gate_flax(pair.variables)
    want = to_numpy(jax.jit(lambda v, b: pair.jax_model.apply(v, b, method=pair.jax_model.predict))(
        gated, pair.inputs))
    pair.net.load_state_dict(from_flax(gated, pair.net))
    try:
        got = pair.net.predict(pair.torch_inputs())
    finally:
        pair.net.load_state_dict(from_flax(pair.variables, pair.net))
    assert match_detections(got, want, BOX_ATOL) > 4


# ---- AnchorHeadMulti and ATSS in the tiny PointPillar -------------------------------------

def _head_args(grid=(16, 16)):
    return dict(input_channels=8, num_class=3, class_names=['Car', 'Pedestrian', 'Cyclist'],
                grid_size=grid, point_cloud_range=(0, -16, -3, 32, 16, 1))


def _head_inputs(seed):
    """A random (2, 16, 16, 8) map and 6 boxes a cloud, two masked out, one
    on top of another."""
    gt = synthetic.gt_boxes(2, 6, (0, -16, -3, 32, 16, 1), seed=seed)
    gt[0, 1, :7] = gt[0, 0, :7] + np.float32([0.5, 0.3, 0, 0, 0, 0, 0.2])
    mask = np.ones((2, 6), bool)
    mask[1, -2:] = False
    x = np.random.RandomState(seed + 1).randn(2, 16, 16, 8).astype(np.float32)
    return x, gt, mask


def test_anchor_head_multi_forward_loss_and_gradients_match_jax():
    """`AnchorHeadMulti` (Car alone, Pedestrian with Cyclist) in training
    mode: the assembled anchor-major outputs (foreign classes at -10), the
    loss of the axis-aligned targets and the gradient of every parameter of
    the head and of its input."""
    head = synthetic.tiny_pointpillar_cfg(load_cfg('pointpillar')).MODEL.DENSE_HEAD
    head.NAME = 'AnchorHeadMulti'
    head.SHARED_CONV_NUM_FILTER = 16
    head.RPN_HEAD_CFGS = [{'HEAD_CLS_NAME': ['Car']},
                          {'HEAD_CLS_NAME': ['Pedestrian', 'Cyclist']}]
    j_head = j_ah.AnchorHeadMulti(model_cfg=JCfgNode(head.to_dict()), **_head_args())
    t_head = t_ah.AnchorHeadMulti(head, **_head_args())
    x, gt, mask = _head_inputs(seed=3)
    variables = randomize_variables(jax.jit(lambda b: j_head.init(jax.random.PRNGKey(0), b))(
        {'spatial_features_2d': x}), 4, 0.1)
    t_head.load_state_dict(from_flax(variables, t_head))

    def j_loss(params, x):
        out, _ = j_head.apply({**variables, 'params': params}, {'spatial_features_2d': x},
                              training=True, mutable=['batch_stats'])
        batch = {**out, 'gt_boxes': gt, 'gt_mask': mask}
        loss, tb = j_head.apply(variables, batch, j_head.apply(
            variables, batch, method=j_head.assign_targets), method=j_head.get_loss)
        return loss, (tb, out)

    (loss, (j_tb, J)), (j_grads, j_gx) = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(variables['params'], x)
    xt = torch.from_numpy(x).requires_grad_()
    t_head.train()
    T = t_head({'spatial_features_2d': xt})
    t_loss, tb = t_head.get_loss(T, t_head.assign_targets(
        {'gt_boxes': torch.from_numpy(gt), 'gt_mask': torch.from_numpy(mask)}))
    t_loss.backward()
    for k in ('anchor_cls_preds', 'anchor_box_preds', 'anchor_dir_preds'):
        assert_close_to_scale(T[k].detach().numpy(), to_numpy(J)[k], MODULE_RTOL, k)
    cls = T['anchor_cls_preds'].detach().numpy()
    assert (cls == -10.0).sum() == 2 * cls.size // 3
    np.testing.assert_allclose(float(t_loss.detach()), float(loss), rtol=LOSS_RTOL)
    assert set(tb) == set(j_tb) and float(j_tb['anchor_loc_loss']) > 0
    grads = to_flax(t_head, {k: p.grad for k, p in t_head.named_parameters()})['params']
    for k, w in leaves(to_numpy(j_grads)):
        assert rel_l2(dict(leaves(grads))[k], w) <= GRAD_REL_L2, k
    assert rel_l2(xt.grad.numpy(), np.asarray(j_gx)) <= GRAD_REL_L2


def _atss_head(topk):
    cfg = synthetic.tiny_pointpillar_cfg(load_cfg('pointpillar')).MODEL.DENSE_HEAD
    cfg.TARGET_ASSIGNER_CONFIG.NAME = 'ATSSTargetAssigner'
    cfg.TARGET_ASSIGNER_CONFIG.TOPK = topk
    return (j_ah.AnchorHeadSingle(model_cfg=JCfgNode(cfg.to_dict()), **_head_args()),
            t_ah.AnchorHeadSingle(cfg, **_head_args()))


@pytest.mark.parametrize('topk', [9, 4])
def test_atss_targets_and_loss_match_jax(topk):
    """ATSS labels, box and direction targets exact-to-rounding against the
    JAX package's (distance ties between an anchor's two rotations fall to
    the lower index in both), masked boxes ignored, a box on top of another
    (anchors claimed by two gts keep the higher IoU), then the loss."""
    j_head, t_head = _atss_head(topk)
    x, gt, mask = _head_inputs(seed=7)
    variables = jax.jit(lambda b: j_head.init(jax.random.PRNGKey(0), b))(
        {'spatial_features_2d': x})
    variables = randomize_variables(variables, 9, 0.5)
    t_head.load_state_dict(from_flax(variables, t_head))
    J = to_numpy(jax.jit(j_head.apply)(variables, {'spatial_features_2d': x}))
    j_batch = {**J, 'gt_boxes': gt, 'gt_mask': mask}
    want = to_numpy(jax.jit(lambda v, b: j_head.apply(v, b, method=j_head.assign_targets))(
        variables, j_batch))
    with torch.no_grad():
        T = t_head({'spatial_features_2d': torch.from_numpy(x)})
    got = t_head.assign_targets({'gt_boxes': torch.from_numpy(gt),
                                 'gt_mask': torch.from_numpy(mask)})
    np.testing.assert_array_equal(got['anchor_cls_labels'].numpy(), want['anchor_cls_labels'])
    np.testing.assert_array_equal(got['anchor_dir_targets'].numpy(), want['anchor_dir_targets'])
    np.testing.assert_allclose(got['anchor_box_targets'].numpy(), want['anchor_box_targets'],
                               rtol=0, atol=1e-5)
    labels = want['anchor_cls_labels']
    assert (labels > 0).sum() > mask.sum() and (labels == -1).sum() == 0
    j_loss, j_tb = jax.jit(lambda v, b, t: j_head.apply(v, b, t, method=j_head.get_loss))(
        variables, j_batch, want)
    loss, tb = t_head.get_loss(T, got)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_RTOL)
    assert set(tb) == set(j_tb)


# ---- the modules that raised before, one case each ------------------------------------------

def _case(what, rng):
    """(JAX module, port module, inputs, output key) of one case."""
    if what == 'PillarVFE':
        cfg = {'NAME': 'PillarVFE', 'NUM_FILTERS': [64], 'USE_NORM': True}
        args = ((0.16, 0.16, 4.0), (0, -39.68, -3, 69.12, 39.68, 1))
        B, V, P = 2, 30, 8
        num = rng.randint(0, P + 1, (B, V)).astype(np.int32)
        inputs = {'voxels': rng.randn(B, V, P, 4).astype(np.float32) * 5,
                  'voxel_num_points': num,
                  'voxel_coords': rng.randint(0, 40, (B, V, 3)).astype(np.int32)}
        return (j_vfe.PillarVFE(model_cfg=JCfgNode(cfg), num_point_features=4, voxel_size=args[0],
                                point_cloud_range=args[1]),
                t_vfe.build_vfe(TCfgNode(cfg), 4, *args, grid_size=None), inputs,
                'pillar_features')
    if what == 'MAP_TO_BEV':
        cfg = {'NAME': 'Conv2DCollapse', 'NUM_BEV_FEATURES': 8}
        inputs = {'dense_voxel_features': rng.randn(2, 6, 5, 3, 4).astype(np.float32)}
        return (j_m2b.Conv2DCollapse(model_cfg=JCfgNode(cfg)),
                t_m2b.build_map_to_bev(TCfgNode(cfg), None, 12), inputs, 'spatial_features')
    if what == 'BaseBEVResBackbone':
        cfg = {'NAME': 'BaseBEVResBackbone', 'LAYER_NUMS': [1, 0], 'LAYER_STRIDES': [1, 2],
               'NUM_FILTERS': [8, 16], 'UPSAMPLE_STRIDES': [1, 2],
               'NUM_UPSAMPLE_FILTERS': [8, 8]}
        inputs = {'spatial_features': rng.randn(2, 10, 12, 6).astype(np.float32)}
        return (j_bev.BaseBEVResBackbone(model_cfg=JCfgNode(cfg), input_channels=6),
                t_bev.BaseBEVResBackbone(TCfgNode(cfg), 6), inputs, 'spatial_features_2d')
    head = synthetic.tiny_pointpillar_cfg(load_cfg('pointpillar')).MODEL.DENSE_HEAD
    head.NAME = 'AnchorHeadMulti'
    head.RPN_HEAD_CFGS = [{'HEAD_CLS_NAME': ['Car', 'Cyclist']}, {'HEAD_CLS_NAME': ['Pedestrian']}]
    inputs = {'spatial_features_2d': rng.randn(2, 5, 6, 8).astype(np.float32)}
    return (j_ah.AnchorHeadMulti(model_cfg=JCfgNode(head.to_dict()), **_head_args((6, 5))),
            t_ah.AnchorHeadMulti(head, **_head_args((6, 5))), inputs, 'anchor_cls_preds')


FORMERLY_UNPORTED = ['PillarVFE', 'dense backbone', 'MAP_TO_BEV', 'BaseBEVResBackbone',
                     'AnchorHeadMulti', 'ATSS']


@pytest.mark.parametrize('what', FORMERLY_UNPORTED)
def test_formerly_unported_module_matches_jax(what, request):
    """Each module and option of the voxel family that raised
    `NotImplementedError` before this port built it, built by the port's
    build function where it has one and held against the JAX package's module on
    seeded inputs: the eval forward within MODULE_RTOL of scale, and in
    training mode the output and every running statistic (STATS_REL_L2).
    The dense backbone (by the name `VoxelBackBone8x`) is held inside the
    tiny dense SECOND, its ATSS by its assignments, exact."""
    rng = np.random.RandomState(FORMERLY_UNPORTED.index(what))
    if what == 'dense backbone':
        pair = request.getfixturevalue('pair')
        cfg = TCfgNode({**pair.cfg.MODEL.BACKBONE_3D.to_dict(), 'NAME': 'VoxelBackBone8x'})
        port = build_voxel_backbone_3d(cfg, 4, (64, 64, 20))
        assert isinstance(port, t_vb.DenseVoxelBackBone8x)
        port.load_state_dict(pair.net.backbone_3d.state_dict())
        with torch.no_grad():
            vfe = pair.net.vfe(pair.torch_inputs())
            got = port.eval()(vfe)['spatial_features'].numpy()
        assert_close_to_scale(got, pair.jax_out['spatial_features'], MODULE_RTOL, what)
        return
    if what == 'ATSS':
        anchors = t_ah.generate_anchors(
            [dict(c) for c in load_cfg('pointpillar').MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG],
            (20, 20), (0, -16, -3, 32, 16, 1))[0]
        gts = synthetic.gt_boxes(2, 5, (0, -16, -3, 32, 16, 1), seed=11)
        mask = np.array([[True] * 5, [True, True, True, False, False]])
        labels, gt_of, pos = t_ah.atss_assign(torch.from_numpy(anchors), torch.from_numpy(gts),
                                              torch.from_numpy(mask), 9)
        for b in range(2):
            w_labels, w_gt, w_pos = jax.jit(j_ah.atss_assign_single, static_argnums=(3, 4))(
                jnp.asarray(anchors), jnp.asarray(gts[b]), jnp.asarray(mask[b]), 9, 3)
            np.testing.assert_array_equal(labels[b].numpy(), np.asarray(w_labels))
            np.testing.assert_array_equal(pos[b].numpy(), np.asarray(w_pos))
            np.testing.assert_array_equal(gt_of[b].numpy(), np.asarray(w_gt))
        assert int(mask.sum()) <= int(pos.sum()) < 9 * 8
        return
    j_mod, port, inputs, key = _case(what, rng)
    _, want, want_train, want_stats = module_pair(j_mod, port, dict(inputs), 12)
    want = want[key]
    t_in = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.no_grad():
        got = to_numpy(port.eval()(dict(t_in)))[key]
        got_train = to_numpy(port.train()(dict(t_in)))[key]
    assert_close_to_scale(got, want, MODULE_RTOL, what)
    assert_close_to_scale(got_train, want_train[key], MODULE_RTOL, what)
    stats = dict(leaves(to_flax(port)['batch_stats']))
    assert set(stats) == set(dict(leaves(want_stats))) and len(stats) > 0
    for k, w in leaves(want_stats):
        assert rel_l2(stats[k], w) <= STATS_REL_L2, k


@pytest.mark.parametrize('what', ['HeightCompression', 'HeightCompression DHWC',
                                  'BaseBEVBackbone options'])
def test_map_to_bev_and_bev_options_match_jax(what):
    """`HeightCompression` (the fold as the JAX module reads a 5-D volume,
    and its 'DHWC' layout), and `BaseBEVBackbone` with an upsample stride
    below 1 (a strided conv, flax 'SAME' on an odd size) and one stride more
    than its levels (the final deconv)."""
    rng = np.random.RandomState(21)
    if what.startswith('HeightCompression'):
        x = rng.randn(2, 3, 5, 4, 6).astype(np.float32)
        inputs = {'dense_voxel_features': x}
        if what.endswith('DHWC'):
            inputs['voxel_layout'] = 'DHWC'
        want = np.asarray(j_m2b.HeightCompression(model_cfg=JCfgNode({'NUM_BEV_FEATURES': 0}))
                          .apply({}, dict(inputs))['spatial_features'])
        t_in = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                for k, v in inputs.items()}
        got = t_m2b.HeightCompression(TCfgNode({'NUM_BEV_FEATURES': 0}))(t_in)['spatial_features']
        np.testing.assert_array_equal(got.numpy(), want)
        return
    cfg = {'LAYER_NUMS': [0, 0], 'LAYER_STRIDES': [1, 1], 'NUM_FILTERS': [8, 16],
           'UPSAMPLE_STRIDES': [0.5, 0.5, 2], 'NUM_UPSAMPLE_FILTERS': [8, 8, 4]}
    inputs = {'spatial_features': rng.randn(2, 11, 13, 5).astype(np.float32)}
    j_mod = j_bev.BaseBEVBackbone(model_cfg=JCfgNode(cfg), input_channels=5)
    port = t_bev.BaseBEVBackbone(TCfgNode(cfg), 5)
    assert hasattr(port, 'up0_conv') and hasattr(port, 'up_final_deconv')
    _, want, want_train, want_stats = module_pair(j_mod, port, dict(inputs), 22)
    want = want['spatial_features_2d']
    t_in = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.no_grad():
        got = port.eval()(dict(t_in))['spatial_features_2d'].numpy()
        got_train = port.train()(dict(t_in))['spatial_features_2d'].numpy()
    assert_close_to_scale(got, want, MODULE_RTOL, what)
    assert_close_to_scale(got_train, want_train['spatial_features_2d'], MODULE_RTOL, what)
    stats = dict(leaves(to_flax(port)['batch_stats']))
    for k, w in leaves(want_stats):
        assert rel_l2(stats[k], w) <= STATS_REL_L2, k
