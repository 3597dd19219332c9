"""The multi-head `CenterHead`, its 'vel' and 'iou' branches, the per-class
NMS kinds and `PointResidualCoder` without mean sizes in the port against
the JAX package, on the CPU: the cases of `tests/test_center_head_multihead.py`
each through both packages, and the per-class NMS of `Detector3D`'s
post-processing. The tiny `pdm_ssd_nuscenes.yaml` with `bevfusion.yaml`'s
six head groups, and PDMSSD's per-class NMS, are held in
`tests/test_torch_port_nuscenes.py`.

Inputs come from numpy seeds; both packages run float32; JAX runs jitted
where a module runs. Each tolerance stands beside its reason.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_ssd_torch.models import model_nms as t_nms
from pdm_ssd_torch.models.dense_heads.center_head import CenterHead as TCenterHead
from pdm_ssd_torch.ops import coders as t_coders
from pdm_ssd_torch.ops import iou3d as t_iou3d
from pdm_ssd_torch.ops import losses as t_losses
from pdm_ssd_torch.utils import synthetic
from pdm_ssd_torch.utils.config import CfgNode as TCfgNode
from pdm_ssd_torch.utils.weights import from_flax, to_flax
from pdm_ssd_tpu.models import model_nms as j_nms
from pdm_ssd_tpu.models.dense_heads.center_head import CenterHead as JCenterHead
from pdm_ssd_tpu.ops import coders as j_coders
from pdm_ssd_tpu.ops import iou3d as j_iou3d
from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_harness import (ModelPair, assert_close_to_scale, leaves, randomize_variables,
                                rel_l2, to_numpy, to_torch)

PC = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
CLASSES = ('Car', 'Pedestrian', 'Cyclist')
# a module fed the same inputs: float32 sums in another order only
MODULE_RTOL = 1e-4
# the losses of one batch: float32 sums in another order; the IoU loss reads
# a rotated polygon clip (measured 5e-6 apart at worst)
LOSS_RTOL = 1e-5
# per-leaf gradients of the head alone, relative L2: float32 rounding
HEAD_GRAD_REL_L2 = 1e-4
# target maps and codes: exp, log, cos and sin of numpy-free float32 in two
# libraries, a unit in the last place apart
TARGET_ATOL = 1e-6
# decoded boxes: the gathered maps, atan2 and the cell arithmetic
BOX_ATOL = 1e-4
# the aligned 3D IoU of box pairs: a rotated polygon clip in float32; a box
# clipped by itself lays every edge on an edge, where rounding decides which
# vertices survive (measured 1.3e-5 apart at an identical pair, 1e-6 at the
# others)
ALIGNED_IOU_ATOL = 5e-5


def _head_cfg(groups, extra_heads=None, iou_rect=False):
    head_dict = {
        'center': {'out_channels': 2, 'num_conv': 2},
        'center_z': {'out_channels': 1, 'num_conv': 2},
        'dim': {'out_channels': 3, 'num_conv': 2},
        'rot': {'out_channels': 2, 'num_conv': 2},
    }
    if extra_heads:
        head_dict.update(extra_heads)
    pp = {'SCORE_THRESH': 0.0, 'POST_CENTER_LIMIT_RANGE': [0, -40, -3, 70.4, 40, 1],
          'MAX_OBJ_PER_SAMPLE': 16}
    if iou_rect:
        pp['USE_IOU_TO_RECTIFY_SCORE'] = True
        pp['IOU_RECTIFIER'] = [0.68, 0.71, 0.65]
    return {
        'CLASS_NAMES_EACH_HEAD': groups,
        'SHARED_CONV_CHANNEL': 16,
        'NUM_HM_CONV': 2,
        'SEPARATE_HEAD_CFG': {'HEAD_ORDER': ['center', 'center_z', 'dim', 'rot'],
                              'HEAD_DICT': head_dict},
        'TARGET_ASSIGNER_CONFIG': {'FEATURE_MAP_STRIDE': 1, 'NUM_MAX_OBJS': 8,
                                   'GAUSSIAN_OVERLAP': 0.1, 'MIN_RADIUS': 2},
        'LOSS_CONFIG': {'LOSS_WEIGHTS': {'cls_weight': 1.0, 'loc_weight': 2.0,
                                         'code_weights': [1.0] * 8}},
        'IOU_REG_LOSS': iou_rect,
        'POST_PROCESSING': pp,
    }


class HeadPair:
    """The JAX package's CenterHead and the port's with the same weights
    (randomized BatchNorm statistics, scales and biases), on one seeded
    (B, 50, 44, 16) feature map."""

    def __init__(self, groups, seed, B=2, **kw):
        d = _head_cfg(groups, **kw)
        args = dict(input_channels=16, num_class=3, grid_size=(44, 50), point_cloud_range=PC,
                    voxel_size=(1.6, 1.6), class_names=CLASSES)
        self.jax = JCenterHead(model_cfg=JCfgNode(d), **args)
        self.net = TCenterHead(TCfgNode(d), device='cpu', **args)
        rng = np.random.RandomState(seed)
        self.x = rng.normal(0, 1, (B, 50, 44, 16)).astype(np.float32)
        init = jax.jit(self.jax.init)(jax.random.PRNGKey(seed), {'spatial_features_2d': self.x})
        self.variables = randomize_variables(init, seed + 1, bias_scale=0.1)
        self.net.load_state_dict(from_flax(self.variables, self.net))
        self.net.eval()

    def jax_forward(self):
        return jax.jit(self.jax.apply)(self.variables, {'spatial_features_2d': self.x})

    def jax_targets(self, gt, mask):
        return jax.jit(lambda g, m: self.jax.assign_targets(g, m, (50, 44)))(gt, mask)

    def jax_decode(self, out):
        return to_numpy(jax.jit(functools.partial(
            self.jax.apply, method=self.jax.generate_predicted_boxes))(self.variables, out))

    def port_forward(self):
        return self.net({'spatial_features_2d': torch.from_numpy(self.x)})


def _gt():
    gt = np.zeros((2, 6, 8), np.float32)
    gt[:, :, 0] = np.linspace(10, 60, 6)
    gt[:, :, 1] = np.linspace(-20, 20, 6)
    gt[:, :, 2] = -1.0
    gt[:, :, 3:6] = [3.9, 1.6, 1.56]
    gt[:, :, 6] = np.linspace(-3, 3, 6)
    gt[:, :, 7] = [1, 2, 3, 1, 2, 3]
    mask = np.ones((2, 6), bool)
    mask[1, 5] = False
    return gt, mask


def _compare_targets(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ('inds', 'masks'):
            np.testing.assert_array_equal(to_numpy(g[k]), np.asarray(w[k]), err_msg=k)
        for k in ('heatmaps', 'target_boxes', 'target_boxes_src'):
            np.testing.assert_allclose(to_numpy(g[k]), np.asarray(w[k]), rtol=0,
                                       atol=TARGET_ATOL, err_msg=k)


def _compare_losses(got_tb, want_tb):
    assert set(got_tb) == set(want_tb), (set(got_tb), set(want_tb))
    for k, v in want_tb.items():
        got = got_tb[k].detach() if torch.is_tensor(got_tb[k]) else got_tb[k]
        np.testing.assert_allclose(float(got), float(v), rtol=LOSS_RTOL, err_msg=k)


def test_multihead_forward_targets_and_loss_match_jax():
    """Two head groups (Car; Pedestrian and Cyclist): each group's maps
    within MODULE_RTOL of scale, its targets (a class's local index, the
    other group's boxes masked out) equal, every loss term within LOSS_RTOL."""
    pair = HeadPair([['Car'], ['Pedestrian', 'Cyclist']], seed=0)
    J = pair.jax_forward()
    with torch.no_grad():
        T = pair.port_forward()
    assert [n for n, _ in pair.net.named_children() if n.startswith('head')] == ['head_0',
                                                                                 'head_1']
    assert len(T['center_head_preds']) == 2
    for t_preds, j_preds in zip(T['center_head_preds'], J['center_head_preds']):
        assert set(t_preds) == set(j_preds)
        for k in j_preds:
            assert_close_to_scale(to_numpy(t_preds[k]), np.asarray(j_preds[k]), MODULE_RTOL, k)
    assert T['center_head_preds'][0]['hm'].shape[-1] == 1
    assert T['center_head_preds'][1]['hm'].shape[-1] == 2
    gt, mask = _gt()
    want = pair.jax_targets(gt, mask)
    got = pair.net.assign_targets(torch.from_numpy(gt), torch.from_numpy(mask), (50, 44))
    _compare_targets(got, want)
    assert int(got[0]['masks'].sum()) == 4 and int(got[1]['masks'].sum()) == 7
    _, j_tb = jax.jit(pair.jax.get_loss)(J, want)
    with torch.no_grad():
        _, t_tb = pair.net.get_loss(T, got)
    _compare_losses(t_tb, j_tb)
    assert {'hm_loss_head_0', 'hm_loss_head_1', 'loc_loss_head_1'} <= set(t_tb)


def test_multihead_decode_maps_labels_to_global_ids():
    """Decode of the two groups: 16 slots each side by side, the Car head's
    labels global 0, the other's 1 and 2, and every slot's box, score, label
    and mask as the JAX package decodes them."""
    pair = HeadPair([['Car'], ['Pedestrian', 'Cyclist']], seed=2, B=1)
    J = pair.jax_forward()
    want = pair.jax_decode(J)
    with torch.no_grad():
        got = to_numpy(pair.net.generate_predicted_boxes(pair.port_forward()))
    assert got['pred_boxes'].shape == (1, 32, 7)
    assert set(np.unique(got['pred_labels'][:, :16])) <= {0}
    assert set(np.unique(got['pred_labels'][:, 16:])) <= {1, 2}
    for k in ('pred_labels', 'pred_mask'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got['pred_scores'], want['pred_scores'], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got['pred_boxes'], want['pred_boxes'], rtol=0, atol=BOX_ATOL)


def test_iou_branch_losses_gradients_and_rectification_match_jax():
    """One group with an 'iou' branch, IOU_REG_LOSS and the score
    rectification: the 'iou_loss' and 'iou_reg_loss' terms within
    LOSS_RTOL, every parameter's gradient (through both IoU losses) within
    HEAD_GRAD_REL_L2 relative L2, and the rectified scores within 1e-6."""
    pair = HeadPair([list(CLASSES)], seed=4,
                    extra_heads={'iou': {'out_channels': 1, 'num_conv': 2}}, iou_rect=True)
    gt, mask = _gt()
    targets = pair.jax_targets(gt, mask)
    x = jnp.asarray(pair.x)

    def loss_fn(params):
        out = pair.jax.apply({'params': params, 'batch_stats': pair.variables['batch_stats']},
                             {'spatial_features_2d': x})
        return pair.jax.get_loss(out, targets)

    (_, j_tb), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, pair.variables['params']))
    pair.net.zero_grad()
    t_targets = pair.net.assign_targets(torch.from_numpy(gt), torch.from_numpy(mask), (50, 44))
    loss, t_tb = pair.net.get_loss(pair.port_forward(), t_targets)
    loss.backward()
    assert {'iou_loss', 'iou_reg_loss'} <= set(t_tb)
    _compare_losses(t_tb, j_tb)
    grads = to_flax(pair.net, {k: p.grad for k, p in pair.net.named_parameters()})['params']
    want = dict(leaves(to_numpy(j_grads)))
    got = dict(leaves(grads))
    assert set(got) == set(want)
    for k in want:
        assert rel_l2(got[k], want[k]) <= HEAD_GRAD_REL_L2, (k, rel_l2(got[k], want[k]))
    assert np.abs(got['head/iou_out/kernel']).sum() > 0
    J = pair.jax_forward()
    dec_want = pair.jax_decode(J)
    with torch.no_grad():
        dec_got = to_numpy(pair.net.generate_predicted_boxes(pair.port_forward()))
    np.testing.assert_array_equal(dec_got['pred_labels'], dec_want['pred_labels'])
    np.testing.assert_allclose(dec_got['pred_scores'], dec_want['pred_scores'], rtol=0,
                               atol=1e-6)


def _box_pairs(n, seed):
    rng = np.random.RandomState(seed)
    pred = np.concatenate([rng.uniform(0, 60, (n, 2)), rng.uniform(-2, 0, (n, 1)),
                           rng.uniform(1, 5, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1))],
                          1).astype(np.float32)
    gt = pred + rng.normal(0, 0.5, pred.shape).astype(np.float32)
    gt[:, 3:6] = np.abs(gt[:, 3:6]) + 0.1
    gt[: n // 8] = pred[: n // 8]                     # identical pairs
    gt[n // 8: n // 4, :2] += 30.0                    # disjoint pairs
    return pred, gt


def test_diou_and_aligned_iou3d_match_jax():
    """`bbox3d_overlaps_diou` and `boxes_aligned_iou3d` on 64 seeded pairs
    (identical, near and disjoint): values within 1e-6 and ALIGNED_IOU_ATOL,
    the DIoU's gradient in both boxes within 1e-5 relative L2."""
    pred, gt = _box_pairs(64, 0)
    want = np.asarray(j_iou3d.bbox3d_overlaps_diou(jnp.asarray(pred), jnp.asarray(gt)))
    p, g = torch.from_numpy(pred).requires_grad_(), torch.from_numpy(gt).requires_grad_()
    got = t_iou3d.bbox3d_overlaps_diou(p, g)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    got.sum().backward()
    jg = jax.grad(lambda a, b: j_iou3d.bbox3d_overlaps_diou(a, b).sum(), argnums=(0, 1))(
        jnp.asarray(pred), jnp.asarray(gt))
    assert rel_l2(p.grad.numpy(), np.asarray(jg[0])) <= 1e-5
    assert rel_l2(g.grad.numpy(), np.asarray(jg[1])) <= 1e-5
    want = np.asarray(j_iou3d.boxes_aligned_iou3d(jnp.asarray(pred), jnp.asarray(gt)))
    got = t_iou3d.boxes_aligned_iou3d(torch.from_numpy(pred), torch.from_numpy(gt)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ALIGNED_IOU_ATOL)
    assert np.all(got[:8] > 0.999) and np.all(got[8:16] == 0)


def test_centerhead_iou_losses_match_jax():
    """The two IoU losses alone on seeded slots (some masked): the IoU loss
    within LOSS_RTOL (its target is the aligned IoU's polygon clip; measured
    1.6e-6 apart), the DIoU loss within 1e-6."""
    from pdm_ssd_tpu.ops import losses as j_losses
    pred, gt = _box_pairs(24, 1)
    rng = np.random.RandomState(2)
    iou_preds = rng.uniform(-1, 1, (2, 12)).astype(np.float32)
    mask = rng.rand(2, 12) > 0.3
    args = (pred.reshape(2, 12, 7), mask, gt.reshape(2, 12, 7))
    want = float(j_losses.centerhead_iou_loss(jnp.asarray(iou_preds),
                                              *map(jnp.asarray, args)))
    got = float(t_losses.centerhead_iou_loss(torch.from_numpy(iou_preds),
                                             *map(torch.from_numpy, args)))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    want = float(j_losses.centerhead_iou_reg_loss(*map(jnp.asarray, args)))
    got = float(t_losses.centerhead_iou_reg_loss(*map(torch.from_numpy, args)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _nms_inputs(B, n, seed, tie_levels=None):
    rng = np.random.RandomState(seed)
    boxes = np.concatenate([rng.uniform(5, 45, (B, n, 2)), np.full((B, n, 1), -1.0),
                            np.tile([3.9, 1.6, 1.56], (B, n, 1)),
                            rng.uniform(-np.pi, np.pi, (B, n, 1))], -1).astype(np.float32)
    if tie_levels:
        probs = (rng.randint(1, tie_levels + 1, (B, n, 3)) / tie_levels).astype(np.float32)
    else:
        probs = rng.rand(B, n, 3).astype(np.float32)
    return boxes, probs


def _kept_by_class(boxes, labels, keep, B):
    """Per cloud and class, the kept boxes as a sorted list of rows."""
    out = []
    for b in range(B):
        for c in (1, 2, 3):
            sel = keep[b] & (labels[b] == c)
            out.append(sorted(map(tuple, np.round(boxes[b][sel], 5).tolist())))
    return out


NMS_CFGS = {
    'scalar': {'NMS_THRESH': 0.1, 'NMS_PRE_MAXSIZE': 32, 'NMS_POST_MAXSIZE': 8},
    'per_class': {'NMS_THRESH': [0.1, 0.3, 0.5], 'NMS_PRE_MAXSIZE': [32, 16, 16],
                  'NMS_POST_MAXSIZE': [8, 4, 4]},
}


@pytest.mark.parametrize('ties', [False, True])
@pytest.mark.parametrize('lists', sorted(NMS_CFGS))
def test_multi_classes_nms_matches_jax(lists, ties):
    """`multi_classes_nms` batched in the port, per cloud (vmapped) in the JAX
    package, on 96 candidates of 3 classes: untied scores give the same
    slots, boxes, scores, labels and keep mask; scores tied in four levels
    give the same kept boxes per class (the order among ties may differ)."""
    B, n = 3, 96
    boxes, probs = _nms_inputs(B, n, 5, tie_levels=4 if ties else None)
    d = {'NMS_TYPE': 'multi_classes_nms', **NMS_CFGS[lists]}
    want = to_numpy(jax.jit(jax.vmap(lambda p, b: j_nms.multi_classes_nms(   # one program
        p, b, JCfgNode(d), score_thresh=0.3)))(probs, boxes))
    got = to_numpy(t_nms.multi_classes_nms(torch.from_numpy(probs), torch.from_numpy(boxes),
                                           TCfgNode(d), score_thresh=0.3))
    assert got[0].shape == want[0].shape
    if not ties:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(got[3].sum(1), want[3].sum(1))
        assert (_kept_by_class(got[0], got[2], got[3], B)
                == _kept_by_class(want[0], want[2], want[3], B))
    assert got[3].sum() > 10 and set(np.unique(got[2][got[3]])) == {1, 2, 3}


@pytest.mark.parametrize('ties', [False, True])
@pytest.mark.parametrize('lists', sorted(NMS_CFGS))
def test_class_specific_nms_matches_jax(lists, ties):
    """`class_specific_nms` with a score threshold per class, as
    `multi_classes_nms` is held: the same slots untied, the same kept boxes
    per class tied; within a class no two kept boxes overlap past its
    NMS_THRESH."""
    B, n = 3, 96
    boxes, probs = _nms_inputs(B, n, 6, tie_levels=4 if ties else None)
    scores, labels = probs.max(-1), probs.argmax(-1).astype(np.int32) + 1
    valid = np.random.RandomState(7).rand(B, n) > 0.1
    d = {'NMS_TYPE': 'class_specific_nms', **NMS_CFGS[lists]}
    sth = [0.05, 0.1, 0.2]
    want = to_numpy(jax.jit(jax.vmap(lambda b, s, l, v: j_nms.class_specific_nms(  # one program
        b, s, l, v, JCfgNode(d), 3, score_thresh=sth)))(boxes, scores, labels, valid))
    got = to_numpy(t_nms.class_specific_nms(*map(torch.from_numpy, (boxes, scores, labels,
                                                                    valid)),
                                            TCfgNode(d), 3, score_thresh=sth))
    if not ties:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        assert (_kept_by_class(got[0], got[2], got[3], B)
                == _kept_by_class(want[0], want[2], want[3], B))
    thresh = d['NMS_THRESH'] if isinstance(d['NMS_THRESH'], list) else [d['NMS_THRESH']] * 3
    for b in range(B):
        for c in (1, 2, 3):
            kept = torch.from_numpy(got[0][b][got[3][b] & (got[2][b] == c)])
            if len(kept) > 1:
                iou = t_iou3d.boxes_iou_bev(kept, kept).numpy() - np.eye(len(kept))
                assert iou.max() <= thresh[c - 1] + 1e-4


@pytest.mark.parametrize('extras', [0, 2])
def test_point_residual_coder_without_mean_size_matches_jax(extras):
    """`PointResidualCoder(use_mean_size=False)`: encode within 1e-6 and
    decode back within 1e-5 of the JAX package's, with and without two
    extra columns (velocity), and decode(encode(box)) the box."""
    rng = np.random.RandomState(3)
    n = 50
    boxes = np.concatenate([rng.uniform(-40, 40, (n, 3)), rng.uniform(0.3, 12, (n, 3)),
                            rng.uniform(-3, 3, (n, 1)), rng.normal(0, 3, (n, extras))],
                           1).astype(np.float32)
    points = (boxes[:, :3] + rng.normal(0, 1, (n, 3))).astype(np.float32)
    kw = dict(use_mean_size=False, mean_size=[[3.9, 1.6, 1.56]])
    j_coder = j_coders.build_box_coder('PointResidualCoder', **kw)
    t_coder = t_coders.build_box_coder('PointResidualCoder', **kw)
    assert t_coder.use_mean_size is False
    want = np.asarray(j_coder.encode(jnp.asarray(boxes), jnp.asarray(points)))
    got = t_coder.encode(torch.from_numpy(boxes), torch.from_numpy(points)).numpy()
    assert got.shape == (n, 8 + extras)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    want = np.asarray(j_coder.decode(jnp.asarray(want), jnp.asarray(points)))
    got = t_coder.decode(torch.from_numpy(got), torch.from_numpy(points)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    back = boxes.copy()
    back[:, 6] = np.arctan2(np.sin(boxes[:, 6]), np.cos(boxes[:, 6]))
    np.testing.assert_allclose(got, back, rtol=0, atol=1e-4)


def test_detector3d_multi_classes_nms_takes_the_per_class_scores():
    """`Detector3D` with an anchor head (the tiny `pointpillar.yaml`) and
    NMS_TYPE multi_classes_nms: the post-processing of the same seeded head
    outputs keeps the same slots, boxes, scores and labels in both
    packages, each class's slots its own."""
    from torch_port_harness import load_cfg
    cfg = synthetic.tiny_pointpillar_cfg(load_cfg('pointpillar'))
    nms = cfg.MODEL.POST_PROCESSING.NMS_CONFIG
    nms.NMS_TYPE = 'multi_classes_nms'
    nms.NMS_THRESH = 0.1
    nms.NMS_PRE_MAXSIZE = 32
    nms.NMS_POST_MAXSIZE = 6
    pair = ModelPair(cfg, B=2, N=3000, seed=1, voxels=True)
    with torch.no_grad():
        out = pair.net(pair.torch_inputs())
    rng = np.random.RandomState(4)
    heads = {k: rng.normal(0, 1.5, tuple(out[k].shape)).astype(np.float32)
             for k in ('anchor_cls_preds', 'anchor_box_preds', 'anchor_dir_preds')}
    want = to_numpy(jax.jit(functools.partial(pair.jax_model.apply,
                                              method=pair.jax_model.post_process))(
        pair.variables, heads))
    with torch.no_grad():
        got = to_numpy(pair.net.post_process(to_torch(heads)))
    assert got['pred_mask'].shape == (2, 18)
    for k in ('pred_mask', 'pred_labels', 'pred_scores'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got['pred_boxes'], want['pred_boxes'], rtol=0, atol=BOX_ATOL)
    for c in range(3):
        assert set(np.unique(got['pred_labels'][:, 6 * c:6 * c + 6][
            got['pred_mask'][:, 6 * c:6 * c + 6]])) <= {c + 1}
    assert got['pred_mask'].sum() > 10
