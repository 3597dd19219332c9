"""The two-stage family's shared core in the port against the JAX package, on
the CPU: the corner loss, the proposal targets (`assign_targets` on the same
uniform draw), the ROI losses, PointRCNN's training loss and gradients, the
per-step target generator of the train step, and the voxel pools of PV-RCNN
and Voxel R-CNN (`bilinear_from_bev`, `VoxelNeighborAgg`,
`SparseVoxelNeighborAgg`). Inputs come from numpy seeds; both packages run
float32; JAX runs jitted. Each tolerance stands beside its reason.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_ssd_torch.models.backbones_3d import pfe as t_pfe
from pdm_ssd_torch.models.roi_heads.roi_head_template import RoIHeadTemplate as TTemplate
from pdm_ssd_torch.ops import losses as t_losses
from pdm_ssd_torch.utils import synthetic
from pdm_ssd_torch.utils.weights import from_flax
from pdm_ssd_tpu.models.backbones_3d import pfe as j_pfe
from pdm_ssd_tpu.models.roi_heads.roi_head_template import RoIHeadTemplate as JTemplate
from pdm_ssd_tpu.ops import losses as j_losses
from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_harness import (ModelPair, assert_close_to_scale, hold_to_jax,
                                jax_pool_max_by_argmax, jax_target_draw, leaves, load_cfg,
                                plant_ground_truth,
                                port_loss_and_grads, randomize_variables, rel_l2, to_numpy)

# a module fed the same inputs, float32 on both sides: sums in another order
MODULE_RTOL = 1e-5
# IoUs: the rotated-rectangle clip rounds differently in float32 (1 ulp of
# its intersection points), 4e-6 measured
IOU_ATOL = 1e-5
# the losses of one batch
LOSS_RTOL = 1e-5
# per-leaf gradients, relative L2
GRAD_REL_L2 = 1e-3
# a loss or gradient further than the bounds above from the JAX package's is
# held by `hold_to_jax` to its float64 run; the JAX package's float32 within these
JAX_F32_LOSS_RTOL = 1e-3
JAX_F32_GRAD_REL_L2 = 1e-2
SCORE_TYPES = ['roi_iou', 'cls', 'raw_roi_iou']


def _boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, :3] = rng.uniform(-10, 10, (n, 3))
    b[:, 3:6] = rng.uniform(0.5, 4, (n, 3))
    b[:, 6] = rng.uniform(-4, 4, n)
    return b


def test_corner_loss_lidar_matches_jax():
    """Boxes far apart, near each other, equal, and turned by pi (the flipped
    ground truth's corners coincide: safe_norm's 1e-12 keeps that finite)."""
    rng = np.random.RandomState(0)
    pred, gt = _boxes(rng, 64), _boxes(rng, 64)
    pred[:16] = gt[:16] + rng.normal(0, 0.1, (16, 7)).astype(np.float32)
    pred[16:20] = gt[16:20]
    pred[20:24] = gt[20:24]
    pred[20:24, 6] += np.float32(np.pi)
    want = np.asarray(j_losses.corner_loss_lidar(jnp.asarray(pred), jnp.asarray(gt)))
    got = t_losses.corner_loss_lidar(torch.from_numpy(pred), torch.from_numpy(gt)).numpy()
    assert_close_to_scale(got, want, MODULE_RTOL, 'corner loss')
    assert np.all(got[16:24] < 1e-6)


# ---- the proposal targets and the ROI losses -------------------------------------

def _roi_scene(kind: str, seed: int = 0, R: int = 64, M: int = 6):
    """ROIs drawn around ground-truth boxes (jittered copies), some masked
    out, and a second cloud with fewer boxes. `kind`: 'mixed', 'no_fg' (the
    ROIs far from every box), 'no_easy' (all ROIs near a box), 'no_gt'
    (the second cloud without ground truth)."""
    rng = np.random.RandomState(seed)
    B = 2
    gts = np.zeros((B, M, 8), np.float32)
    for b in range(B):
        gts[b, :, :7] = _boxes(rng, M)
        gts[b, :, 7] = rng.randint(1, 4, M)
    gmask = np.ones((B, M), bool)
    gmask[1, 4:] = False
    rois = np.zeros((B, R, 7), np.float32)
    jitter = {'mixed': 0.4, 'no_fg': 0.4, 'no_easy': 0.15, 'no_gt': 0.4}[kind]
    for b in range(B):
        src = rng.randint(0, 4, R)
        noise = rng.normal(0, jitter, (R, 7)) * [1, 1, 0.3, 0.3, 0.3, 0.3, 0.3]
        rois[b] = gts[b, src, :7] + noise.astype(np.float32)
        rois[b, :, 3:6] = np.abs(rois[b, :, 3:6]) + 0.1
    if kind == 'mixed':
        rois[:, :8, :3] += 40.0                          # easy backgrounds
    if kind == 'no_fg':
        rois[:, :, :3] += 30.0
    if kind == 'no_gt':
        gmask[1] = False
    rmask = rng.rand(B, R) < 0.9
    return {'rois': rois, 'roi_mask': rmask, 'gt_boxes': gts, 'gt_mask': gmask,
            'roi_scores': rng.rand(B, R).astype(np.float32),
            'roi_labels': rng.randint(0, 4, (B, R)).astype(np.int32)}


def _roi_cfg(score_type: str):
    cfg = load_cfg('pv_rcnn').MODEL.ROI_HEAD
    cfg.TARGET_CONFIG.CLS_SCORE_TYPE = score_type
    return cfg


@functools.lru_cache
def _jax_template(score_type: str):
    """The JAX package's ROI template of `_roi_cfg(score_type)` and its
    jitted `assign_targets` and `get_loss`, the key and the scene passed in:
    one program each a score type, shared by every scene, key and test."""
    module = JTemplate(model_cfg=JCfgNode(_roi_cfg(score_type).to_dict()), num_class=3)
    assign = jax.jit(lambda b, k: module.apply({}, b, k, method=JTemplate.assign_targets))
    loss = jax.jit(lambda p, t: module.apply({}, p, t, method=JTemplate.get_loss))
    return module, assign, loss


def _jax_targets(cfg, scene, key):
    module, assign, _ = _jax_template(cfg.TARGET_CONFIG.CLS_SCORE_TYPE)
    return module, to_numpy(assign({k: jnp.asarray(v) for k, v in scene.items()}, key))


def _port_targets(cfg, scene, rand):
    head = TTemplate(cfg, 3)
    batch = {k: torch.from_numpy(v) for k, v in scene.items()}
    batch['roi_target_rand'] = torch.from_numpy(np.array(rand))
    return head, head.assign_targets(batch), batch


INDEX_KEYS = ('roi_mask', 'reg_valid_mask')


@pytest.mark.parametrize('kind', ['mixed', 'no_fg', 'no_easy', 'no_gt'])
@pytest.mark.parametrize('score_type', SCORE_TYPES)
def test_assign_targets_match_jax_on_the_same_draw(score_type, kind):
    """The JAX draw (`jax.random.uniform(key, roi_mask.shape)`) fed to the
    port as 'roi_target_rand': the same ROIs in the same order (the ROIs
    themselves, their matched ground truth and the reordered scores and
    labels bit-equal), the same masks, the labels and residuals to float32
    rounding of the IoU."""
    cfg = _roi_cfg(score_type)
    scene = _roi_scene(kind)
    key = jax.random.PRNGKey(3)
    _, want = _jax_targets(cfg, scene, key)
    rand = np.asarray(jax.random.uniform(key, scene['roi_mask'].shape))
    _, got, batch = _port_targets(cfg, scene, rand)
    got = to_numpy(got)
    for k in ('rois', 'gt_of_roi') + INDEX_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(batch['roi_labels'].numpy(), np.asarray(
        np.take_along_axis(scene['roi_labels'], _order_of(got['rois'], scene['rois']), 1)))
    np.testing.assert_allclose(got['roi_ious'], want['roi_ious'], atol=IOU_ATOL)
    # labels: 0/1/-1 exactly away from the thresholds, the interpolation to
    # the IoU's rounding over the 0.5 span
    np.testing.assert_allclose(got['rcnn_cls_labels'], want['rcnn_cls_labels'],
                               atol=IOU_ATOL / 0.5)
    assert_close_to_scale(got['rcnn_reg_targets'], want['rcnn_reg_targets'], MODULE_RTOL,
                          'rcnn_reg_targets')
    n_fg = got['reg_valid_mask'].sum()
    assert (n_fg == 0) == (kind == 'no_fg')
    assert got['roi_mask'].shape == (2, cfg.TARGET_CONFIG.ROI_PER_IMAGE)


def _order_of(out_rois, rois):
    """The index into `rois` of each output ROI (ROIs are distinct)."""
    eq = (out_rois[:, :, None, :] == rois[:, None, :, :]).all(-1)
    return eq.argmax(-1)


def test_assign_targets_draw_from_the_generator():
    """Without 'roi_target_rand' the draw is one (B, R) uniform tensor from
    the generator: the same generator state gives the same targets, another
    seed other ones, and no generator the generator seeded with 0."""
    cfg = _roi_cfg('roi_iou')
    scene = _roi_scene('mixed')
    head = TTemplate(cfg, 3)

    def order(gen):
        batch = {k: torch.from_numpy(v) for k, v in scene.items()}
        return head.assign_targets(batch, gen)['rois']

    rand = torch.rand((2, 64), generator=torch.Generator().manual_seed(5))
    batch = {k: torch.from_numpy(v) for k, v in scene.items()}
    batch['roi_target_rand'] = rand
    fed = head.assign_targets(batch)['rois']
    assert torch.equal(order(torch.Generator().manual_seed(5)), fed)
    assert not torch.equal(order(torch.Generator().manual_seed(6)), fed)
    assert torch.equal(order(None), order(torch.Generator().manual_seed(0)))


@pytest.mark.parametrize('score_type', SCORE_TYPES)
def test_roi_losses_match_jax(score_type):
    """`get_loss` on the same targets and random predictions: each term."""
    cfg = _roi_cfg(score_type)
    scene = _roi_scene('mixed')
    key = jax.random.PRNGKey(4)
    module, want_t = _jax_targets(cfg, scene, key)
    head, got_t, _ = _port_targets(cfg, scene,
                                   np.asarray(jax.random.uniform(key, scene['roi_mask'].shape)))
    rng = np.random.RandomState(1)
    R = cfg.TARGET_CONFIG.ROI_PER_IMAGE
    preds = {'rcnn_cls_preds': rng.randn(2, R, 1).astype(np.float32),
             'rcnn_reg_preds': (rng.randn(2, R, 7) * 0.3).astype(np.float32)}
    loss, tb = _jax_template(score_type)[2](preds, want_t)
    got, got_tb = head.get_loss({k: torch.from_numpy(v) for k, v in preds.items()}, got_t)
    assert set(got_tb) == set(tb) == {'rcnn_cls_loss', 'rcnn_reg_loss', 'rcnn_corner_loss'}
    for k in tb:
        assert abs(float(got_tb[k]) - float(tb[k])) <= LOSS_RTOL * abs(float(tb[k])), k
    assert abs(float(got) - float(loss)) <= LOSS_RTOL * abs(float(loss))
    assert float(tb['rcnn_corner_loss']) > 0


def test_corner_loss_is_finite_where_the_jax_one_is_nan():
    """The one deliberate difference (ROADMAP Queue 3): one background slot
    whose size residual overflows (exp(100) in float32 is inf) makes the JAX
    package's corner loss inf * 0 = NaN; the port's decodes the foreground
    only and gives the JAX value of the same batch without that overflow,
    with finite gradients."""
    cfg = _roi_cfg('roi_iou')
    scene = _roi_scene('mixed')
    key = jax.random.PRNGKey(4)
    module, want_t = _jax_targets(cfg, scene, key)
    head, got_t, _ = _port_targets(cfg, scene,
                                   np.asarray(jax.random.uniform(key, scene['roi_mask'].shape)))
    rng = np.random.RandomState(2)
    R = cfg.TARGET_CONFIG.ROI_PER_IMAGE
    reg = (rng.randn(2, R, 7) * 0.3).astype(np.float32)
    bg = np.argwhere(~got_t['reg_valid_mask'].numpy())[0]
    blown = reg.copy()
    blown[bg[0], bg[1], 3] = 100.0
    cls = rng.randn(2, R, 1).astype(np.float32)
    want_t = jax.tree_util.tree_map(jnp.asarray, want_t)

    def j_loss(r):
        return module.apply({}, {'rcnn_cls_preds': cls, 'rcnn_reg_preds': r}, want_t,
                            method=JTemplate.get_loss)

    # the JAX value is NaN run op by op, and so are the loss and every
    # gradient of its jitted training form (value and gradient together)
    assert np.isnan(float(j_loss(blown)[1]['rcnn_corner_loss']))
    value, grad = jax.jit(jax.value_and_grad(lambda r: j_loss(r)[0]))(blown)
    assert np.isnan(float(value)) and not np.isfinite(np.asarray(grad)).all()
    clean_tb = jax.jit(lambda r: j_loss(r)[1])(reg)
    reg_t = torch.from_numpy(blown).requires_grad_()
    loss, tb = head.get_loss({'rcnn_cls_preds': torch.from_numpy(cls), 'rcnn_reg_preds': reg_t},
                             got_t)
    loss.backward()
    want = float(clean_tb['rcnn_corner_loss'])
    assert abs(float(tb['rcnn_corner_loss'].detach()) - want) <= LOSS_RTOL * want
    assert torch.isfinite(reg_t.grad).all()
    assert float(reg_t.grad[bg[0], bg[1]].abs().sum()) < 1e-3  # a background slot: the BCE only


# ---- PointRCNN's training ---------------------------------------------------------

@pytest.fixture(scope='module')
def rcnn():
    """The tiny PointRCNN (`synthetic.tiny_pointrcnn_cfg`) with its FP list
    made whole, in both packages, ground truth planted on its proposals.
    The seeded point head's proposals are a few centimetres wide: pooled
    from the ROIs enlarged by 2 m they hold points, where otherwise every
    pooled block is zero and the ROI head's batch statistics degenerate
    (variance 0, gradients near 1e10 that neither package's float32 holds)."""
    cfg = synthetic.tiny_pointrcnn_cfg(synthetic.pointrcnn_fp3(load_cfg('pointrcnn')))
    cfg.MODEL.ROI_HEAD.ROI_POINT_POOL.POOL_EXTRA_WIDTH = [2.0, 2.0, 2.0]
    rng = np.random.RandomState(20)
    pts = np.stack([rng.uniform(0, 12, (2, 384)), rng.uniform(-6, 6, (2, 384)),
                    rng.uniform(-2, 0, (2, 384)), rng.rand(2, 384)], -1).astype(np.float32)
    pair = ModelPair(cfg, B=2, N=384, seed=0, points=pts, bias_scale=0.1)
    plant_ground_truth(pair)
    return pair


def test_pointrcnn_training_loss_and_gradients_match_jax(rcnn):
    """`PointRCNN.forward_with_loss` on the JAX draw: the targets exact (the
    ROIs' order, the masks, the labels), every loss term, every gradient;
    the foreground ROIs make the box and corner losses count."""
    batch = rcnn.torch_batch()
    batch['roi_target_rand'] = jax_target_draw(rcnn)
    net = rcnn.net
    net.train()
    try:
        with torch.no_grad():
            out = net(dict(batch))
    finally:
        net.eval()
    want = rcnn.jax_train_forward()
    got_t, want_t = to_numpy(out['roi_targets']), want['roi_targets']
    for k in ('roi_mask', 'reg_valid_mask', 'gt_of_roi'):
        np.testing.assert_array_equal(got_t[k], want_t[k], err_msg=k)
    np.testing.assert_allclose(got_t['rcnn_cls_labels'], want_t['rcnn_cls_labels'], atol=1e-5)
    assert_close_to_scale(got_t['rois'], want_t['rois'], 1e-4, 'rois')
    assert want_t['reg_valid_mask'].sum() >= 4
    _, tb, grads, _ = port_loss_and_grads(rcnn, batch)
    _, j_tb, j_grads, _ = rcnn.jax_loss_and_grads()
    assert set(tb) == set(j_tb) >= {'point_loss_cls', 'rcnn_cls_loss', 'rcnn_reg_loss',
                                    'rcnn_corner_loss', 'loss'}
    assert j_tb['rcnn_corner_loss'] > 0 and j_tb['rcnn_reg_loss'] > 0
    exact = functools.lru_cache(rcnn.jax_f64_loss_and_grads)
    hold_to_jax(tb, j_tb, lambda: exact()[0], LOSS_RTOL, JAX_F32_LOSS_RTOL, 2)
    hold_to_jax(grads, j_grads, lambda: exact()[1], GRAD_REL_L2, JAX_F32_GRAD_REL_L2, 4)


def test_pointrcnn_predict_needs_eval_mode(rcnn):
    rcnn.net.train()
    try:
        with pytest.raises(RuntimeError, match='eval'):
            rcnn.net.predict({'points': torch.from_numpy(rcnn.points)})
    finally:
        rcnn.net.eval()


def test_train_step_draws_each_step_from_the_step_count(rcnn):
    """`make_train_step` seeds its generator from the optimizer's update
    count before each step: two runs from the same
    weights give the same losses (to the CPU's float32 sums in another
    order), a resumed count the same draw as an unbroken run, and each step
    a draw of its own."""
    from pdm_ssd_torch.runtime.trainer import create_train_state, make_train_step
    batch = rcnn.torch_batch()
    seen = []
    template = rcnn.net.roi_head
    orig = type(template).assign_targets

    def spy(self, b, generator=None):
        seen.append(generator.initial_seed())
        return orig(self, b, generator)

    def run(start: int):
        rcnn.net.load_state_dict(from_flax(rcnn.variables, rcnn.net))
        optimizer, _ = create_train_state(rcnn.net, rcnn.cfg.OPTIMIZATION, 10, 1)
        optimizer.count = start
        step = make_train_step(rcnn.net, optimizer)
        return [float(step(dict(batch))['loss']) for _ in range(2)]

    type(template).assign_targets = spy
    try:
        a, b = run(0), run(0)
        seen_a = seen[:2]
        seen.clear()
        run(1)
    finally:
        type(template).assign_targets = orig
        rcnn.net.load_state_dict(from_flax(rcnn.variables, rcnn.net))
        rcnn.net.eval()
    np.testing.assert_allclose(a, b, rtol=1e-6)
    assert seen_a[0] != seen_a[1] and seen[0] == seen_a[1]


# ---- the voxel pools ----------------------------------------------------------------

def test_bilinear_from_bev_matches_jax():
    """Keypoints inside the map, on its last row and column, and outside
    (the clipped corner): the same values to float32 rounding; a stride of 8
    where the batch gives none."""
    rng = np.random.RandomState(0)
    bev = rng.randn(2, 10, 12, 5).astype(np.float32)
    pr, vs = (0.0, -4.0, -3.0, 9.6, 4.0, 1.0), (0.1, 0.1, 0.2)
    kp = np.stack([rng.uniform(-1, 11, (2, 40)), rng.uniform(-5, 5, (2, 40)),
                   rng.uniform(-3, 1, (2, 40))], -1).astype(np.float32)
    kp[0, 0, :2] = [9.6, 4.0]
    want = np.asarray(j_pfe.bilinear_from_bev(jnp.asarray(bev), jnp.asarray(kp), pr, vs, 8))
    got = t_pfe.bilinear_from_bev(torch.from_numpy(bev), torch.from_numpy(kp), pr, vs, 8)
    assert_close_to_scale(got.numpy(), want, MODULE_RTOL, 'bilinear')


def _sparse_scene(seed: int = 0):
    """The JAX package's dense-equals-sparse case
    (`tests/test_sparse_two_stage.py:28`): 60 active cells of a 5 x 10 x 12
    grid in 80 slots a cloud, their dense volume and occupancy, 40 keypoints
    over the range (some outside it)."""
    rng = np.random.RandomState(seed)
    D, H, W = dims = (5, 10, 12)
    B, n, cap, C = 2, 60, 80, 6
    coords = np.zeros((B, cap, 3), np.int32)
    mask = np.zeros((B, cap), bool)
    feats = rng.randn(B, cap, C).astype(np.float32)
    for b in range(B):
        flat = np.sort(rng.choice(D * H * W, size=n, replace=False))
        coords[b, :n] = np.stack([flat // (H * W), (flat // W) % H, flat % W], -1)
        mask[b, :n] = True
    feats[~mask] = 0
    vol = np.zeros((B, D, H, W, C), np.float32)
    occ = np.zeros((B, D, H, W), bool)
    for b in range(B):
        c = coords[b][mask[b]]
        vol[b, c[:, 0], c[:, 1], c[:, 2]] = feats[b][mask[b]]
        occ[b, c[:, 0], c[:, 1], c[:, 2]] = True
    # cells the dense ladder computes but no voxel occupies carry features too
    vol += (~occ[..., None]) * rng.randn(B, D, H, W, C).astype(np.float32)
    vs = (0.2, 0.25, 0.3)
    pr = (0.0, -1.25, -0.75, 0.2 * W, 1.25, 0.75)
    kp = np.stack([rng.uniform(pr[0] - 0.3, pr[3] + 0.3, (B, 40)),
                   rng.uniform(pr[1], pr[4], (B, 40)),
                   rng.uniform(pr[2], pr[5], (B, 40))], -1).astype(np.float32)
    return dims, vs, pr, vol, occ, feats, coords, mask, kp


@pytest.mark.parametrize('sparse', [False, True])
def test_voxel_neighbor_agg_matches_jax(sparse):
    """The dense and the sparse window pool against the JAX modules, in eval
    and in training mode (batch statistics over all 27 rows of every window,
    those outside the volume and the unoccupied ones included, so the rows
    fetched there must be the JAX package's), and the running statistics
    after the training pass."""
    dims, vs, pr, vol, occ, feats, coords, mask, kp = _sparse_scene()
    mlp = [8, 16]
    if sparse:
        j_mod = j_pfe.SparseVoxelNeighborAgg(mlp=mlp, downsample=1, voxel_size=vs, pc_range=pr,
                                             dims=dims)
        j_in = (jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(mask), jnp.asarray(kp))
        port = t_pfe.SparseVoxelNeighborAgg(6, mlp, vs, pr)
        t_in = (torch.from_numpy(feats), torch.from_numpy(coords), torch.from_numpy(mask),
                torch.from_numpy(kp), 1, dims)
    else:
        j_mod = j_pfe.VoxelNeighborAgg(mlp=mlp, downsample=1, voxel_size=vs, pc_range=pr)
        j_in = (jnp.asarray(vol), jnp.asarray(occ), jnp.asarray(kp))
        port = t_pfe.VoxelNeighborAgg(6, mlp, vs, pr)
        t_in = (torch.from_numpy(vol), torch.from_numpy(occ), torch.from_numpy(kp), 1)
    variables = randomize_variables(jax.jit(lambda *a: j_mod.init(jax.random.PRNGKey(0), *a))(
        *j_in), 1, 0.1)
    port.load_state_dict(from_flax(variables, port))

    def both(v, *a):
        train, mutated = j_mod.apply(v, *a, training=True, mutable=['batch_stats'])
        return j_mod.apply(v, *a), train, mutated['batch_stats']

    want, want_train, want_stats = to_numpy(jax.jit(both)(variables, *j_in))
    with torch.no_grad():
        got = port.eval()(*t_in).numpy()
        got_train = port.train()(*t_in).numpy()
    port.eval()
    assert_close_to_scale(got, want, MODULE_RTOL, 'eval')
    assert_close_to_scale(got_train, want_train, 1e-4, 'train')
    assert np.abs(want).max() > 0 and (np.abs(want).sum(-1) == 0).any()
    stats = {f'bn{i}': {'mean': getattr(port, f'bn{i}').running_mean.numpy(),
                        'var': getattr(port, f'bn{i}').running_var.numpy()}
             for i in range(len(mlp))}
    for k, v in leaves(want_stats):
        assert rel_l2(dict(leaves(stats))[k], v) <= 1e-5, k


@pytest.mark.parametrize('sparse', [False, True])
def test_jax_pools_jitted_max_gradient_strays_and_the_argmax_route_agrees(sparse):
    """Why the training tests give the JAX pools an argmax-routed max
    (`torch_port_harness.jax_pool_max_by_argmax`): in float64, on the pool's
    training-mode program (Dense, batch statistics, a max over the occupied
    rows of each window), XLA:CPU's jitted gradient of `jnp.max` strays from
    the same gradient run op by op, and its derivative along a random
    direction from the central finite difference, by far more than float64
    rounding; with the argmax route (the same forward) the jitted gradient
    equals the op-by-op one and gives the finite difference."""
    from jax.flatten_util import ravel_pytree
    dims, vs, pr, vol, occ, feats, coords, mask, kp = _sparse_scene()
    mlp = [8, 16]
    if sparse:
        mod = j_pfe.SparseVoxelNeighborAgg(mlp=mlp, downsample=1, voxel_size=vs, pc_range=pr,
                                           dims=dims)
        args = (feats.astype(np.float64), coords, mask, kp.astype(np.float64))
    else:
        mod = j_pfe.VoxelNeighborAgg(mlp=mlp, downsample=1, voxel_size=vs, pc_range=pr)
        args = (vol.astype(np.float64), occ, kp.astype(np.float64))
    rng = np.random.default_rng(0)
    w = rng.normal(size=(2, 40, mlp[-1]))
    with jax.enable_x64(True):
        variables = randomize_variables(jax.jit(lambda *a: mod.init(jax.random.PRNGKey(0), *a))(
            *args), 1, 0.1)
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        flat, unravel = ravel_pytree(variables['params'])
        d = rng.normal(size=flat.shape)

        def loss(f):
            out, _ = mod.apply({'params': unravel(f), 'batch_stats': variables['batch_stats']},
                               *args, training=True, mutable=['batch_stats'])
            return jnp.sum(out * w)

        jitted = np.asarray(jax.jit(jax.grad(loss))(flat))
        with jax.disable_jit():
            eager = np.asarray(jax.grad(loss)(flat))
        fd = float(jax.jit(loss)(flat + 1e-6 * d) - jax.jit(loss)(flat - 1e-6 * d)) / 2e-6
        with jax_pool_max_by_argmax():
            routed = np.asarray(jax.jit(jax.grad(loss))(flat))
            routed_fd = float(jax.jit(loss)(flat + 1e-6 * d)
                              - jax.jit(loss)(flat - 1e-6 * d)) / 2e-6
    assert abs(eager @ d - fd) < 1e-6 * abs(fd)
    assert rel_l2(jitted, eager) > 0.1
    assert abs(jitted @ d - fd) > 0.1 * abs(fd)
    assert routed_fd == fd
    assert rel_l2(routed, eager) < 1e-12
    assert abs(routed @ d - fd) < 1e-6 * abs(fd)


def test_sparse_voxel_agg_equals_the_dense_one():
    """In the port, the sparse pool on the slot table equals the dense pool on
    the densified stage with the same weights (the JAX package's own test),
    here with zero features in the unoccupied cells as a densified stage has."""
    dims, vs, pr, _, occ, feats, coords, mask, kp = _sparse_scene(3)
    vol = np.zeros(occ.shape + (6,), np.float32)
    for b in range(2):
        c = coords[b][mask[b]]
        vol[b, c[:, 0], c[:, 1], c[:, 2]] = feats[b][mask[b]]
    dense = t_pfe.VoxelNeighborAgg(6, [8, 16], vs, pr)
    sparse = t_pfe.SparseVoxelNeighborAgg(6, [8, 16], vs, pr)
    synthetic.randomize_bn(dense, torch.Generator().manual_seed(1))
    sparse.load_state_dict(dense.state_dict())
    with torch.no_grad():
        want = dense.eval()(torch.from_numpy(vol), torch.from_numpy(occ), torch.from_numpy(kp), 1)
        got = sparse.eval()(torch.from_numpy(feats), torch.from_numpy(coords),
                            torch.from_numpy(mask), torch.from_numpy(kp), 1, dims)
    assert float(want.abs().max()) > 0
    assert_close_to_scale(got.numpy(), want.numpy(), 1e-6, 'sparse vs dense')


def test_sparse_stage_dims_match_jax():
    for cfg_name in ('pv_rcnn_sparse', 'voxel_rcnn_sparse'):
        ds = load_cfg(cfg_name).DATA_CONFIG
        pr = tuple(ds.POINT_CLOUD_RANGE)
        vs = (0.05, 0.05, 0.1)
        for stride in (1, 2, 4, 8):
            assert t_pfe.sparse_stage_dims(pr, vs, stride) == tuple(
                int(v) for v in j_pfe.sparse_stage_dims(pr, vs, stride))


# ---- what waits for later ---------------------------------------------------------

@pytest.mark.parametrize('name', ['SECONDNetIoU', 'PartA2Net', 'PVRCNNPlusPlus'])
def test_later_two_stage_detectors_name_their_roadmap_item(name):
    """The detectors that waited for ROADMAP Queue 1 item 11 are ported: each
    builds from its own config's tiny shrink, and PV-RCNN's config under
    their name builds the same modules as PV-RCNN's (the JAX package builds
    every one of them as a PVRCNN subclass)."""
    from pdm_ssd_torch.models import build_network
    own = {'SECONDNetIoU': 'second_iou', 'PartA2Net': 'parta2',
           'PVRCNNPlusPlus': 'pv_rcnn_plusplus'}[name]
    cfg = load_cfg(own)
    synthetic.TINY_CFGS[name](cfg)
    assert type(build_network(cfg.MODEL, 3, cfg.DATA_CONFIG, device='cpu')).__name__ == name
    if name == 'PVRCNNPlusPlus':
        cfg = load_cfg('pv_rcnn')
        cfg.MODEL.NAME = name
        net = build_network(cfg.MODEL, 3, cfg.DATA_CONFIG, device='cpu')
        assert hasattr(net.pfe, 'sa_raw') and not net.pfe.spc


@pytest.mark.parametrize('what', ['VectorPoolAgg', 'SPC'])
def test_pv_rcnn_plusplus_sources_name_their_roadmap_item(what):
    """PV-RCNN++'s two sources are ported (ROADMAP Queue 1 item 11): each
    switched on alone in PV-RCNN's shrink builds its module; an unknown
    SAMPLE_METHOD still raises."""
    from pdm_ssd_torch.models import build_network
    cfg = synthetic.tiny_pv_rcnn_cfg(load_cfg('pv_rcnn'))
    if what == 'SPC':
        cfg.MODEL.PFE.SAMPLE_METHOD = 'SPC'
        cfg.MODEL.PFE.SPC_SAMPLING = {'SAMPLE_RADIUS_WITH_ROI': 1.6, 'NUM_SECTORS': 6}
        assert build_network(cfg.MODEL, 3, cfg.DATA_CONFIG, device='cpu').pfe.spc
        cfg.MODEL.PFE.SAMPLE_METHOD = 'RS'
        with pytest.raises(NotImplementedError, match='SAMPLE_METHOD RS'):
            build_network(cfg.MODEL, 3, cfg.DATA_CONFIG, device='cpu')
    else:
        cfg.MODEL.PFE.SA_LAYER.raw_points.AGGREGATION = 'VectorPoolAgg'
        net = build_network(cfg.MODEL, 3, cfg.DATA_CONFIG, device='cpu')
        assert net.pfe.vp_raw.out_channels == cfg.MODEL.PFE.SA_LAYER.raw_points.MLPS[0][-1]


# ---- the dry run and the KITTI loops ----------------------------------------------

@pytest.mark.parametrize('name', ['pv_rcnn', 'pv_rcnn_sparse', 'voxel_rcnn',
                                  'voxel_rcnn_sparse'])
def test_dryrun_trains_and_serves_the_two_stage_voxel_models(name, capsys):
    from pdm_ssd_torch.tools.dryrun import dryrun
    assert np.isfinite(dryrun('cpu', N=2000, cfg_file=f'configs/kitti_models/{name}.yaml'))
    model = 'PVRCNN' if name.startswith('pv') else 'VoxelRCNN'
    assert f'{model} train step + predict OK' in capsys.readouterr().out


def test_pv_rcnn_loops_and_clis_on_a_small_set(tmp_path):
    """The tiny PV-RCNN on the generated 3-frame mini set (its clouds sampled
    to 4096 points): `train_model` for 2 epochs with a checkpoint each, a
    resume after the first into a fresh model whose second epoch equals an
    unbroken run's bit for bit (the ROI targets' draw follows the update
    count), `eval_one_epoch` with finite recall and AP, then `tools.train`
    and `tools.test` on a YAML of the same config."""
    import yaml
    from pdm_ssd_torch.datasets import build_dataloader
    from pdm_ssd_torch.datasets.kitti import kitti_dataset as t_kitti
    from pdm_ssd_torch.datasets.kitti import synthetic as t_syn
    from pdm_ssd_torch.models import build_network
    from pdm_ssd_torch.runtime import eval_utils, trainer
    from pdm_ssd_torch.tools import test as test_cli
    from pdm_ssd_torch.tools import train as train_cli
    names = ['Car', 'Pedestrian', 'Cyclist']
    root = tmp_path / 'mini'
    cfg = synthetic.tiny_pv_rcnn_cfg(load_cfg('pv_rcnn'))
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == 'sample_points':
            proc.NUM_POINTS = {'train': 4096, 'test': 4096}
    t_syn.make_mini_kitti(root)
    t_kitti.create_kitti_infos(cfg.DATA_CONFIG, names, root, root, workers=1)
    _, loader, _ = build_dataloader(cfg.DATA_CONFIG, names, 2, root_path=root, workers=0,
                                    training=True, seed=0)

    def fresh(seed):
        net = build_network(cfg.MODEL, 3, cfg.DATA_CONFIG, device='cpu', seed=seed)
        opt, sched = trainer.create_train_state(net, cfg.OPTIMIZATION, len(loader), 2)
        return net, opt, sched

    def run(net, opt, sched, epochs, ckpt_dir, start=0):
        np.random.seed(start)           # augmentation and sampling
        torch.manual_seed(start)        # the loader's shuffle
        return trainer.train_model(net, opt, sched, loader, epochs, ckpt_dir=ckpt_dir,
                                   start_epoch=start)

    whole = fresh(0)
    losses = run(*whole, 1, tmp_path / 'whole') + run(*whole, 2, tmp_path / 'whole', start=1)
    net, opt, sched = fresh(0)
    run(net, opt, sched, 1, tmp_path / 'cut')
    resumed, r_opt, r_sched = fresh(5)
    assert trainer.resume(tmp_path / 'cut', resumed, r_opt) == 1 and r_opt.count == opt.count
    run(resumed, r_opt, r_sched, 2, tmp_path / 'cut', start=1)
    assert len(losses) == 2 and all(np.isfinite(losses))
    for p, q in zip(whole[0].parameters(), resumed.parameters()):
        assert torch.equal(p, q)
    vds, vloader, _ = build_dataloader(cfg.DATA_CONFIG, names, 2, root_path=root, workers=0,
                                       training=False)
    np.random.seed(0)
    ret = eval_utils.eval_one_epoch(resumed, vloader, vds, names, device='cpu')
    assert np.isfinite(ret['recall/rcnn_0.3']) and np.isfinite(ret['Car_3d/moderate_R40'])

    yml = cfg.to_dict()
    for k in ('TAG', 'EXP_GROUP_PATH'):
        yml.pop(k, None)
    cfg_file = tmp_path / 'tiny_pv_rcnn.yaml'
    cfg_file.write_text(yaml.safe_dump(yml))
    common = ['--cfg_file', str(cfg_file), '--batch_size', '2', '--workers', '0', '--device',
              'cpu', '--output_dir', str(tmp_path / 'cli')]
    train_cli.main(common + ['--epochs', '1'])
    ckpt = tmp_path / 'cli' / 'ckpt' / 'checkpoint_epoch_1.pth'
    assert ckpt.exists()
    ret = test_cli.main(common + ['--ckpt', str(ckpt)])
    assert (tmp_path / 'cli' / 'eval' / 'result.pkl').exists()
    assert np.isfinite(ret['Car_3d/moderate_R40'])
