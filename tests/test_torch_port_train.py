"""The port's training path against the JAX package, on the CPU in float32:
target assignment, losses, the grouping gradient, the optimizer, the full
training forward and backward of the tiny flagship, and three train steps.

Inputs come from numpy seeds and go through both packages; JAX runs jitted.
Each tolerance stands beside its reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pdm_ssd_tpu.models.dense_heads.center_head import CenterHead as JCenterHead
from pdm_ssd_tpu.models.dense_heads.point_head_box import PointHeadBox as JPointHeadBox
from pdm_ssd_tpu.ops import box_ops as j_box
from pdm_ssd_tpu.ops import centernet as j_cn
from pdm_ssd_tpu.ops import coders as j_coders
from pdm_ssd_tpu.ops import losses as j_losses
from pdm_ssd_tpu.ops import sa_fused as j_sa
from pdm_ssd_tpu.runtime import optimization as j_opt
from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode

from pdm_ssd_torch.ops import box_ops as t_box
from pdm_ssd_torch.ops import centernet as t_cn
from pdm_ssd_torch.ops import coders as t_coders
from pdm_ssd_torch.ops import group as t_group
from pdm_ssd_torch.ops import losses as t_losses
from pdm_ssd_torch.ops import sa_fused as t_sa
from pdm_ssd_torch.runtime import optimization as t_opt
from pdm_ssd_torch.runtime.trainer import create_train_state, make_train_step
from pdm_ssd_torch.utils import synthetic
from pdm_ssd_torch.utils.config import CfgNode as TCfgNode
from pdm_ssd_torch.utils.weights import from_flax, to_flax
from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_harness import (FlagshipPair, jax_bf16_extraction, jax_train_steps,
                                randomize_variables, rel_l2, to_torch)

# the same float32 arithmetic on the same inputs; sums and transcendentals
# may round differently in the two libraries
OP_TOL = 1e-5
MEAN_SIZES = ((3.9, 1.6, 1.56), (0.8, 0.6, 1.73), (1.76, 0.6, 1.73))


@pytest.fixture(scope='module')
def pair():
    return FlagshipPair(B=2, N=512, seed=0)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield '/'.join(prefix + (k,)), np.asarray(v)


# ---- box geometry, coder, losses, heatmap targets ----------------------------

def _boxes_and_points(seed):
    """Boxes with rotation, one axis-aligned unit box with points exactly on
    its faces and edges, one masked box; points drawn inside and around."""
    rng = np.random.RandomState(seed)
    B, M, N = 2, 6, 400
    boxes = np.zeros((B, M, 7), np.float32)
    boxes[..., 0] = rng.uniform(2, 18, (B, M))
    boxes[..., 1] = rng.uniform(-8, 8, (B, M))
    boxes[..., 2] = rng.uniform(-1.5, -0.5, (B, M))
    boxes[..., 3:6] = rng.uniform(1.0, 4.0, (B, M, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (B, M))
    boxes[:, 0] = [4.0, 2.0, 0.0, 2.0, 1.0, 1.0, 0.0]          # faces at x 3/5, y 1.5/2.5, z +-0.5
    boxes[:, 1] = [4.5, 2.0, 0.0, 2.0, 1.0, 1.0, np.pi / 6]    # overlaps box 0: first wins
    pts = np.zeros((B, N, 3), np.float32)
    for b in range(B):
        which = rng.randint(0, M, N)
        local = rng.uniform(-0.75, 0.75, (N, 3)) * boxes[b, which, 3:6]
        c, s = np.cos(boxes[b, which, 6]), np.sin(boxes[b, which, 6])
        pts[b, :, 0] = boxes[b, which, 0] + local[:, 0] * c - local[:, 1] * s
        pts[b, :, 1] = boxes[b, which, 1] + local[:, 0] * s + local[:, 1] * c
        pts[b, :, 2] = boxes[b, which, 2] + local[:, 2]
    pts[:, :6] = [[5.0, 2.0, 0.0], [4.0, 2.5, 0.0], [4.0, 2.0, 0.5],
                  [4.0, 2.0, -0.5], [5.0, 2.5, 0.5], [5.00002, 2.0, 0.0]]
    mask = np.ones((B, M), bool)
    mask[:, 3] = False
    return pts, boxes, mask


def test_points_in_boxes_matches_jax_exactly():
    pts, boxes, mask = _boxes_and_points(0)
    want = np.asarray(j_box.points_in_boxes_batch(jnp.asarray(pts), jnp.asarray(boxes),
                                                  jnp.asarray(mask)))
    got = t_box.points_in_boxes(*to_torch([pts, boxes, mask]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the face points: inside by the margin on x and y and by <= on z
    np.testing.assert_array_equal(got.numpy()[0, :5], 0)
    assert (want == -1).sum() > 100 and (want >= 0).sum() > 100 and not (want == 3).any()
    nomask = t_box.points_in_boxes(*to_torch([pts, boxes]))
    np.testing.assert_array_equal(
        nomask.numpy(), np.asarray(j_box.points_in_boxes_batch(jnp.asarray(pts),
                                                               jnp.asarray(boxes), None)))


def test_box_helpers_match_jax():
    _, boxes, _ = _boxes_and_points(1)
    extra = [0.2, 0.4, 0.6]
    got = t_box.enlarge_box3d(torch.from_numpy(boxes), extra).numpy()
    np.testing.assert_allclose(got, np.asarray(j_box.enlarge_box3d(jnp.asarray(boxes), extra)),
                               rtol=0, atol=OP_TOL)
    np.testing.assert_allclose(got[..., 3:6] - boxes[..., 3:6],
                               np.broadcast_to(extra, boxes[..., 3:6].shape), atol=1e-6)
    ang = np.linspace(-7, 7, 41).astype(np.float32)
    np.testing.assert_allclose(t_box.limit_period(torch.from_numpy(ang)).numpy(),
                               np.asarray(j_box.limit_period(jnp.asarray(ang))), atol=OP_TOL)
    np.testing.assert_allclose(
        t_box.boxes_to_corners_3d(torch.from_numpy(boxes[0])).numpy(),
        np.asarray(j_box.boxes_to_corners_3d(jnp.asarray(boxes[0]))), atol=OP_TOL)
    pts = np.random.RandomState(2).randn(2, 30, 5).astype(np.float32)
    np.testing.assert_allclose(
        t_box.rotate_points_along_z(torch.from_numpy(pts), torch.tensor([0.3, -2.0])).numpy(),
        np.asarray(j_box.rotate_points_along_z(jnp.asarray(pts), jnp.asarray([0.3, -2.0]))),
        atol=OP_TOL)


def test_point_residual_coder_encode_matches_jax_and_inverts_decode():
    rng = np.random.RandomState(3)
    _, boxes, _ = _boxes_and_points(3)
    boxes[0, 0, 3] = 0.0                                      # size clipped at 1e-5
    pts = (boxes[..., :3] + rng.randn(*boxes[..., :3].shape)).astype(np.float32)
    cls = rng.randint(1, 4, boxes.shape[:2]).astype(np.int32)
    j_coder = j_coders.PointResidualCoder(mean_size=MEAN_SIZES)
    t_coder = t_coders.build_box_coder('PointResidualCoder', use_mean_size=True,
                                       mean_size=MEAN_SIZES)
    want = np.asarray(j_coder.encode(jnp.asarray(boxes), jnp.asarray(pts), jnp.asarray(cls)))
    got = t_coder.encode(*to_torch([boxes, pts, cls]))
    np.testing.assert_allclose(got.numpy(), want, rtol=OP_TOL, atol=OP_TOL)
    back = t_coder.decode(got[:, 1:], torch.from_numpy(pts[:, 1:]), torch.from_numpy(cls[:, 1:]))
    np.testing.assert_allclose(back[..., :6].numpy(), boxes[:, 1:, :6], rtol=1e-4, atol=1e-4)
    # without mean sizes: plain offsets and log sizes, as the JAX package codes them
    j_plain = j_coders.PointResidualCoder(use_mean_size=False)
    t_plain = t_coders.build_box_coder('PointResidualCoder', use_mean_size=False)
    np.testing.assert_allclose(t_plain.encode(*to_torch([boxes, pts])).numpy(),
                               np.asarray(j_plain.encode(jnp.asarray(boxes), jnp.asarray(pts))),
                               rtol=OP_TOL, atol=OP_TOL)


def _loss_case(name, rng):
    """(jax fn, torch fn, inputs, index of the prediction among them)."""
    if name == 'sigmoid_focal_loss':
        logits = rng.randn(50, 3).astype(np.float32) * 3
        target = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 50)][:, 1:]
        weights = rng.rand(50).astype(np.float32)
        return j_losses.sigmoid_focal_loss, t_losses.sigmoid_focal_loss, [logits, target, weights]
    if name == 'weighted_smooth_l1':
        pred = rng.randn(40, 8).astype(np.float32)
        target = (pred + rng.randn(40, 8) * 0.2).astype(np.float32)   # both sides of beta
        target[3, 2] = np.nan
        weights = rng.rand(40).astype(np.float32)
        cw = [1.0, 0.5, 2.0, 1.0, 1.0, 1.0, 0.2, 1.0]
        return (lambda p, t, w: j_losses.weighted_smooth_l1(p, t, w, code_weights=cw),
                lambda p, t, w: t_losses.weighted_smooth_l1(p, t, w, code_weights=cw),
                [pred, target, weights])
    if name == 'centernet_focal_loss':
        pred = rng.uniform(1e-4, 1 - 1e-4, (2, 3, 12, 10)).astype(np.float32)
        gt = rng.rand(2, 3, 12, 10).astype(np.float32) ** 3
        gt[0, 1, 4, 5] = gt[1, 2, 7, 2] = 1.0
        return j_losses.centernet_focal_loss, t_losses.centernet_focal_loss, [pred, gt]
    if name == 'centernet_focal_loss_no_positive':
        pred = rng.uniform(1e-4, 1 - 1e-4, (1, 2, 6, 6)).astype(np.float32)
        gt = (rng.rand(1, 2, 6, 6) * 0.9).astype(np.float32)
        return j_losses.centernet_focal_loss, t_losses.centernet_focal_loss, [pred, gt]
    if name == 'centernet_reg_loss':
        pred = rng.randn(2, 9, 8).astype(np.float32)
        mask = (rng.rand(2, 9) > 0.4).astype(np.int32)
        target = rng.randn(2, 9, 8).astype(np.float32)
        target[1, 2, 5] = np.nan
        return (lambda p, m, t: j_losses.centernet_reg_loss(p, m, t),
                lambda p, m, t: t_losses.centernet_reg_loss(p, m, t), [pred, mask, target])
    assert name == 'smooth_l1_zero_beta'
    diff = rng.randn(30).astype(np.float32)
    return (lambda d: j_losses.smooth_l1(d, 0.0), lambda d: t_losses.smooth_l1(d, 0.0), [diff])


@pytest.mark.parametrize('name', ['sigmoid_focal_loss', 'weighted_smooth_l1',
                                  'centernet_focal_loss', 'centernet_focal_loss_no_positive',
                                  'centernet_reg_loss', 'smooth_l1_zero_beta'])
def test_loss_value_and_gradient_match_jax(name):
    j_fn, t_fn, inputs = _loss_case(name, np.random.RandomState(4))
    want = np.asarray(j_fn(*[jnp.asarray(a) for a in inputs]))
    t_in = to_torch(inputs)
    t_in[0].requires_grad_(True)
    got = t_fn(*t_in)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=OP_TOL, atol=OP_TOL)
    # gradient of the sum with respect to the prediction (the first input)
    j_grad = jax.grad(lambda p: jnp.sum(j_fn(p, *[jnp.asarray(a) for a in inputs[1:]])))(
        jnp.asarray(inputs[0]))
    got.sum().backward()
    np.testing.assert_allclose(t_in[0].grad.numpy(), np.asarray(j_grad), rtol=1e-4, atol=OP_TOL)


def test_gather_feat_matches_jax():
    rng = np.random.RandomState(5)
    feat = rng.randn(2, 30, 4).astype(np.float32)
    ind = rng.randint(0, 30, (2, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        t_losses.gather_feat(*to_torch([feat, ind])).numpy(),
        np.asarray(j_losses.gather_feat(jnp.asarray(feat), jnp.asarray(ind))))


def test_gaussian_radius_matches_jax():
    rng = np.random.RandomState(6)
    h = rng.uniform(0.5, 30, 200).astype(np.float32)
    w = rng.uniform(0.5, 30, 200).astype(np.float32)
    for overlap in (0.1, 0.5):
        np.testing.assert_allclose(
            t_cn.gaussian_radius(*to_torch([h, w]), min_overlap=overlap).numpy(),
            np.asarray(j_cn.gaussian_radius(jnp.asarray(h), jnp.asarray(w), overlap)),
            rtol=OP_TOL, atol=OP_TOL)


def test_assign_center_targets_matches_jax():
    """Heatmap to 1e-5, `inds` and `mask` exact, with boxes on the edges of
    the range, one outside it (clipped into the map), one of zero size
    (invalid), one masked, and a radius above RMAX."""
    rng = np.random.RandomState(7)
    B, M = 2, 9
    pcr, voxel, stride, size = [0, -40, -3, 70.4, 40, 1], (1.6, 1.6), 1, (44, 50)
    gt = np.zeros((B, M, 8), np.float32)
    gt[..., 0] = rng.uniform(2, 68, (B, M))
    gt[..., 1] = rng.uniform(-38, 38, (B, M))
    gt[..., 2] = rng.uniform(-2, 0, (B, M))
    gt[..., 3:6] = rng.uniform(0.6, 5.0, (B, M, 3))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (B, M))
    gt[..., 7] = rng.randint(1, 4, (B, M))
    gt[:, 0, :2] = [0.0, -40.0]                # the map's corner cell
    gt[:, 1, :2] = [70.39, 39.99]              # the last cell
    gt[:, 2, :2] = [80.0, 50.0]                # outside: clipped to the edge
    gt[:, 3, 3] = 0.0                          # no width: invalid
    gt[:, 4, 3:5] = [70.0, 60.0]               # radius beyond RMAX
    valid = np.ones((B, M), bool)
    valid[:, 5] = False
    kw = dict(num_classes=3, feature_map_size=size, feature_map_stride=stride,
              voxel_size=voxel, point_cloud_range=pcr, gaussian_overlap=0.1, min_radius=2)
    want = jax.jit(jax.vmap(lambda g, m: j_cn.assign_center_targets(g, m, num_max_objs=M, **kw)))(
        jnp.asarray(gt), jnp.asarray(valid))
    got = t_cn.assign_center_targets(torch.from_numpy(gt), torch.from_numpy(valid), **kw)
    names = ('heatmap', 'target_boxes', 'inds', 'mask', 'target_boxes_src')
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        if name in ('inds', 'mask'):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=OP_TOL, atol=OP_TOL, err_msg=name)
    assert got[3].sum() == B * (M - 2) and got[0].shape == (B, 3, 50, 44)
    assert (got[0] == 1.0).sum() >= B * (M - 3)


# ---- row gather, scatter-add and their autograd wiring -------------------------

def test_gather_and_scatter_plain_match_a_numpy_oracle():
    rng = np.random.RandomState(8)
    B, N, C, R = 3, 40, 5, 260
    feats = rng.randn(B, N, C).astype(np.float32)
    idx = rng.randint(-4, N + 4, (B, R))
    ok = (idx >= 0) & (idx < N)
    assert (~ok).sum() > 20
    want = np.zeros((B, R, C), np.float32)
    for b in range(B):
        want[b, ok[b]] = feats[b, idx[b, ok[b]]]
    for dtype in (torch.int64, torch.int32):
        got = t_group.gather_rows_plain(torch.from_numpy(feats), torch.from_numpy(idx).to(dtype))
        np.testing.assert_array_equal(got.numpy(), want)
    vals = rng.randn(B, R, C).astype(np.float32)
    oracle = np.zeros((B, N, C), np.float64)
    for b in range(B):
        np.add.at(oracle[b], idx[b, ok[b]], vals[b, ok[b]].astype(np.float64))
    got = t_group.scatter_add_rows_plain(torch.from_numpy(vals), torch.from_numpy(idx), N)
    # float32 sums of about R/N = 7 unit-scale terms against a float64 sum
    np.testing.assert_allclose(got.numpy(), oracle, rtol=0, atol=1e-5)
    # a channel slice of a wider payload reads the same rows
    sl = t_group.gather_rows_plain(torch.from_numpy(feats)[..., 1:4], torch.from_numpy(idx))
    np.testing.assert_array_equal(sl.numpy(), want[..., 1:4])


def test_gather_rows_gradient_matches_jax_within_bf16_rounding():
    """`GatherRows` backward (scatter-add, float32) against `jax.grad` of
    `gather_rows_mm`, whose backward rounds the incoming gradient to bf16
    (pdm_ssd_tpu/ops/sa_fused.py:274): each term is off by at most 2^-8
    relative (bf16 keeps 8 significant bits), so a sum of terms is off by
    at most 2^-8 times the sum of their magnitudes."""
    rng = np.random.RandomState(9)
    B, N, C, M, K = 2, 30, 6, 20, 8
    feats = rng.randn(B, N, C).astype(np.float32)
    idx = rng.randint(0, N, (B, M, K)).astype(np.int32)
    g_out = rng.randn(B, M, K, C).astype(np.float32)
    j_grad = jax.grad(lambda f: jnp.sum(j_sa.gather_rows_mm(f, jnp.asarray(idx))
                                        * jnp.asarray(g_out)))(jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_(True)
    out = t_sa.GatherRows.apply(f, torch.from_numpy(idx).reshape(B, M * K))
    np.testing.assert_array_equal(out.detach().numpy().reshape(B, M, K, C),
                                  feats[np.arange(B)[:, None, None], idx])
    (out.reshape(B, M, K, C) * torch.from_numpy(g_out)).sum().backward()
    bound = t_group.scatter_add_rows_plain(torch.from_numpy(np.abs(g_out)).reshape(B, M * K, C),
                                           torch.from_numpy(idx).reshape(B, M * K), N).numpy()
    err = np.abs(f.grad.numpy() - np.asarray(j_grad))
    assert (err <= 2.0 ** -8 * bound + 1e-6).all()
    assert err.max() > 1e-4          # the rounding is there: the port does not round


def test_gather_rows_gradcheck_and_no_gradient_for_raw_input():
    rng = np.random.RandomState(10)
    B, N, C, R = 2, 7, 3, 15
    feats = torch.from_numpy(rng.randn(B, N, C)).requires_grad_(True)     # float64
    idx = torch.from_numpy(rng.randint(-1, N + 1, (B, R)))
    assert torch.autograd.gradcheck(lambda f: t_sa.GatherRows.apply(f, idx), (feats,))
    assert torch.autograd.gradcheck(lambda f: t_sa.GatherRows.apply(f[..., 1:3], idx), (feats,))
    raw = torch.from_numpy(rng.randn(B, N, C))
    assert not t_sa.GatherRows.apply(raw, idx).requires_grad


def test_fused_query_group_empty_balls_take_no_gradient():
    rng = np.random.RandomState(11)
    xyz = np.stack([rng.uniform(0, 12, (2, 300)), rng.uniform(-8, 8, (2, 300)),
                    rng.uniform(-1, 1, (2, 300))], -1).astype(np.float32)
    new_xyz = xyz[:, :40].copy()
    new_xyz[:, :4, 2] = 30.0                                   # empty balls
    feats = torch.from_numpy(rng.randn(2, 300, 12).astype(np.float32)).requires_grad_(True)
    outs = t_sa.fused_query_group([0.8, 1.6], [4, 8], torch.from_numpy(xyz), feats,
                                  torch.from_numpy(new_xyz), (0.0, -8.0, 12.0, 8.0),
                                  feat_slices=[(0, 5), (5, 12)])
    for (rel, gf, idx, hit), (s0, s1) in zip(outs, [(0, 5), (5, 12)]):
        assert not hit[:, :4].any() and hit[:, 4:].all()
        assert (gf[:, :4] == 0).all() and (idx[:, :4] == 0).all() and (rel[:, :4] == 0).all()
        np.testing.assert_array_equal(
            gf[:, 4:].detach().numpy(),
            t_group.flat_gather(feats.detach()[..., s0:s1], idx.long())[:, 4:].numpy())
    sum(o[1].sum() for o in outs).backward()
    # row 0 is the index an empty ball reports; it gets gradient only from real hits
    counts = sum(np.bincount(o[2][b][o[3][b]].reshape(-1).numpy(), minlength=300)
                 for o in outs[:1] for b in [0])
    np.testing.assert_allclose(feats.grad[0, :, 0].numpy(), counts, atol=1e-6)


# ---- heads: targets and losses on the JAX forward's own predictions ------------

@pytest.fixture(scope='module')
def jax_train_out(pair):
    return pair.jax_train_forward()


def test_point_head_targets_and_loss_match_jax(pair, jax_train_out):
    out = jax_train_out
    keys = ('point_coords', 'gt_boxes', 'gt_mask', 'point_cls_preds', 'point_box_preds')
    j_batch = {k: jnp.asarray(out[k]) for k in keys}
    j_head = JPointHeadBox(model_cfg=pair.cfg.MODEL.POINT_HEAD, input_channels=1, num_class=3)

    @jax.jit
    def j_targets_and_loss(b):
        targets = j_head.assign_targets(b)
        return targets, j_head.get_loss(b, targets)

    j_targets, (j_loss, j_tb) = j_targets_and_loss(j_batch)
    t_batch = {k: torch.from_numpy(out[k]) for k in keys}
    head = pair.net.point_head
    targets = head.assign_targets(t_batch)
    np.testing.assert_array_equal(targets['point_cls_labels'].numpy(),
                                  np.asarray(j_targets['point_cls_labels']))
    np.testing.assert_allclose(targets['point_box_labels'].numpy(),
                               np.asarray(j_targets['point_box_labels']), rtol=OP_TOL, atol=OP_TOL)
    loss, tb = head.get_loss(t_batch, targets)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=OP_TOL)
    assert set(tb) == set(j_tb)
    for k in tb:
        np.testing.assert_allclose(float(tb[k]), float(j_tb[k]), rtol=OP_TOL, err_msg=k)
    # without a mask, boxes of positive size are the valid ones
    t_batch.pop('gt_mask')
    np.testing.assert_array_equal(head.assign_targets(t_batch)['point_cls_labels'].numpy(),
                                  targets['point_cls_labels'].numpy())


def test_point_head_labels_cover_foreground_and_ignore():
    """A cloud drawn around its boxes: foreground, ignore (-1) and background
    labels all occur and equal the JAX package's."""
    pts, boxes, mask = _boxes_and_points(12)
    cls = np.random.RandomState(12).randint(1, 4, boxes.shape[:2]).astype(np.float32)
    gt = np.concatenate([boxes, cls[..., None]], -1)
    import __graft_entry__ as graft
    from pdm_ssd_tpu.utils.config import cfg_from_yaml_file
    cfg = cfg_from_yaml_file(str(graft.REPO / 'configs/kitti_models/pdm_ssd_point.yaml'),
                             JCfgNode())
    j_head = JPointHeadBox(model_cfg=cfg.MODEL.POINT_HEAD, input_channels=1, num_class=3)
    want = j_head.assign_targets({'point_coords': jnp.asarray(pts), 'gt_boxes': jnp.asarray(gt),
                                  'gt_mask': jnp.asarray(mask)})
    from pdm_ssd_torch.models.dense_heads.point_head_box import PointHeadBox
    head = PointHeadBox(TCfgNode(cfg.MODEL.POINT_HEAD.to_dict()), 64, 3)
    got = head.assign_targets({'point_coords': torch.from_numpy(pts),
                               'gt_boxes': torch.from_numpy(gt),
                               'gt_mask': torch.from_numpy(mask)})
    labels = got['point_cls_labels'].numpy()
    np.testing.assert_array_equal(labels, np.asarray(want['point_cls_labels']))
    assert (labels == -1).sum() > 5 and (labels == 0).sum() > 100 and (labels > 0).sum() > 100
    np.testing.assert_allclose(got['point_box_labels'].numpy(),
                               np.asarray(want['point_box_labels']), rtol=OP_TOL, atol=OP_TOL)


def test_center_head_targets_and_loss_match_jax(pair, jax_train_out):
    out = jax_train_out
    preds = out['center_head_preds'][0]
    H, W = out['spatial_features_2d'].shape[1:3]
    neck = pair.cfg.MODEL.PDM_NECK
    j_head = JCenterHead(model_cfg=pair.cfg.MODEL.DENSE_HEAD, input_channels=1, num_class=3,
                         grid_size=tuple(neck.BEV_SIZE),
                         point_cloud_range=tuple(pair.cfg.DATA_CONFIG.POINT_CLOUD_RANGE),
                         voxel_size=tuple(neck.VOXEL_SIZE[:2]),
                         class_names=tuple(pair.cfg.CLASS_NAMES))
    @jax.jit
    def j_targets_and_loss(gt_boxes, gt_mask, maps):
        targets = j_head.assign_targets(gt_boxes, gt_mask, (H, W))
        return targets, j_head.get_loss({'center_head_preds': [maps]}, targets)

    j_targets, (j_loss, j_tb) = j_targets_and_loss(out['gt_boxes'], out['gt_mask'], preds)
    head = pair.net.dense_head
    targets = head.assign_targets(torch.from_numpy(out['gt_boxes']),
                                  torch.from_numpy(out['gt_mask']), (H, W))
    assert len(targets) == len(j_targets) == 1
    for k in ('inds', 'masks'):
        np.testing.assert_array_equal(targets[0][k].numpy(), np.asarray(j_targets[0][k]), k)
    for k in ('heatmaps', 'target_boxes', 'target_boxes_src'):
        np.testing.assert_allclose(targets[0][k].numpy(), np.asarray(j_targets[0][k]),
                                   rtol=OP_TOL, atol=OP_TOL, err_msg=k)
    assert int(targets[0]['masks'].sum()) == out['gt_boxes'].shape[0] * out['gt_boxes'].shape[1]
    loss, tb = head.get_loss({'center_head_preds': [to_torch(preds)]}, targets)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=OP_TOL)
    assert set(tb) == set(j_tb) == {'hm_loss', 'loc_loss'}
    for k in tb:
        np.testing.assert_allclose(float(tb[k]), float(j_tb[k]), rtol=OP_TOL, err_msg=k)


# ---- the slice as a whole ------------------------------------------------------

# The JAX forward extracts the grouped relative xyz and the SA-1 payload in
# bf16 (about 2^-9 relative). In training mode BatchNorm divides by the
# batch's own deviation, and on a 512-point cloud most balls hold their
# center alone, so some channels' deviations are small and the rounding grows
# to about 5e-2 of a feature map's scale and 2.4e-2 of one loss term
# (measured). So the slice is held twice: tightly with that extraction
# emulated in the port (`jax_bf16_extraction`: what remains is float32
# rounding, measured 5e-5 on the maps and 2e-5 on the losses), and as shipped
# (float32 extraction) to the looser bounds below.
EMULATED_RTOL = 5e-4
SHIPPED_LOSS_RTOL = 1e-2        # the total loss; measured 1.1e-3
SHIPPED_TERM_RTOL = 5e-2        # each loss term; measured 2.4e-2


def _train_forward_backward(pair):
    net = pair.net
    net.load_state_dict(from_flax(pair.variables, net))
    net.train()
    net.zero_grad()
    try:
        loss, tb = net.forward_with_loss(pair.torch_batch())
        loss.backward()
        grads = to_flax(net, {k: p.grad for k, p in net.named_parameters()})['params']
        stats = to_flax(net)['batch_stats']
    finally:
        net.zero_grad()
        net.load_state_dict(from_flax(pair.variables, net))
        net.eval()
    return dict(loss=float(loss.detach()), tb={k: float(v.detach()) for k, v in tb.items()},
                grads=grads, stats=stats)


@pytest.fixture(scope='module')
def jax_trained(pair):
    loss, tb, grads, stats = pair.jax_loss_and_grads()
    return dict(loss=float(loss), tb={k: float(v) for k, v in tb.items()}, grads=grads,
                stats=stats)


@pytest.fixture(scope='module')
def trained(pair):
    """One training forward and backward of the port with the JAX side's
    bf16 extraction emulated."""
    with jax_bf16_extraction():
        return _train_forward_backward(pair)


def test_to_flax_inverts_from_flax(pair):
    net = pair.net
    net.load_state_dict(from_flax(pair.variables, net))
    back = to_flax(net)
    for kind in ('params', 'batch_stats'):
        want = dict(_leaves(pair.variables[kind]))
        got = dict(_leaves(back[kind]))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_training_loss_matches_jax(trained, jax_trained):
    assert set(trained['tb']) == set(jax_trained['tb']) == {
        'point_loss_cls', 'point_loss_box', 'point_pos_num', 'hm_loss', 'loc_loss', 'loss'}
    np.testing.assert_allclose(trained['loss'], jax_trained['loss'], rtol=EMULATED_RTOL)
    for k, v in trained['tb'].items():
        np.testing.assert_allclose(v, jax_trained['tb'][k], rtol=EMULATED_RTOL, err_msg=k)


def test_training_loss_as_shipped_is_within_the_bf16_budget(pair, jax_trained):
    shipped = _train_forward_backward(pair)
    np.testing.assert_allclose(shipped['loss'], jax_trained['loss'], rtol=SHIPPED_LOSS_RTOL)
    for k, v in shipped['tb'].items():
        np.testing.assert_allclose(v, jax_trained['tb'][k], rtol=SHIPPED_TERM_RTOL, err_msg=k)
    assert shipped['tb']['point_pos_num'] == jax_trained['tb']['point_pos_num']
    for k, g in _leaves(shipped['grads']):
        assert np.isfinite(g).all(), k


# Per-leaf gradient error against jax.grad, relative L2, with the forward's
# extraction emulated. Two things remain. The JAX backward rounds the
# grouping gradient to bf16 (pdm_ssd_tpu/ops/sa_fused.py:274; the port keeps
# float32), which the leaves of SA levels 1 and 2 carry. And float32 rounding
# itself is large here: the small-deviation BatchNorms of this 512-point
# cloud and the cancelling sums behind a BatchNorm bias's gradient put the
# port's own float32 gradients up to 8e-3 from its float64 gradients.
# Measured against JAX on this batch: at most 1.8e-2, cosine at least
# 0.99985; the bounds leave a factor of about 2.
GRAD_REL_L2 = 4e-2
GRAD_COSINE = 0.999


def test_training_gradients_match_jax_per_leaf(trained, jax_trained):
    want = dict(_leaves(jax_trained['grads']))
    got = dict(_leaves(trained['grads']))
    assert set(got) == set(want) and len(got) > 100
    report = {}
    for k in sorted(want):
        g, w = got[k].astype(np.float64).ravel(), want[k].astype(np.float64).ravel()
        assert np.isfinite(g).all(), k
        nw = np.linalg.norm(w)
        if nw == 0:          # a leaf the loss does not reach in either package
            assert np.linalg.norm(g) == 0, k
            continue
        rel = np.linalg.norm(g - w) / nw
        cos = float(g @ w / (np.linalg.norm(g) * nw))
        report[k] = (rel, cos)
        assert rel <= GRAD_REL_L2, f'{k}: relative L2 error {rel:.3e}'
        assert cos >= GRAD_COSINE, f'{k}: cosine {cos:.6f}'
    assert len(report) > 100
    # the PDM neck's projection takes its gradient through `index_add_`
    assert report['pdm_neck/sh_proj/kernel'][0] <= GRAD_REL_L2
    print('worst leaves:', sorted(report.items(), key=lambda kv: -kv[1][0])[:5])


def test_batchnorm_statistics_after_a_training_forward_match_jax(pair, trained, jax_trained):
    """flax updates the running variance with the biased batch variance and
    the port follows it; torch's own update (unbiased) would put the point
    head's variances (n = 64 values per channel) off by 0.1 * var / 63,
    above this bound."""
    want = dict(_leaves(jax_trained['stats']))
    got = dict(_leaves(trained['stats']))
    before = dict(_leaves(pair.variables['batch_stats']))
    assert set(got) == set(want)
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-6)
        assert np.abs(got[k] - want[k]).max() <= EMULATED_RTOL * scale, k
        assert np.abs(want[k] - before[k]).max() > 1e-4, k


def test_batchnorm_running_variance_is_biased_like_flax():
    """The statistic update alone, same input on both sides: exact to float32
    rounding, and apart from torch's unbiased update."""
    import flax.linen as fnn
    from pdm_ssd_torch.models.layers import BatchNorm2d, BatchNormLast
    rng = np.random.RandomState(13)
    x = (rng.randn(6, 5) * 2 + 1).astype(np.float32)            # n = 6 per channel
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y, mutated = bn.apply(variables, jnp.asarray(x), mutable=['batch_stats'])
    port = BatchNormLast(5, eps=1e-5, momentum=0.1).train()
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(mutated['batch_stats']['mean']), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(mutated['batch_stats']['var']), rtol=1e-5, atol=1e-6)
    ref = torch.nn.BatchNorm1d(5, eps=1e-5, momentum=0.1).train()
    ref(torch.from_numpy(x))
    assert (ref.running_var - port.running_var).abs().max() > 1e-2
    assert int(port.num_batches_tracked) == 1
    # the 2-D layer follows the same rule; eval mode leaves the statistics alone
    x4 = torch.from_numpy(rng.randn(2, 3, 4, 4).astype(np.float32))
    bn2 = BatchNorm2d(3, eps=1e-3, momentum=0.01).train()
    bn2(x4)
    biased = x4.transpose(0, 1).reshape(3, -1).var(dim=1, unbiased=False)
    np.testing.assert_allclose(bn2.running_var.numpy(), (0.99 + 0.01 * biased).numpy(), rtol=1e-6)
    frozen = bn2.running_var.clone()
    bn2.eval()(x4 * 3)
    assert torch.equal(bn2.running_var, frozen)


# flax's BatchNorm against the port's, float32 on both sides, on a map whose
# channel means lie 17 deviations above 0: E[x^2] - E[x]^2 loses about 300
# times float32's rounding there, in either package's order of sums
BN_REL_L2 = 1e-4


def test_batchnorm_training_forward_and_backward_match_flax():
    """flax's BatchNorm in training mode (its variance E[x^2] - E[x]^2)
    against the port's: output, the gradients of input, scale and bias, and
    the running statistics within BN_REL_L2."""
    import flax.linen as fnn
    from pdm_ssd_torch.models.layers import BatchNorm2d
    rng = np.random.RandomState(17)
    x = (rng.randn(4, 6, 5, 7) * 0.3 + 5.0).astype(np.float32)        # NHWC
    g = rng.randn(*x.shape).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
    variables = randomize_variables(bn.init(jax.random.PRNGKey(0), jnp.asarray(x)), 18)

    def f(params, x):
        y, mutated = bn.apply({**variables, 'params': params}, x, mutable=['batch_stats'])
        return (y * g).sum(), (y, mutated['batch_stats'])

    (_, (y, stats)), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        variables['params'], jnp.asarray(x))
    port = BatchNorm2d(7, eps=1e-3, momentum=0.01).train()
    port.load_state_dict(from_flax(variables, port))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    yt = port(xt)
    (yt * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    pairs = {'y': (yt.detach().permute(0, 2, 3, 1), y), 'dx': (xt.grad.permute(0, 2, 3, 1), gx),
             'dscale': (port.weight.grad, gp['scale']), 'dbias': (port.bias.grad, gp['bias']),
             'mean': (port.running_mean, stats['mean']), 'var': (port.running_var, stats['var'])}
    for k, (got, want) in pairs.items():
        assert rel_l2(got.numpy(), np.asarray(want)) <= BN_REL_L2, k


# ---- the optimizer alone -------------------------------------------------------

def _opt_cfg(cls, **kw):
    base = dict(OPTIMIZER='adam_onecycle', LR=0.01, WEIGHT_DECAY=0.01, MOMENTUM=0.9,
                MOMS=[0.95, 0.85], PCT_START=0.4, DIV_FACTOR=10, DECAY_STEP_LIST=[1, 2],
                LR_DECAY=0.1, LR_CLIP=1e-7, GRAD_NORM_CLIP=10)
    base.update(kw)
    return cls(base)


@pytest.mark.parametrize('name', ['adam_onecycle', 'adam', 'sgd'])
def test_optimizer_matches_optax(name):
    """A 1-D and a 2-D leaf, the same seeded gradients for 4 steps of a
    5-step schedule (warm-up boundary at step 2), the second gradient above
    the clip norm: parameters to 1e-6, rate and beta1 per step. The clip
    divides by the norm itself, as optax does (torch's own
    `clip_grad_norm_` divides by norm + 1e-6)."""
    rng = np.random.RandomState(14)
    p0 = {'bias': rng.randn(7).astype(np.float32), 'kernel': rng.randn(5, 7).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * (30.0 if step == 1 else 1.0)).astype(np.float32)
              for k, v in p0.items()} for step in range(4)]
    assert np.sqrt(sum((g ** 2).sum() for g in grads[1].values())) > 10
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    tx, j_sched = j_opt.build_optimizer_and_schedule(params, _opt_cfg(JCfgNode, OPTIMIZER=name),
                                                     total_iters_each_epoch=5, total_epochs=1)
    state = tx.init(params)
    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt, t_sched = t_opt.build_optimizer_and_schedule(
        t_params.values(), _opt_cfg(TCfgNode, OPTIMIZER=name), total_iters_each_epoch=5,
        total_epochs=1)
    j_mom = j_opt.onecycle_mom_schedule(5)
    for step, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
        for k, p in t_params.items():
            p.grad = torch.from_numpy(g[k].copy())
        np.testing.assert_allclose(t_sched(step), float(j_sched(step)), rtol=1e-6)
        opt.step()
        assert opt.count == step + 1
        if name == 'adam_onecycle':
            np.testing.assert_allclose(opt.optimizer.param_groups[0]['betas'][0],
                                       float(j_mom(step)), rtol=1e-6)
        for k in p0:
            np.testing.assert_allclose(t_params[k].detach().numpy(), np.asarray(params[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=f'step {step} {k}')
    assert np.abs(np.asarray(params['kernel']) - p0['kernel']).max() > 1e-3
    if name == 'adam_onecycle':
        assert t_sched(0) == pytest.approx(0.001) and t_sched(2) == pytest.approx(0.01)
        assert t_sched(5) == pytest.approx(1e-6)


def test_unknown_optimizer_raises():
    with pytest.raises(NotImplementedError):
        t_opt.build_optimizer_and_schedule([torch.nn.Parameter(torch.zeros(2, 2))],
                                           _opt_cfg(TCfgNode, OPTIMIZER='lamb'), 5, 1)


# ---- three train steps ---------------------------------------------------------

def test_three_train_steps_track_jax(pair):
    """Both packages take three steps on one batch from the same state, the
    JAX side's bf16 extraction emulated in the port. Adam's first updates
    have the size of the rate whatever the gradient's size, so the bf16
    rounding of the JAX grouping gradient moves some weights apart by a
    fraction of the rate per step. Measured: the losses agree to 4e-6, 4e-5
    and 6.3e-3 relative at steps 1, 2 and 3; the bound is 3e-2."""
    j_losses_, _, _ = jax_train_steps(pair, 3)
    net = pair.net
    net.load_state_dict(from_flax(pair.variables, net))
    optimizer, _ = create_train_state(net, TCfgNode(pair.cfg.OPTIMIZATION.to_dict()), 10, 2)
    t_step = make_train_step(net, optimizer)
    t_losses_ = []
    for _ in range(3):
        with jax_bf16_extraction():
            t_metrics = t_step(pair.torch_batch())
        assert set(t_metrics) == set(pair.jax_loss_and_grads()[1])
        t_losses_.append(float(t_metrics['loss']))
    net.load_state_dict(from_flax(pair.variables, net))
    net.eval()
    print('jax', j_losses_, 'port', t_losses_)
    np.testing.assert_allclose(t_losses_, j_losses_, rtol=3e-2)
    np.testing.assert_allclose(t_losses_[0], j_losses_[0], rtol=EMULATED_RTOL)
    assert t_losses_[-1] < t_losses_[0] and j_losses_[-1] < j_losses_[0]
    assert optimizer.count == 3


# ---- synthetic batch, dry run, device rule -------------------------------------

def test_synthetic_batch_is_the_jax_dry_run_batch():
    import __graft_entry__ as graft
    want = graft._make_batch(3, 200, M=5, seed=4)
    got = synthetic.kitti_batch(3, 200, M=5, seed=4)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(synthetic.kitti_points(3, 200, 4), want['points'])


def test_tiny_flagship_cfg_is_the_jax_dry_run_shrink(pair, monkeypatch):
    import __graft_entry__ as graft
    from pdm_ssd_torch.utils.config import cfg_from_yaml_file
    monkeypatch.chdir(graft.REPO)
    cfg = synthetic.tiny_flagship_cfg(
        cfg_from_yaml_file('configs/kitti_models/pdm_ssd_point.yaml', TCfgNode()))
    want = pair.cfg.MODEL.to_dict()
    want['PDM_NECK'].pop('POINT_CLOUD_RANGE', None)     # added by the JAX model's setup
    assert cfg.MODEL.to_dict() == want


def test_dryrun_trains_and_predicts_on_the_cpu(capsys):
    from pdm_ssd_torch.tools.dryrun import dryrun
    loss = dryrun('cpu')
    assert np.isfinite(loss)
    assert 'train step + predict OK, loss=' in capsys.readouterr().out


def test_predict_refuses_training_mode_and_forward_honours_it(pair):
    net = pair.net
    net.load_state_dict(from_flax(pair.variables, net))
    batch = {'points': torch.from_numpy(pair.points)}
    net.train()
    try:
        with pytest.raises(RuntimeError, match='eval'):
            net.predict(batch)
        with torch.no_grad():
            train_out = net(batch)['point_cls_preds']
    finally:
        net.load_state_dict(from_flax(pair.variables, net))
        net.eval()
    with torch.no_grad():
        eval_out = net(batch)['point_cls_preds']
    assert (train_out - eval_out).abs().max() > 1e-3      # batch vs running statistics
