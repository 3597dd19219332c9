"""Part-A2 in the port against the JAX package, on the CPU: the tiny shrinks
of `parta2.yaml` (`DenseUNetV2`: the dense ladder, three transposed-conv
decoder steps, the point features read at the input voxels) and
`parta2_sparse.yaml` (`SparseUNetV2`: the sparse ladder's encoder and four UR
blocks through the inverse maps, TABLE_DTYPE dropped on both sides:
`synthetic.tiny_parta2_cfg`). `PointIntraPartOffsetHead` (segmentation, part
locations, their targets and losses), `roiaware_pool` (average and
maximum), `PartA2FCHead`, the losses, gradients and `predict`. One set of
randomized weights is carried by `from_flax`; inputs come from numpy seeds;
both packages run float32; JAX runs jitted. Each tolerance stands beside
its reason.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_harness import (ModelPair, assert_close_to_scale, check_predict,
                                check_training, check_weights_round_trip,
                                jax_bf16_extraction, load_cfg, rel_l2, to_numpy,
                                two_stage_pair)

# the eval forward with the JAX package's bf16 average pool emulated: float32
# sums in another order through the UNet, the pools and the ROI head
FWD_RTOL = 1e-4
# the ROI head without that emulation, the port in float32 where the JAX
# package rounds the averaged part features to bf16 (roiaware.py:61-66):
# 6.8e-5 to 1.4e-4 of scale measured on the tiny models (ROADMAP Queue 3)
POOL_BF16_RTOL = 1e-3
# roiaware_pool alone: the average's sums in another order, the maximum exact
POOL_RTOL = 1e-6
# training losses and per-leaf gradients (relative L2) against the JAX
# package, or its float64 run where its float32 strays (the dense ladder's
# training-mode statistics, as in tests/test_torch_port_pvrcnn.py)
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-3
JAX_F32_LOSS_RTOL = 3e-3
JAX_F32_GRAD_REL_L2 = 2e-2
# `parta2_sparse.yaml` as shipped: the JAX UNet gathers, multiplies and
# normalises in bf16 (`TABLE_DTYPE: bf16`), the port in float32. Measured on
# the tiny model: 4.7e-3 of `spatial_features`' scale, 5.7e-3 of the UNet's
# point features', 1.4e-3 of the segmentation scores', 4.1e-4 of the boxes'
# (the sparse SECOND's bound, tests/test_torch_port_sparse.py)
BF16_TABLE_RTOL = 3e-2
BOX_ATOL = 1e-3
CONFIGS = ['parta2', 'parta2_sparse']


@pytest.fixture(scope='module', params=CONFIGS)
def pair(request):
    # the ground truth on the ROIs that hold the most voxel points
    return two_stage_pair(request.param, occupied=True)


def test_weights_round_trip(pair):
    """Every leaf of the JAX tree: the UNet's decoder (the transposed convs'
    flipped kernels), the part head, the ROI head's 3D convs."""
    names = ['point_head.cls_layers.Dense_1', 'point_head.part_reg_layers.BatchNorm_0',
             'roi_head.part_conv0', 'roi_head.part_bn0', 'roi_head.rpn_conv0', 'roi_head.down_conv',
             'roi_head.down_bn', 'roi_head.shared_fc', 'roi_head.cls_fc', 'roi_head.reg_fc']
    if pair.cfg.MODEL.BACKBONE_3D.NAME == 'DenseUNetV2':
        names += ['backbone_3d.up3_deconv', 'backbone_3d.up2_bn', 'backbone_3d.up1_skip',
                  'backbone_3d.up1_fuse.Conv_0', 'backbone_3d.conv4b.BatchNorm_0']
    else:
        names += ['backbone_3d.up4_t.SparseConvBNReLU_1', 'backbone_3d.up3_m',
                  'backbone_3d.up2_inv', 'backbone_3d.up1_inv', 'backbone_3d.conv1_subm0']
    check_weights_round_trip(pair, names)
    assert pair.net.pfe is None


@pytest.mark.parametrize('shape', [(5, 6, 4), (3, 2, 7)])
def test_conv_transpose_same_matches_flax(shape):
    """flax's 3D `ConvTranspose` (stride 2, 'SAME') through the weight
    converter's flipped kernel: even and odd sizes, exact to float32
    rounding."""
    import flax.linen as fnn
    from pdm_ssd_torch.models.backbones_3d.voxel_backbone import conv_transpose_same
    from pdm_ssd_torch.utils.weights import from_flax
    rng = np.random.RandomState(2)
    x = rng.randn(2, *shape, 3).astype(np.float32)
    layer = fnn.ConvTranspose(5, (3, 3, 3), strides=(2, 2, 2), padding='SAME', use_bias=False)
    params = layer.init(jax.random.PRNGKey(0), x)
    want = np.asarray(layer.apply(params, x))
    module = torch.nn.Module()
    module.deconv = torch.nn.ConvTranspose3d(3, 5, 3, stride=2, bias=False)
    module.load_state_dict(from_flax({'params': {'deconv': params['params']}}, module))
    got = conv_transpose_same(module.deconv, torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert_close_to_scale(got.permute(0, 2, 3, 4, 1).detach().numpy(), want, 1e-6, 'deconv')


def _pool_inputs(seed):
    """Points clustered in a few ROIs (some ROIs empty, one masked off),
    features, rotated ROIs."""
    rng = np.random.RandomState(seed)
    B, N, R, C = 2, 400, 6, 5
    rois = np.concatenate([rng.uniform(-5, 5, (B, R, 3)), rng.uniform(1, 3, (B, R, 3)),
                           rng.uniform(-3, 3, (B, R, 1))], -1).astype(np.float32)
    rois[:, R - 2:, 0] += 30.0                              # the last two ROIs hold no points
    owner = rng.randint(0, R - 2, (B, N))
    centre = np.take_along_axis(rois[..., :3], owner[..., None], 1)
    pts = (centre + rng.uniform(-0.7, 0.7, (B, N, 3))).astype(np.float32)
    feats = rng.randn(B, N, C).astype(np.float32)
    mask = np.ones((B, R), bool)
    mask[1, 0] = False
    return pts, feats, rois, mask


@pytest.mark.parametrize('pool', ['avg', 'max'])
def test_roiaware_pool_and_its_gradient_match_jax(pool):
    """`roiaware_pool` against the JAX package's on clustered points (empty
    and masked ROIs included): the pooled grid, and the gradient of a
    weighted sum in the features. The average under the bf16 emulation of
    the JAX package's one-hot product (`_Bf16`); the maximum exact, its
    gradient held to the JAX package's jitted and op-by-op gradients."""
    from pdm_ssd_torch.ops import roiaware
    from pdm_ssd_tpu.ops import roiaware as j_roiaware
    pts, feats, rois, mask = _pool_inputs(7)
    G, P = 3, 32
    wts = np.random.RandomState(8).randn(2, 6, G, G, G, 5).astype(np.float32)

    def j_loss(f):
        out = j_roiaware.roiaware_pool(jnp.asarray(pts), f, jnp.asarray(rois), G, pool=pool,
                                       num_sampled=P, roi_mask=jnp.asarray(mask))
        return jnp.sum(out * wts), out

    (_, want), j_grad = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(feats)
    want, j_grad = np.asarray(want), np.asarray(j_grad)
    f = torch.from_numpy(feats).requires_grad_()
    with jax_bf16_extraction():
        got = roiaware.roiaware_pool(torch.from_numpy(pts), f, torch.from_numpy(rois), G, pool, P,
                                     torch.from_numpy(mask))
    (got * torch.from_numpy(wts)).sum().backward()
    assert_close_to_scale(got.detach().numpy(), want, POOL_RTOL, 'pooled')
    assert (want != 0).any(axis=-1).sum() > 20 and not want[:, 4:].any() and not want[1, 0].any()
    assert rel_l2(f.grad.numpy(), j_grad) <= POOL_RTOL * 10
    if pool == 'max':
        np.testing.assert_array_equal(got.detach().numpy(), want)
        op_by_op = np.asarray(jax.grad(lambda f: j_loss(f)[0])(feats))
        assert rel_l2(f.grad.numpy(), op_by_op) <= POOL_RTOL * 10


def test_jax_roiaware_jitted_max_gradient_agrees_on_normalised_features():
    """The fault XLA:CPU's jitted gradient of a masked max over BatchNorm'd
    features shows in the voxel pools (ROADMAP Queue 3,
    `jax_pool_max_by_argmax`) does not show in `roiaware_pool`'s max over
    batch-normalised ReLU features: jitted and op-by-op agree to float32
    rounding (3.3e-8 relative L2 measured), so the Part-A2 checks take the
    JAX package's jitted gradients as they are."""
    from pdm_ssd_tpu.ops import roiaware as j_roiaware
    pts, feats, rois, mask = _pool_inputs(7)
    wts = np.random.RandomState(8).randn(2, 6, 3, 3, 3, 5).astype(np.float32)

    def loss(f):
        mu = f.mean((0, 1))
        g = jax.nn.relu((f - mu) / jnp.sqrt(((f - mu) ** 2).mean((0, 1)) + 1e-3))
        out = j_roiaware.roiaware_pool(jnp.asarray(pts), g, jnp.asarray(rois), 3, pool='max',
                                       num_sampled=32, roi_mask=jnp.asarray(mask))
        return jnp.sum(out * wts)

    jitted = np.asarray(jax.jit(jax.grad(loss))(feats))
    assert rel_l2(jitted, np.asarray(jax.grad(loss)(feats))) <= 1e-6
    assert np.abs(jitted).max() > 0


def test_forward_matches_jax(pair):
    """The eval forward with the bf16 average emulated: the UNet's point
    features, the part head, the proposals and their mask exact, the ROI
    head's predictions."""
    J = pair.jax_out
    with torch.no_grad(), jax_bf16_extraction():
        T = to_numpy(pair.net(pair.torch_inputs()))
    for k in ('point_mask', 'roi_mask', 'roi_labels', 'point_coords'):
        np.testing.assert_array_equal(T[k], J[k], err_msg=k)
    assert J['roi_mask'].sum() >= 8
    for k in ('spatial_features', 'point_features', 'point_cls_preds', 'point_part_preds',
              'point_cls_scores', 'point_part_offset', 'batch_box_preds', 'rois', 'roi_scores',
              'rcnn_cls_preds', 'rcnn_reg_preds'):
        assert_close_to_scale(T[k], J[k], FWD_RTOL, k)


def test_roi_pools_hold_points_and_the_bf16_gap_is_within_its_bound(pair):
    """The ROI head alone on the JAX first stage's outputs: several ROIs
    pool points; without the emulation the port's float32 average is within
    POOL_BF16_RTOL of the JAX package's bf16 one, and to float32 rounding
    with it."""
    from pdm_ssd_torch.ops import roiaware
    J = pair.jax_out
    keys = ('point_coords', 'point_features', 'point_mask', 'point_cls_scores',
            'point_part_offset', 'batch_cls_preds', 'batch_box_preds')
    batch = {k: torch.from_numpy(J[k]) for k in keys}
    head = pair.net.roi_head
    with torch.no_grad():
        rois = head.proposal_layer(dict(batch))
        _, valid, _ = roiaware.roi_cells(rois['point_coords'], rois['rois'], head.grid,
                                         head.max_points, rois['roi_mask'])
        plain = head(dict(batch))
        with jax_bf16_extraction():
            emulated = head(dict(batch))
    assert (valid.sum(-1) > 0).sum() >= 6
    for k in ('rcnn_cls_preds', 'rcnn_reg_preds'):
        assert_close_to_scale(emulated[k].numpy(), J[k], FWD_RTOL, k)
        assert_close_to_scale(plain[k].numpy(), J[k], POOL_BF16_RTOL, k)
        assert np.abs(plain[k].numpy() - J[k]).max() > 0


def test_part_targets_and_losses_match_jax(pair):
    """`assign_targets` of the part head on the planted ground truth (labels
    exact, the ignore zone and masked points included; part targets to
    float32 rounding) and `get_loss` on the JAX forward's predictions."""
    from pdm_ssd_tpu.models.dense_heads.point_intra_part_head import \
        PointIntraPartOffsetHead as JHead
    from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
    J = pair.jax_out
    gt = {'gt_boxes': pair.batch['gt_boxes'], 'gt_mask': pair.batch['gt_mask']}
    jhead = JHead(model_cfg=JCfgNode(pair.cfg.MODEL.POINT_HEAD.to_dict()), input_channels=4,
                  num_class=1)
    b = {'point_coords': J['point_coords'], 'point_mask': J['point_mask'], **gt}
    want = to_numpy(jax.jit(jhead.assign_targets)(b))
    head = pair.net.point_head
    got = to_numpy(head.assign_targets({k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}))
    np.testing.assert_array_equal(got['point_cls_labels'], want['point_cls_labels'])
    assert (want['point_cls_labels'] == 1).sum() >= 2 and (want['point_cls_labels'] == -1).any()
    assert_close_to_scale(got['point_part_labels'], want['point_part_labels'], 1e-5, 'part')
    preds = {k: J[k] for k in ('point_cls_preds', 'point_part_preds')}
    j_loss, j_tb = jax.jit(jhead.get_loss)(preds, want)
    t_loss, t_tb = head.get_loss({k: torch.from_numpy(v) for k, v in preds.items()},
                                 {k: torch.from_numpy(v) for k, v in got.items()})
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=LOSS_RTOL)
    for k in j_tb:
        np.testing.assert_allclose(float(t_tb[k]), float(j_tb[k]), rtol=LOSS_RTOL, err_msg=k)


def test_training_loss_and_gradients_match_jax(pair):
    tb = check_training(pair, LOSS_RTOL, GRAD_REL_L2, JAX_F32_LOSS_RTOL, JAX_F32_GRAD_REL_L2)
    assert {'anchor_cls_loss', 'part_seg_loss', 'part_reg_loss', 'rcnn_cls_loss',
            'rcnn_reg_loss', 'rcnn_corner_loss', 'loss'} <= set(tb)


def test_predict_matches_jax(pair):
    assert check_predict(pair, BOX_ATOL) >= 4


@pytest.mark.parametrize('training', [False, True])
def test_sparse_unet_batches_match_jax(training):
    """`get_host_prepare` of `parta2_sparse.yaml`'s shrink: the inverse maps
    of the three strided convs in eval and in training (and conv_out's in
    training only), equal to the JAX package's C builder's."""
    from pdm_ssd_torch.models import get_host_prepare
    from pdm_ssd_torch.utils import synthetic
    from pdm_ssd_tpu.models import get_host_prepare as j_get_host_prepare
    from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
    cfg = load_cfg('parta2_sparse')
    synthetic.TINY_CFGS[cfg.MODEL.NAME](cfg)
    raw = synthetic.voxel_batch(2, 3000, cfg, seed=3)
    jcfg = JCfgNode(cfg.to_dict())
    want = j_get_host_prepare(jcfg.MODEL, jcfg.DATA_CONFIG, training=training)(
        {k: v.numpy() for k, v in raw.items()})
    got = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG, training=training)(dict(raw))
    keys = [f'sp_upmap{s}' for s in (2, 3, 4)] + (['sp_upmap_out'] if training else [])
    assert ('sp_upmap_out' in got) == training == ('sp_upmap_out' in want)
    for k in keys + ['sp_submap1', 'sp_downmap2', 'sp_coords1', 'sp_mask4']:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@functools.lru_cache
def _shipped_sparse_pair():
    from pdm_ssd_torch.utils import synthetic
    cfg = load_cfg('parta2_sparse')
    synthetic.TINY_CFGS[cfg.MODEL.NAME](cfg)
    cfg.MODEL.BACKBONE_3D.TABLE_DTYPE = 'bf16'
    return ModelPair(cfg, B=2, N=3000, seed=0, voxels=True, bias_scale=0.1)


def test_sparse_as_shipped_deviates_by_the_bf16_tables_only():
    """The file's TABLE_DTYPE bf16 on the tiny UNet: the JAX ladder and
    decoder run their tables in bf16, the port stays in float32. The
    deviation is measured and bounded (BF16_TABLE_RTOL), and real."""
    pair = _shipped_sparse_pair()
    J = pair.jax_out
    with torch.no_grad(), jax_bf16_extraction():
        T = to_numpy(pair.net(pair.torch_inputs()))
    rel = {}
    for k in ('spatial_features', 'point_features', 'point_cls_scores', 'batch_box_preds'):
        w = J[k].astype(np.float64)
        rel[k] = np.abs(T[k] - w).max() / np.abs(w).max()
        assert_close_to_scale(T[k], w, BF16_TABLE_RTOL, k)
    print('deviation from the bf16 tables, of each output\'s scale:',
          {k: f'{v:.2e}' for k, v in rel.items()})           # shown by pytest -s
    assert max(rel.values()) > 10 * FWD_RTOL
