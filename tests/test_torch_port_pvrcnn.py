"""PV-RCNN in the port against the JAX package, on the CPU: the tiny shrinks
of `pv_rcnn.yaml` (the dense ladder) and `pv_rcnn_sparse.yaml` (the sparse
ladder, TABLE_DTYPE dropped on both sides: `synthetic.tiny_pv_rcnn_cfg`).
`VoxelSetAbstraction` (FPS keypoints, the BEV, raw-point and voxel
sources), `PointHeadSimple` on the features before fusion, the grid pool of
`PVRCNNHead`, the targets, losses, gradients and `predict`. One set of
randomized weights is carried by `from_flax`; inputs come from numpy seeds;
both packages run float32; JAX runs jitted. Each tolerance stands beside its
reason.
"""
import jax
import numpy as np
import pytest
import torch

from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_harness import (F64_RTOL, _GridPoolBf16, assert_close_to_scale, check_predict,
                                check_training, check_weights_round_trip, jax_bf16_extraction,
                                jax_pool_max_by_argmax, jax_target_draw, leaves,
                                port_loss_and_grads, rel_l2, to_numpy, train_steps,
                                two_stage_pair)

# the eval forward with the JAX package's bf16 extraction emulated: float32
# sums in another order through the ladder, the VSA and the ROI head
FWD_RTOL = 1e-4
# the ROI head's predictions without that emulation, the port in float32
# throughout where the JAX package rounds the grid pool's offsets and
# projected features to bf16 (pvrcnn_head.py:119, 145-147): 2.0e-3 of scale
# measured on the dense tiny model (ROADMAP Queue 3, known deviations)
GRID_BF16_RTOL = 5e-3
# training losses and per-leaf gradients (relative L2) against the JAX
# package, the issue's bounds. Where the JAX package's float32 strays from
# its float64 (the dense ladder's training-mode statistics move its ROI
# losses by up to 3.4e-4 and its gradients by up to 4.0e-3), `hold_to_jax`
# holds the port's float64 run to the JAX package's within 1e-9 (5.4e-13
# measured) and the port's float32 no further from that float64 than the
# JAX package's own float32 (the corner loss 3.8e-5 against 3.4e-4, the
# VSA's sa_raw.pre_feat_1 1.3e-3 against 4.0e-3). Controls, on the dense
# tiny model: the port without the bf16 emulation is 8.6e-4 from the JAX
# float64 on the corner loss and 0.18 on sa_raw.pre_feat_1; the emulation
# rounding the grid pool's cotangent a sample at a time puts the port's
# float64 2.7e-4 from the JAX package's on roi_head.pre_feat_1
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-3
JAX_F32_LOSS_RTOL = 3e-3
JAX_F32_GRAD_REL_L2 = 2e-2
# the loss of each of a few training steps: the runs drift apart by float32
# rounding amplified by Adam (test_train_steps_track_jax)
STEPS_RTOL = 2e-2
BOX_ATOL = 1e-3
CONFIGS = ['pv_rcnn', 'pv_rcnn_sparse']


@pytest.fixture(scope='module', params=CONFIGS)
def pair(request):
    return two_stage_pair(request.param)


def test_weights_round_trip(pair):
    """Every leaf of the JAX tree, the VSA's and the grid pool's included."""
    check_weights_round_trip(pair, ['pfe.agg_x_conv3.fc0', 'pfe.agg_x_conv4.bn1',
                                    'pfe.sa_raw.pre_feat_0', 'pfe.sa_raw.mlp_rest_1',
                                    'pfe.fusion', 'pfe.fusion_bn', 'point_head.cls_layers',
                                    'roi_head.pre_feat_1', 'roi_head.pre_xyz_1',
                                    'roi_head.bn0_0', 'roi_head.mlp_rest_0',
                                    'roi_head.shared_fc', 'roi_head.cls_fc', 'roi_head.reg_fc'])


def test_point_head_reads_the_features_before_fusion(pair):
    """USE_POINT_FEATURES_BEFORE_FUSION: the point head's first layer takes
    the sources' widths together (the BEV map's 24, the raw points' 8 + 8,
    x_conv3's and x_conv4's 16 each), not NUM_OUTPUT_FEATURES, which the JAX
    package passes and flax's Dense ignores."""
    net = pair.net
    assert net.pfe.num_fused_features == net.backbone_3d.num_bev_features + 16 + 16 + 16
    assert net.point_head.cls_layers.Dense_0.in_features == net.pfe.num_fused_features
    assert pair.jax_out['point_features_before_fusion'].shape[-1] == net.pfe.num_fused_features


def test_forward_matches_jax(pair):
    """The eval forward with the bf16 extraction emulated: the keypoints
    exact (FPS indices), the VSA's features, the proposals and their mask
    exact, the ROI head's predictions."""
    J = pair.jax_out
    with torch.no_grad(), jax_bf16_extraction():
        T = to_numpy(pair.net(pair.torch_inputs()))
    np.testing.assert_array_equal(T['point_coords'], J['point_coords'])
    np.testing.assert_array_equal(T['roi_mask'], J['roi_mask'])
    np.testing.assert_array_equal(T['roi_labels'], J['roi_labels'])
    assert J['roi_mask'].sum() >= 8
    for k in ('spatial_features', 'point_features_before_fusion', 'point_features',
              'aux_point_cls_preds', 'batch_box_preds', 'rois', 'roi_scores',
              'rcnn_cls_preds', 'rcnn_reg_preds'):
        assert_close_to_scale(T[k], J[k], FWD_RTOL, k)


def test_grid_pool_selection_is_the_jax_selection_exactly(pair):
    """The grid pool's indices on the JAX first stage's outputs against a
    numpy recomputation of the JAX package's selection
    (pvrcnn_head.py:110-133): within = sum((p - g)^2) < r^2 over the
    preselected keypoints (valid ones only), ranked in slot order; slot k
    takes the hit of rank k, a slot past the hits the first hit; an empty
    ball is flagged (it extracts zeros)."""
    keys = ('point_coords', 'point_features', 'batch_cls_preds', 'batch_box_preds')
    batch = {k: torch.from_numpy(pair.jax_out[k]) for k in keys}
    head = pair.net.roi_head
    with torch.no_grad():
        batch = head.proposal_layer(batch)
        _, valid, sel_xyz, grid, gidx, empties = head.grid_select(batch, batch['rois'])
    p, g = sel_xyz.numpy(), grid.numpy()
    v = valid.reshape(len(p), -1).numpy()
    d = p[:, None, :, :] - g[:, :, None, :]                        # (BR, G3, P, 3)
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    n_hit = 0
    for r, K, gi, empty in zip(head.radii, head.nsamples, gidx, empties):
        within = (d2 < np.float32(r * r)) & v[:, None, :]
        rank = np.cumsum(within, -1) - within
        hits = within.sum(-1)
        want = np.zeros(hits.shape + (K,), np.int64)
        for k in range(K):
            pick = within & (rank == k)
            first = within & (rank == 0)
            want[..., k] = np.where(k < hits, pick.argmax(-1), first.argmax(-1))
        live = hits > 0
        np.testing.assert_array_equal(empty.numpy(), ~live)
        np.testing.assert_array_equal(gi.numpy()[live], want[live])
        n_hit += int(live.sum())
    assert n_hit > 0.2 * sum(e.numel() for e in empties)


def test_grid_pool_bf16_gap_is_within_its_bound(pair):
    """The ROI head alone on the JAX first stage's outputs, without the bf16
    emulation: the port's float32 extraction within GRID_BF16_RTOL of the
    JAX package's bf16 one, and to float32 rounding with the emulation."""
    keys = ('point_coords', 'point_features', 'batch_cls_preds', 'batch_box_preds')
    J = pair.jax_out
    with torch.no_grad():
        plain = pair.net.roi_head({k: torch.from_numpy(J[k]) for k in keys})
        with jax_bf16_extraction():
            emulated = pair.net.roi_head({k: torch.from_numpy(J[k]) for k in keys})
    for k in ('rcnn_cls_preds', 'rcnn_reg_preds'):
        assert_close_to_scale(emulated[k].numpy(), J[k], FWD_RTOL, k)
        assert_close_to_scale(plain[k].numpy(), J[k], GRID_BF16_RTOL, k)
        assert np.abs(plain[k].numpy() - J[k]).max() > 0


def test_training_loss_and_gradients_match_jax(pair):
    tb = check_training(pair, LOSS_RTOL, GRAD_REL_L2, JAX_F32_LOSS_RTOL, JAX_F32_GRAD_REL_L2)
    assert {'anchor_cls_loss', 'aux_point_loss_cls', 'rcnn_cls_loss', 'rcnn_reg_loss',
            'rcnn_corner_loss', 'loss'} <= set(tb)


@pytest.mark.parametrize('pair', ['pv_rcnn'], indirect=True)
def test_train_steps_track_jax(pair):
    """Four steps of both packages' training from the same weights on the
    planted batch, the optimizer and schedule of `pv_rcnn.yaml`
    (`torch_port_harness.train_steps`). Adam's first updates have the size
    of the rate whatever the gradient's size, so float32 rounding moves some
    weights apart by a fraction of the rate a step and the runs drift apart.
    Measured: the losses agree to 1.9e-5, 5.3e-5, 6.0e-4 and 4.7e-3 relative
    at steps 1 to 4; the bound is STEPS_RTOL."""
    j_terms, t_terms = train_steps(pair, 4)
    assert j_terms[0]['rcnn_corner_loss'] > 0 and t_terms[0]['rcnn_corner_loss'] > 0
    for j, t in zip(j_terms, t_terms):
        assert set(j) == set(t)
        assert abs(t['loss'] - j['loss']) <= STEPS_RTOL * abs(j['loss'])
    assert t_terms[-1]['loss'] < t_terms[0]['loss'] and j_terms[-1]['loss'] < j_terms[0]['loss']


def test_predict_matches_jax(pair):
    assert check_predict(pair, BOX_ATOL) >= 4


def test_keypoints_are_the_fps_of_the_raw_cloud(pair):
    """The first keypoint is point 0 of each cloud, and the keypoints are the
    JAX package's FPS picks of the raw points (exact: the same indices)."""
    from pdm_ssd_tpu.ops import dispatch as j_dispatch
    pts = pair.inputs['points'][..., :3]
    idx = np.asarray(jax.jit(lambda x: j_dispatch.farthest_point_sample(x, 64))(pts))
    want = np.take_along_axis(pts, idx[..., None].astype(np.int64), 1)
    np.testing.assert_array_equal(pair.jax_out['point_coords'], want)
    with torch.no_grad():
        got = pair.net.pfe(pair.net.first_stage(pair.torch_inputs()))['point_coords']
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[:, 0], pts[:, 0])


@pytest.mark.parametrize('pair', ['pv_rcnn'], indirect=True)
def test_float64_hold_catches_a_cotangent_rounded_a_sample_at_a_time(pair):
    """The control of `hold_to_jax`'s float64 check, on the dense ladder
    whose float64 run is float64 throughout in both packages: with the grid
    pool's cotangent rounded to bf16 a sample at a time, not as the JAX
    package rounds it, the port's float64 gradients lie further than
    F64_RTOL from the JAX package's float64 ones; with the emulation as it
    is, within."""
    batch = pair.torch_inputs()
    batch['roi_target_rand'] = jax_target_draw(pair)
    with jax_pool_max_by_argmax():
        want = dict(leaves(pair.jax_f64_loss_and_grads()[1]))

    def worst():
        with jax_bf16_extraction():
            got = dict(leaves(port_loss_and_grads(pair, batch, torch.float64)[2]))
        return max(rel_l2(got[k], want[k]) for k in want)

    assert worst() <= F64_RTOL
    backward = _GridPoolBf16.backward
    _GridPoolBf16.backward = staticmethod(
        lambda ctx, g: (g.to(torch.bfloat16).to(g.dtype), None))
    try:
        assert worst() > 1e3 * F64_RTOL
    finally:
        _GridPoolBf16.backward = backward
