"""PV-RCNN++ in the port against the JAX package, on the CPU: the tiny
shrinks of `pv_rcnn_plusplus.yaml` (the dense ladder) and
`pv_rcnn_plusplus_sparse.yaml` (the sparse ladder, TABLE_DTYPE dropped on
both sides: `synthetic.tiny_pv_rcnn_plusplus_cfg`). The masked FPS and the
sector FPS (indices exact), SPC keypoints near the proposals,
`VectorPoolAgg`, the proposals and targets drawn before the keypoints, the
losses, gradients and `predict`. One set of randomized weights is carried
by `from_flax`; inputs come from numpy seeds; both packages run float32;
JAX runs jitted. Each tolerance stands beside its reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_harness import (assert_close_to_scale, check_predict, check_training,
                                check_weights_round_trip, jax_bf16_extraction,
                                randomize_variables, to_numpy, two_stage_pair)

# the eval forward with the JAX package's bf16 extraction emulated: float32
# sums in another order through the ladder, the VSA and the ROI head
FWD_RTOL = 1e-4
# VectorPoolAgg alone on the emulated extraction: the sub-voxel sums and the
# MLP in another order
VP_RTOL = 1e-5
# training losses and per-leaf gradients (relative L2) against the JAX
# package, or its float64 run where its float32 strays (as in
# tests/test_torch_port_pvrcnn.py). On the dense tiny model every term of
# the port lies nearer the float64 run than the JAX package's (the ROI
# corner and box terms 3.5e-4 and 2.0e-4 against 4.4e-4 and 4.3e-4), but
# the JAX package's errors in those two cancel in the total (7.6e-6 against
# the port's 1.7e-5): the total is held to the JAX package's summed term
# errors (`hold_to_jax`'s `total`). The JAX package's own float32 gradient
# of roi_head.pre_feat_0 lies 2.3e-2 from its float64 one on the dense tiny
# model (the dense ladder's training-mode statistics, through the SPC
# keypoints' pooled features), above PR 13's 2e-2
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-3
JAX_F32_LOSS_RTOL = 3e-3
JAX_F32_GRAD_REL_L2 = 5e-2
BOX_ATOL = 1e-3
CONFIGS = ['pv_rcnn_plusplus', 'pv_rcnn_plusplus_sparse']


@pytest.fixture(scope='module', params=CONFIGS)
def pair(request):
    return two_stage_pair(request.param)


def _sector_clouds():
    """Clouds for the sector FPS: a full one, one with three empty sectors
    (no point at negative y), one whose valid points leave two sectors
    smaller than the cap, one with no valid point."""
    rng = np.random.RandomState(11)
    B, N = 4, 900
    xyz = rng.uniform(-25, 25, (B, N, 3)).astype(np.float32)
    xyz[1, :, 1] = np.abs(xyz[1, :, 1])
    valid = rng.rand(B, N) < 0.7
    ang = np.arctan2(xyz[2, :, 1], xyz[2, :, 0])
    valid[2] &= ~((ang > 0) & (rng.rand(N) < 0.97))          # two thin sectors
    valid[3] = False
    return xyz, valid


@pytest.mark.parametrize('cap', [64, 150])
def test_masked_fps_matches_jax(cap):
    """The plain masked FPS against the JAX package's, index for index: rows
    with no valid point, fewer valid points than picks (the tail picks the
    lowest valid index)."""
    from pdm_ssd_torch.ops import pointnet2 as t_p2
    from pdm_ssd_tpu.ops import pointnet2 as j_p2
    xyz, valid = _sector_clouds()
    want = np.asarray(j_p2.farthest_point_sample(jnp.asarray(xyz), cap, mask=jnp.asarray(valid)))
    got = t_p2.farthest_point_sample(torch.from_numpy(xyz), cap, mask=torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[3] == 0).all()


@pytest.mark.parametrize('npoint,cap', [(128, 128), (300, 64), (64, 900)])
def test_sector_fps_matches_jax(npoint, cap):
    """`sector_fps` against the JAX package's, index for index, on clouds
    with empty sectors and sectors smaller than their cap (one masked FPS
    launch of all 4 * 6 sector clouds on CUDA, the plain version here)."""
    from pdm_ssd_torch.ops import pointnet2 as t_p2
    from pdm_ssd_tpu.ops import pointnet2 as j_p2
    xyz, valid = _sector_clouds()
    want = np.asarray(jax.jit(lambda x, v: j_p2.sector_fps(x, v, npoint, 6,
                                                           per_sector_cap=cap))(xyz, valid))
    got = t_p2.sector_fps(torch.from_numpy(xyz), torch.from_numpy(valid), npoint, 6,
                          per_sector_cap=cap)
    np.testing.assert_array_equal(got.numpy(), want)


def test_vector_pool_matches_jax():
    """`VectorPoolAgg` alone (its weights by `from_flax`, randomized
    BatchNorm statistics) against the JAX module in eval mode, on keypoints
    with full, partial and empty balls, the bf16 extraction emulated."""
    from pdm_ssd_torch.models.backbones_3d.pfe import VectorPoolAgg
    from pdm_ssd_torch.utils.weights import from_flax
    from pdm_ssd_tpu.models.backbones_3d.pfe import VectorPoolAgg as JVectorPoolAgg
    rng = np.random.RandomState(3)
    xyz = rng.uniform([0, -8, -2], [16, 8, 1], (2, 800, 3)).astype(np.float32)
    feats = rng.rand(2, 800, 1).astype(np.float32)
    kp = np.concatenate([xyz[:, :40], rng.uniform([0, -8, 5], [16, 8, 6], (2, 8, 3))],
                        1).astype(np.float32)                     # the last 8 balls are empty
    args = dict(radius=0.8, nsample=32, local_grid=3, mlp=[16, 8], pc_range=(0.0, -8.0, 16.0, 8.0))
    jmod = JVectorPoolAgg(**args)
    variables = randomize_variables(  # the init jitted: one program instead of one an op
        jax.jit(lambda *a: jmod.init(jax.random.PRNGKey(0), *a))(xyz, feats, kp), 5, 0.1)
    want = np.asarray(jax.jit(lambda v: jmod.apply(v, xyz, feats, kp))(variables))
    holder = torch.nn.Module()
    holder.vp = VectorPoolAgg(1, 0.8, 32, 3, [16, 8], args['pc_range'])
    holder.load_state_dict(from_flax({k: {'vp': v} for k, v in variables.items()}, holder))
    holder.eval()
    with torch.no_grad(), jax_bf16_extraction():
        got = holder.vp(torch.from_numpy(xyz), torch.from_numpy(feats), torch.from_numpy(kp))
    assert_close_to_scale(got.numpy(), want, VP_RTOL, 'vector pool')
    assert not want[:, 40:].any() and (want[:, :40] != 0).any(-1).all()


def test_weights_round_trip(pair):
    check_weights_round_trip(pair, ['pfe.vp_raw.fc0', 'pfe.vp_raw.bn1', 'pfe.agg_x_conv3.fc0',
                                    'pfe.fusion', 'point_head.cls_layers', 'roi_head.pre_feat_0',
                                    'roi_head.shared_fc', 'roi_head.reg_fc'])
    assert not hasattr(pair.net.pfe, 'sa_raw')


def test_forward_matches_jax(pair):
    """The eval forward with the bf16 extraction emulated: the SPC
    keypoints exact, the VSA's features (VectorPool among them), the
    proposals and their mask exact, the ROI head's predictions."""
    J = pair.jax_out
    with torch.no_grad(), jax_bf16_extraction():
        T = to_numpy(pair.net(pair.torch_inputs()))
    for k in ('point_coords', 'roi_mask', 'roi_labels'):
        np.testing.assert_array_equal(T[k], J[k], err_msg=k)
    assert J['roi_mask'].sum() >= 8
    for k in ('spatial_features', 'point_features_before_fusion', 'point_features',
              'aux_point_cls_preds', 'batch_box_preds', 'rois', 'roi_scores', 'rcnn_cls_preds',
              'rcnn_reg_preds'):
        assert_close_to_scale(T[k], J[k], FWD_RTOL, k)


def test_keypoints_are_the_sector_fps_near_the_proposals(pair):
    """The keypoints are the sector FPS of the points within
    SAMPLE_RADIUS_WITH_ROI of a proposal (recomputed with the JAX package's
    `sector_fps` on the JAX forward's proposals), not the FPS of the cloud;
    a batch without proposals takes the FPS."""
    from pdm_ssd_torch.ops import dispatch
    from pdm_ssd_tpu.ops import pointnet2 as j_p2
    J = pair.jax_out
    pts = pair.inputs['points'][..., :3]
    rad = pair.cfg.MODEL.PFE.SPC_SAMPLING.SAMPLE_RADIUS_WITH_ROI
    d2 = ((pts[:, :, None, :2] - J['rois'][:, None, :, :2]) ** 2).sum(-1).min(-1)
    near = (d2 < np.float32(rad * rad)) | ~J['roi_mask'].any(-1, keepdims=True)
    assert 0 < near.sum() < near.size
    n = pair.cfg.MODEL.PFE.NUM_KEYPOINTS
    idx = np.asarray(jax.jit(lambda x, v: j_p2.sector_fps(x, v, n, 6, per_sector_cap=n))(pts,
                                                                                         near))
    np.testing.assert_array_equal(J['point_coords'],
                                  np.take_along_axis(pts, idx[..., None].astype(np.int64), 1))
    xyz = torch.from_numpy(pts)
    got = pair.net.pfe.keypoint_indices({}, xyz)
    np.testing.assert_array_equal(got.numpy(), dispatch.farthest_point_sample(xyz, n).numpy())


def test_training_loss_and_gradients_match_jax(pair):
    """The targets drawn before the keypoints, the keypoints near the drawn
    ROIs, the losses and every gradient."""
    tb = check_training(pair, LOSS_RTOL, GRAD_REL_L2, JAX_F32_LOSS_RTOL, JAX_F32_GRAD_REL_L2,
                        total='loss')
    assert {'anchor_cls_loss', 'aux_point_loss_cls', 'rcnn_cls_loss', 'rcnn_reg_loss',
            'rcnn_corner_loss', 'loss'} <= set(tb)


def test_predict_matches_jax(pair):
    assert check_predict(pair, BOX_ATOL) >= 4
