"""Voxel R-CNN in the port against the JAX package, on the CPU: the tiny
shrinks of `voxel_rcnn.yaml` (the dense ladder: `VoxelNeighborAgg` over the
volumes) and `voxel_rcnn_sparse.yaml` (the sparse ladder:
`SparseVoxelNeighborAgg` over the slot tables, TABLE_DTYPE dropped on both
sides: `synthetic.tiny_voxel_rcnn_cfg`). The ROI head's voxel pools, the
targets, losses, gradients and `predict`. One set of randomized weights is
carried by `from_flax`; inputs come from numpy seeds; both packages run
float32 (no bf16 on this path); JAX runs jitted. Each tolerance stands beside
its reason.
"""
import numpy as np
import pytest
import torch

from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_harness import (assert_close_to_scale, check_predict, check_training,
                                check_weights_round_trip, to_numpy, two_stage_pair)

# the eval forward: float32 sums in another order through the ladder, the
# pools and the ROI head
FWD_RTOL = 1e-4
# training losses and per-leaf gradients (relative L2) against the JAX
# package, the issue's bounds, or its float64 run where its float32 strays
# (the dense ladder's training-mode statistics in float32 move its
# gradients by up to 1.2e-2 from its float64; the port's lie within 1.9e-5
# of that float64, its losses within 6.3e-6)
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-3
JAX_F32_LOSS_RTOL = 3e-3
JAX_F32_GRAD_REL_L2 = 2e-2
BOX_ATOL = 1e-3
CONFIGS = ['voxel_rcnn', 'voxel_rcnn_sparse']


@pytest.fixture(scope='module', params=CONFIGS)
def pair(request):
    return two_stage_pair(request.param)


def test_weights_round_trip(pair):
    check_weights_round_trip(pair, ['roi_head.agg_x_conv2.fc0', 'roi_head.agg_x_conv3.bn1',
                                    'roi_head.agg_x_conv4.fc1', 'roi_head.shared_fc',
                                    'roi_head.cls_fc', 'roi_head.reg_fc'])
    assert pair.net.pfe is None and pair.net.point_head is None


def test_forward_matches_jax(pair):
    """The eval forward: the proposals and their mask exact, the pooled
    features through the ROI head's predictions."""
    J = pair.jax_out
    with torch.no_grad():
        T = to_numpy(pair.net(pair.torch_inputs()))
    np.testing.assert_array_equal(T['roi_mask'], J['roi_mask'])
    np.testing.assert_array_equal(T['roi_labels'], J['roi_labels'])
    assert J['roi_mask'].sum() >= 8
    for k in ('spatial_features', 'batch_box_preds', 'rois', 'roi_scores', 'rcnn_cls_preds',
              'rcnn_reg_preds'):
        assert_close_to_scale(T[k], J[k], FWD_RTOL, k)


def test_roi_head_matches_jax_on_the_jax_inputs(pair):
    """The ROI head alone, fed the JAX ladder's stages and proposals."""
    J = pair.jax_out
    keys = ('batch_cls_preds', 'batch_box_preds')
    batch = {k: torch.from_numpy(J[k]) for k in keys}
    for key in ('multi_scale_3d_features', 'multi_scale_3d_features_sparse'):
        if key in J:
            batch[key] = {s: tuple(torch.from_numpy(np.asarray(a)) if not np.isscalar(a) else a
                                   for a in v) for s, v in J[key].items()}
    with torch.no_grad():
        out = pair.net.roi_head(batch)
    for k in ('rcnn_cls_preds', 'rcnn_reg_preds'):
        assert_close_to_scale(out[k].numpy(), J[k], 1e-5, k)


def test_training_loss_and_gradients_match_jax(pair):
    tb = check_training(pair, LOSS_RTOL, GRAD_REL_L2, JAX_F32_LOSS_RTOL, JAX_F32_GRAD_REL_L2)
    assert {'anchor_cls_loss', 'rcnn_cls_loss', 'rcnn_reg_loss', 'rcnn_corner_loss',
            'loss'} <= set(tb)


def test_predict_matches_jax(pair):
    assert check_predict(pair, BOX_ATOL) >= 4
