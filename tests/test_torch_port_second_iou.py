"""SECOND-IoU in the port against the JAX package, on the CPU: the tiny
shrink of `second_iou.yaml` (`synthetic.tiny_second_iou_cfg`: the dense
ladder, the anchor proposals, SECONDHead's rotated BEV crop and IoU logit).
The crop, the targets with CLS_SCORE_TYPE raw_roi_iou, the IoU loss of each
kind, the gradients and the IoU-rectified `predict`. One set of randomized
weights is carried by `from_flax`; inputs come from numpy seeds; both
packages run float32 (no bf16 on this path); JAX runs jitted. Each tolerance
stands beside its reason.
"""
import jax
import numpy as np
import pytest
import torch

from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_harness import (assert_close_to_scale, check_predict, check_training,
                                check_weights_round_trip, to_numpy, two_stage_pair)

# the eval forward: float32 sums in another order through the ladder, the
# BEV convs, the crop and the FC layers
FWD_RTOL = 1e-4
# training losses and per-leaf gradients (relative L2) against the JAX
# package, or its float64 run where its float32 strays (the dense ladder's
# training-mode statistics, as in tests/test_torch_port_voxel_rcnn.py)
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-3
JAX_F32_LOSS_RTOL = 3e-3
JAX_F32_GRAD_REL_L2 = 2e-2
BOX_ATOL = 1e-3
# the crop alone: the same products, which XLA fuses into multiply-adds
# (1.5e-6 of scale measured)
CROP_RTOL = 1e-5
PREDICT_KEYS = ('rois', 'roi_scores', 'rcnn_iou_preds', 'roi_labels', 'roi_mask')


@pytest.fixture(scope='module')
def pair():
    # the ground truth 5 % of its length and 0.05 rad off its ROIs: raw ROI
    # IoUs of their own, which are the labels here
    return two_stage_pair('second_iou', shift=0.05)


def test_weights_round_trip(pair):
    check_weights_round_trip(pair, ['roi_head.shared_fc.Dense_0', 'roi_head.shared_fc.BatchNorm_0',
                                    'roi_head.iou_fc.Dense_1'])
    assert pair.net.pfe is None and pair.net.point_head is None


def test_rotated_bev_crop_matches_jax():
    """The crop alone on a random map and rotated ROIs, some reaching past
    the map's edges (the lower corner clipped into the map), and its value
    exact where the lattice points fall on cell centres."""
    from pdm_ssd_torch.models.roi_heads.second_head import rotated_bev_crop
    from pdm_ssd_tpu.models.roi_heads import second_head as j_head
    rng = np.random.RandomState(0)
    bev = rng.randn(2, 10, 12, 5).astype(np.float32)
    rois = np.concatenate([rng.uniform([-2, -10, -1], [20, 10, 1], (2, 7, 3)),
                           rng.uniform(0.5, 6, (2, 7, 3)), rng.uniform(-3, 3, (2, 7, 1))],
                          -1).astype(np.float32)
    args = (3, (0.0, -8.0, -3.0, 19.2, 8.0, 1.0), (0.2, 0.2, 0.1), 8.0)
    want = np.asarray(jax.jit(lambda b, r: j_head.rotated_bev_crop(b, r, *args))(bev, rois))
    got = rotated_bev_crop(torch.from_numpy(bev), torch.from_numpy(rois), *args).numpy()
    assert_close_to_scale(got, want, CROP_RTOL, 'crop')
    # a 1 x 1 lattice on the centre of cell (y 3, x 4) reads that cell
    one = np.array([[[0.0 + 4.5 * 1.6, -8.0 + 3.5 * 1.6, 0, 1, 1, 1, 0]]], np.float32)
    got = rotated_bev_crop(torch.from_numpy(bev[:1]), torch.from_numpy(one), 1, *args[1:])
    np.testing.assert_allclose(got[0, 0, 0, 0].numpy(), bev[0, 3, 4], rtol=1e-6)


def test_forward_matches_jax(pair):
    """The eval forward: the proposals and their mask exact, the crop's
    features through the IoU logit."""
    J = pair.jax_out
    with torch.no_grad():
        T = to_numpy(pair.net(pair.torch_inputs()))
    np.testing.assert_array_equal(T['roi_mask'], J['roi_mask'])
    np.testing.assert_array_equal(T['roi_labels'], J['roi_labels'])
    assert J['roi_mask'].sum() >= 8
    for k in ('spatial_features_2d', 'batch_box_preds', 'rois', 'roi_scores', 'rcnn_iou_preds'):
        assert_close_to_scale(T[k], J[k], FWD_RTOL, k)


def test_training_loss_and_gradients_match_jax(pair):
    """Targets by raw ROI IoU, the BCE IoU loss, every gradient (the crop
    passes none to the first stage)."""
    tb = check_training(pair, LOSS_RTOL, GRAD_REL_L2, JAX_F32_LOSS_RTOL, JAX_F32_GRAD_REL_L2,
                        roi_terms=('rcnn_loss_iou',))
    assert {'anchor_cls_loss', 'anchor_loc_loss', 'rcnn_loss_iou', 'loss'} <= set(tb)


@pytest.mark.parametrize('kind', ['BinaryCrossEntropy', 'L2', 'smoothL1'])
def test_iou_loss_kinds_match_jax(pair, kind):
    """Each IOU_LOSS on the same predictions and labels, labels of -1
    ignored, against the JAX head's `get_loss`."""
    from pdm_ssd_tpu.models.roi_heads.second_head import SECONDHead as JSECONDHead
    from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
    rng = np.random.RandomState(5)
    pred = rng.randn(2, 16, 1).astype(np.float32) * 2
    labels = rng.uniform(-0.3, 1, (2, 16)).astype(np.float32)
    labels[labels < 0] = -1
    head = pair.net.roi_head
    head.model_cfg.LOSS_CONFIG.IOU_LOSS = kind
    try:
        got, tb = head.get_loss({'rcnn_iou_preds': torch.from_numpy(pred)},
                                {'rcnn_cls_labels': torch.from_numpy(labels)})
    finally:
        head.model_cfg.LOSS_CONFIG.IOU_LOSS = 'BinaryCrossEntropy'
    roi_cfg = JCfgNode(pair.cfg.MODEL.ROI_HEAD.to_dict())
    roi_cfg.LOSS_CONFIG.IOU_LOSS = kind
    jhead = JSECONDHead(model_cfg=roi_cfg, num_class=3)
    want, _ = jhead.get_loss({'rcnn_iou_preds': pred}, {'rcnn_cls_labels': labels})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert set(tb) == {'rcnn_loss_iou'}


def test_predict_matches_jax(pair):
    """The IoU-rectified scores through one rotated NMS: the ROIs kept
    matched by box and label."""
    assert check_predict(pair, BOX_ATOL, PREDICT_KEYS) >= 4
