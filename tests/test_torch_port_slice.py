"""The port's flagship modules and slice against the JAX package, on the CPU.

One tiny flagship (`__graft_entry__._flagship(tiny=True)`, B=2, N=512) is
built in both packages with the same randomized weights. Each module test
feeds the port's module the JAX module's own inputs (taken from the JAX
forward), so a fault stays in the module that has it; the slice tests run
the whole path on both sides.
"""
import numpy as np
import pytest
import torch

from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_harness import FlagshipPair, to_numpy, to_torch

# a module fed the same inputs: float32 sums in another order only
MODULE_RTOL = 1e-4
# the whole forward: JAX extracts the grouped relative xyz and the narrow
# SA-1 payload in bf16 (pdm_ssd_tpu/ops/sa_fused.py:212, ~2^-9 relative),
# which the MLPs carry to every later output (measured ~2e-3 of the scale)
SLICE_RTOL = 1e-2


@pytest.fixture(scope='module')
def pair():
    return FlagshipPair(B=2, N=512, seed=0)


def assert_close_to_scale(got, want, rtol, name=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f'{name}: max |diff| {err:.3e} > {rtol} * {scale:.3e}'


def test_weights_cover_every_leaf(pair):
    """`from_flax` reached every tensor; BN epsilons are the JAX package's."""
    eps = {n: m.eps for n, m in pair.net.named_modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)}
    assert eps['backbone_2d.down0_bn0'] == 1e-3 and eps['backbone_2d.up1_bn'] == 1e-3
    assert eps['backbone_3d.sa_0.agg.bn0_0'] == 1e-5
    assert eps['point_head.cls_layers.BatchNorm_0'] == 1e-5
    assert eps['dense_head.shared_bn'] == 1e-5 and eps['dense_head.head.hm_bn0'] == 1e-5
    n_leaves = sum(np.asarray(v).size for tree in pair.variables.values()
                   for v in _leaves(tree))
    n_port = sum(t.numel() for k, t in pair.net.state_dict().items()
                 if not k.endswith('num_batches_tracked'))
    assert n_leaves == n_port


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_from_flax_rejects_unmatched_and_missing(pair):
    from pdm_ssd_torch.utils.weights import from_flax
    extra = {'params': {**pair.variables['params'], 'ghost': {'kernel': np.zeros((2, 2))}},
             'batch_stats': pair.variables['batch_stats']}
    with pytest.raises(KeyError, match='ghost'):
        from_flax(extra, pair.net)
    params = dict(pair.variables['params'])
    params.pop('pdm_neck')
    with pytest.raises(KeyError, match='pdm_neck.sh_proj.weight'):
        from_flax({'params': params, 'batch_stats': pair.variables['batch_stats']}, pair.net)


def test_pointnet2msg_matches_jax(pair):
    """FPS picks (hence sampled xyz) exact; features within bf16 budget."""
    J = pair.jax_out
    with torch.no_grad():
        out = to_numpy(pair.net.backbone_3d({'points': torch.from_numpy(pair.points)}))
    for k in range(4):
        np.testing.assert_array_equal(out['sa_xyz'][k], J['sa_xyz'][k])
    for k in range(1, 4):
        assert_close_to_scale(out['sa_features'][k], J['sa_features'][k], SLICE_RTOL,
                              f'sa_features[{k}]')


def test_sa_group_mlp_matches_jax_on_same_centers(pair):
    """Level 2 (pre-transformed wide payload) fed the JAX level-1 output."""
    J = pair.jax_out
    agg = pair.net.backbone_3d.sa_1.agg
    assert agg.pre_transform
    with torch.no_grad():
        got = agg(torch.from_numpy(J['sa_xyz'][1]), torch.from_numpy(J['sa_features'][1]),
                  torch.from_numpy(J['sa_xyz'][2])).numpy()
    assert_close_to_scale(got, J['sa_features'][2], SLICE_RTOL, 'sa_1')


def test_point_head_matches_jax(pair):
    J = pair.jax_out
    with torch.no_grad():
        out = pair.net.point_head({'point_features': torch.from_numpy(J['point_features'])})
    for k in ('point_cls_preds', 'point_box_preds', 'point_cls_scores'):
        assert_close_to_scale(out[k].numpy(), J[k], MODULE_RTOL, k)


def test_pdm_neck_matches_jax(pair):
    J = pair.jax_out
    with torch.no_grad():
        out = pair.net.pdm_neck({'sa_xyz': to_torch(J['sa_xyz']),
                                 'sa_features': [None] + to_torch(J['sa_features'][1:])})
    got = out['spatial_features'].numpy()
    assert (J['spatial_features'] != 0).sum() > 1000
    assert_close_to_scale(got, J['spatial_features'], MODULE_RTOL, 'spatial_features')


def test_base_bev_backbone_matches_jax(pair):
    J = pair.jax_out
    with torch.no_grad():
        out = pair.net.backbone_2d({'spatial_features': torch.from_numpy(J['spatial_features'])})
    assert_close_to_scale(out['spatial_features_2d'].contiguous().numpy(),
                          J['spatial_features_2d'], MODULE_RTOL, 'spatial_features_2d')


def test_center_head_matches_jax(pair):
    J = pair.jax_out
    with torch.no_grad():
        out = pair.net.dense_head(
            {'spatial_features_2d': torch.from_numpy(J['spatial_features_2d'])})
    preds = out['center_head_preds'][0]
    assert set(preds) == set(J['center_head_preds'][0])
    for k, want in J['center_head_preds'][0].items():
        assert_close_to_scale(preds[k].contiguous().numpy(), want, MODULE_RTOL, k)


def test_forward_matches_jax(pair):
    """The whole `__call__`, JAX vs port from the same points."""
    J = pair.jax_out
    with torch.no_grad():
        T = to_numpy(pair.net({'points': torch.from_numpy(pair.points)}))
    for k in ('point_cls_preds', 'point_box_preds', 'point_cls_scores', 'spatial_features',
              'spatial_features_2d'):
        assert_close_to_scale(T[k], J[k], SLICE_RTOL, k)
    for k, want in J['center_head_preds'][0].items():
        assert_close_to_scale(T['center_head_preds'][0][k], want, SLICE_RTOL, k)


def test_post_process_matches_jax_on_same_outputs(pair):
    """Both sides post-process the JAX forward outputs: the same boxes,
    scores, labels and mask."""
    J = {k: pair.jax_out[k] for k in ('point_coords', 'point_cls_scores', 'point_cls_preds',
                                      'point_box_preds', 'center_head_preds')}
    want = pair.jax_method(pair.jax_model.post_process, J)
    with torch.no_grad():
        got = to_numpy(pair.net.post_process(to_torch(J)))
    np.testing.assert_array_equal(got['pred_mask'], want['pred_mask'])
    np.testing.assert_array_equal(got['pred_labels'], want['pred_labels'])
    assert got['pred_mask'].sum() > 10
    np.testing.assert_allclose(got['pred_boxes'], want['pred_boxes'], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got['pred_scores'], want['pred_scores'], rtol=1e-6, atol=1e-6)


def test_predict_end_to_end(pair):
    """`predict` from points: fixed shapes, finite values, and the same
    detections as JAX's predict within the slice budget."""
    want = pair.jax_method(pair.jax_model.predict, {'points': pair.points})
    got = pair.net.predict({'points': torch.from_numpy(pair.points)})
    assert got['pred_boxes'].shape == (2, 32, 7)
    for k in ('pred_scores', 'pred_labels', 'pred_mask'):
        assert got[k].shape == (2, 32)
    assert torch.isfinite(got['pred_boxes']).all() and torch.isfinite(got['pred_scores']).all()
    got = to_numpy(got)
    np.testing.assert_array_equal(got['pred_mask'], want['pred_mask'])
    np.testing.assert_array_equal(got['pred_labels'], want['pred_labels'])
    assert_close_to_scale(got['pred_boxes'], want['pred_boxes'], SLICE_RTOL, 'pred_boxes')
    assert_close_to_scale(got['pred_scores'], want['pred_scores'], SLICE_RTOL, 'pred_scores')
