"""The PointRCNN serving path of the port against the JAX package, on the CPU.

The same numpy-seeded inputs go through the JAX function and its counterpart
in the port, both float32 (no bf16 on this path). Index outputs (ball query,
three-NN, ROI pooling) must agree exactly. Module tests feed the port's
module the JAX module's own inputs; the end-to-end tests run `predict` on
both sides.
"""
import warnings

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_ssd_tpu.models.backbones_3d import pointnet2_backbone as j_bb
from pdm_ssd_tpu.models.roi_heads import pointrcnn_head as j_head
from pdm_ssd_tpu.ops import coders as j_coders
from pdm_ssd_tpu.ops import pointnet2 as j_p2
from pdm_ssd_torch.models.backbones_3d import pointnet2_backbone as t_bb
from pdm_ssd_torch.models.roi_heads import pointrcnn_head as t_head
from pdm_ssd_torch.ops import coders as t_coders
from pdm_ssd_torch.ops import pointnet2 as t_p2
from pdm_ssd_torch.utils import synthetic
from pdm_ssd_torch.utils.config import CfgNode, cfg_from_yaml_file
from pdm_ssd_torch.utils.weights import from_flax
from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_harness import REPO, ModelPair, randomize_variables, to_numpy

POINTRCNN = 'configs/kitti_models/pointrcnn.yaml'
FLAGSHIP = 'configs/kitti_models/pdm_ssd_point.yaml'
# a module fed the same inputs, float32 on both sides: sums in another order
MODULE_RTOL = 1e-5
# the whole forward: the same, carried through three SA levels, the FP
# modules, two heads and the ROI stack
SLICE_RTOL = 1e-4


def assert_close_to_scale(got, want, rtol, name=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f'{name}: max |diff| {err:.3e} > {rtol} * {scale:.3e}'


def dense_cloud(rng, B, N, intensity=True):
    """Points dense enough that balls of radius about 1 hold several."""
    cols = [rng.uniform(0, 12, (B, N)), rng.uniform(-6, 6, (B, N)), rng.uniform(-2, 0, (B, N))]
    if intensity:
        cols.append(rng.rand(B, N))
    return np.stack(cols, -1).astype(np.float32)


# ---- plain ops -----------------------------------------------------------------

def _ball_query_case(kind):
    rng = np.random.RandomState(11)
    xyz = dense_cloud(rng, 2, 500, intensity=False)
    new_xyz = xyz[:, :90].copy()
    mask = None
    if kind == 'mask':
        mask = rng.rand(2, 500) < 0.6
    elif kind == 'empty':
        new_xyz[:, :7] += 50.0                       # centers far outside the cloud
    elif kind == 'duplicates':
        xyz[:, 250:400] = xyz[:, :150]               # every near point twice: exact ties
        new_xyz = np.round(new_xyz * 2.0) / 2.0
        xyz = np.round(xyz * 2.0) / 2.0              # distances land on the radius
    return xyz, new_xyz, mask


@pytest.mark.parametrize('kind', ['plain', 'mask', 'empty', 'duplicates'])
@pytest.mark.parametrize('radius,nsample', [(1.0, 8), (0.5, 16), (2.5, 5)])
def test_ball_query_matches_jax_exactly(kind, radius, nsample):
    """Indices equal slot for slot: first K in point order, first-hit
    backfill, zeros for an empty ball, masked points in no ball."""
    xyz, new_xyz, mask = _ball_query_case(kind)
    want = np.asarray(j_p2.ball_query(radius, nsample, jnp.asarray(xyz), jnp.asarray(new_xyz),
                                      None if mask is None else jnp.asarray(mask)))
    got = t_p2.ball_query(radius, nsample, torch.from_numpy(xyz), torch.from_numpy(new_xyz),
                          None if mask is None else torch.from_numpy(mask)).numpy()
    assert got.dtype == np.int32 and got.shape == (2, 90, nsample)
    np.testing.assert_array_equal(got, want)
    d2 = ((new_xyz[:, :, None].astype(np.float64) - xyz[:, None]) ** 2).sum(-1)
    hits = (d2 < radius * radius) & (True if mask is None else mask[:, None, :])
    n_hits = hits.sum(-1)
    if kind == 'empty':
        assert (n_hits[:, :7] == 0).all() and (got[:, :7] == 0).all()
    underfull = (n_hits > 0) & (n_hits < nsample)
    # the small radii leave balls underfull, the large one fills every ball
    assert underfull.any() if radius < 2 else (n_hits[:, 7:] >= nsample).all()
    b, m = np.nonzero(underfull)
    assert (got[b, m, -1] == got[b, m, 0]).all()     # the backfill repeats the first hit


def test_ball_query_chunks_do_not_change_the_result(monkeypatch):
    rng = np.random.RandomState(12)
    xyz = torch.from_numpy(dense_cloud(rng, 2, 300, intensity=False))
    whole = t_p2.ball_query(1.0, 8, xyz, xyz[:, :70])
    d_whole, i_whole = t_p2.three_nn(xyz, xyz[:, :70])
    monkeypatch.setattr(t_p2, 'CHUNK_ELEMS', 2 * 300 * 9)   # 9 centers a chunk
    assert torch.equal(t_p2.ball_query(1.0, 8, xyz, xyz[:, :70]), whole)
    d_part, i_part = t_p2.three_nn(xyz, xyz[:, :70])
    assert torch.equal(i_part, i_whole) and torch.equal(d_part, d_whole)


def test_query_and_group_matches_jax():
    rng = np.random.RandomState(13)
    pts = dense_cloud(rng, 2, 400)
    xyz, feats, new_xyz = pts[..., :3], pts[..., 3:], pts[:, :50, :3]
    for use_xyz in (True, False):
        want = np.asarray(j_p2.query_and_group(1.0, 8, jnp.asarray(xyz), jnp.asarray(new_xyz),
                                               jnp.asarray(feats), use_xyz=use_xyz))
        got = t_p2.query_and_group(1.0, 8, torch.from_numpy(xyz), torch.from_numpy(new_xyz),
                                   torch.from_numpy(feats), use_xyz=use_xyz).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        t_p2.query_and_group(1.0, 8, torch.from_numpy(xyz), torch.from_numpy(new_xyz), None,
                             use_xyz=False)


@pytest.mark.parametrize('kind', ['random', 'grid', 'masked'])
def test_three_nn_and_interpolate_match_jax(kind):
    """Indices exact (equal distances go to the lower index), squared
    distances to 1e-6 relative, interpolated features to 1e-6 of their scale."""
    rng = np.random.RandomState(14)
    unknown = dense_cloud(rng, 2, 300, intensity=False)
    known = dense_cloud(rng, 2, 60, intensity=False)
    mask = None
    if kind == 'grid':                               # many exactly equal distances
        unknown, known = np.round(unknown), np.round(known)
    elif kind == 'masked':
        mask = rng.rand(2, 60) < 0.7
    feats = rng.randn(2, 60, 7).astype(np.float32)
    j_d2, j_idx = j_p2.three_nn(jnp.asarray(unknown), jnp.asarray(known),
                                None if mask is None else jnp.asarray(mask))
    t_d2, t_idx = t_p2.three_nn(torch.from_numpy(unknown), torch.from_numpy(known),
                                None if mask is None else torch.from_numpy(mask))
    assert t_idx.dtype == torch.int32
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_d2.numpy(), np.asarray(j_d2), rtol=1e-6, atol=1e-12)
    j_w = j_p2.three_interpolate_weights(j_d2)
    t_w = t_p2.three_interpolate_weights(t_d2)
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), rtol=1e-5, atol=1e-7)
    want = np.asarray(j_p2.three_interpolate(jnp.asarray(feats), j_idx, j_w))
    got = t_p2.three_interpolate(torch.from_numpy(feats), t_idx, t_w).numpy()
    assert_close_to_scale(got, want, 1e-6, 'three_interpolate')
    with pytest.raises(ValueError, match='3 known'):
        t_p2.three_nn(torch.from_numpy(unknown), torch.from_numpy(known[:, :2]))


@pytest.mark.parametrize('sincos', [False, True])
def test_residual_coder_matches_jax(sincos):
    rng = np.random.RandomState(15)
    anchors = np.concatenate([rng.uniform(-5, 5, (4, 9, 3)), rng.uniform(0.5, 4, (4, 9, 3)),
                              rng.uniform(-3, 3, (4, 9, 1))], -1).astype(np.float32)
    boxes = (anchors + rng.normal(0, 0.3, anchors.shape)).astype(np.float32)
    boxes[..., 3:6] = np.abs(boxes[..., 3:6]) + 0.1
    j_coder = j_coders.ResidualCoder(encode_angle_by_sincos=sincos)
    t_coder = t_coders.build_box_coder('ResidualCoder', encode_angle_by_sincos=sincos)
    assert t_coder.full_code_size == j_coder.full_code_size == (8 if sincos else 7)
    enc = np.array(j_coder.encode(jnp.asarray(boxes), jnp.asarray(anchors)))
    np.testing.assert_allclose(
        t_coder.encode(torch.from_numpy(boxes), torch.from_numpy(anchors)).numpy(), enc,
        rtol=1e-5, atol=1e-6)
    dec = np.asarray(j_coder.decode(jnp.asarray(enc), jnp.asarray(anchors)))
    got = t_coder.decode(torch.from_numpy(enc), torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(got, dec, rtol=1e-5, atol=1e-6)
    if not sincos:
        np.testing.assert_allclose(got, boxes, rtol=1e-4, atol=1e-5)   # a round trip
    with pytest.raises(NotImplementedError):
        t_coders.build_box_coder('PreviousResidualDecoder')


def _rois_and_points(seed):
    rng = np.random.RandomState(seed)
    pts = dense_cloud(rng, 2, 600, intensity=False)
    rois = np.concatenate([rng.uniform([1, -5, -1.5], [11, 5, -0.5], (2, 12, 3)),
                           rng.uniform(1.0, 4.0, (2, 12, 3)),
                           rng.uniform(-np.pi, np.pi, (2, 12, 1))], -1).astype(np.float32)
    rois[:, 3, :3] = 90.0                            # an ROI that holds no point
    rois[:, 4, 3:6] = 0.3                            # a small one: fewer than K points
    roi_mask = np.ones((2, 12), bool)
    roi_mask[:, 7] = False
    return pts, rois, roi_mask


@pytest.mark.parametrize('masked', [False, True])
def test_pool_roi_points_ref_matches_jax_exactly(masked):
    pts, rois, roi_mask = _rois_and_points(16)
    m = roi_mask if masked else None
    for K, extra in ((16, [0.0, 0.0, 0.0]), (5, [0.4, 0.2, 1.0])):
        j_idx, j_empty = j_head.pool_roi_points_ref(
            jnp.asarray(pts), jnp.asarray(rois), K, extra,
            None if m is None else jnp.asarray(m))
        t_idx, t_empty = t_head.pool_roi_points_ref(
            torch.from_numpy(pts), torch.from_numpy(rois), K, extra,
            None if m is None else torch.from_numpy(m))
        assert t_idx.dtype == torch.int32
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(t_empty.numpy(), np.asarray(j_empty))
        assert t_empty[:, 3].all() and not t_empty[:, 0].any()
        assert bool(t_empty[:, 7].all()) == masked


@pytest.mark.parametrize('masked', [False, True])
def test_pool_roi_points_matches_jax_exactly(masked):
    pts, rois, roi_mask = _rois_and_points(17)
    m = roi_mask if masked else None
    for K, extra in ((16, 0.0), (5, 0.5)):
        j_idx, j_valid = j_head.pool_roi_points(
            jnp.asarray(pts), jnp.asarray(rois), K, extra,
            None if m is None else jnp.asarray(m))
        t_idx, t_valid = t_head.pool_roi_points(
            torch.from_numpy(pts), torch.from_numpy(rois), K, extra,
            None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
        assert not t_valid[:, 3].any() and t_valid[:, 0].any()


# ---- modules with the JAX module's weights ---------------------------------------

def _flax_variables(module: nn.Module, seed: int, *args):
    init = jax.jit(lambda *a: module.init({'params': jax.random.PRNGKey(seed)}, *a))
    return randomize_variables(init(*args), seed + 1, bias_scale=0.1)


@pytest.mark.parametrize('method', ['fps', 'prefix', 'random'])
@pytest.mark.parametrize('with_features,use_xyz', [(True, True), (True, False), (False, True)])
def test_sa_module_msg_matches_jax(method, with_features, use_xyz):
    rng = np.random.RandomState(18)
    pts = dense_cloud(rng, 2, 300)
    xyz = pts[..., :3]
    feats = np.concatenate([pts[..., 3:], rng.randn(2, 300, 4).astype(np.float32)], -1) \
        if with_features else None
    radii, nsamples, mlps = [1.0, 2.0], [6, 12], [[8, 12], [8, 16]]
    j_mod = j_bb.SAModuleMSG(npoint=40, radii=radii, nsamples=nsamples, mlps=mlps,
                             use_xyz=use_xyz, sample_method=method)
    j_feats = None if feats is None else jnp.asarray(feats)
    variables = _flax_variables(j_mod, 3, jnp.asarray(xyz), j_feats)
    j_xyz, j_out = jax.jit(lambda v, x, f: j_mod.apply(v, x, f))(variables, jnp.asarray(xyz),
                                                                  j_feats)
    t_mod = t_bb.SAModuleMSG(0 if feats is None else 5, 40, radii, nsamples, mlps,
                             use_xyz=use_xyz).eval()
    t_mod.load_state_dict(from_flax(variables, t_mod))
    with torch.no_grad():
        t_xyz, t_out = t_mod(torch.from_numpy(xyz),
                             None if feats is None else torch.from_numpy(feats), method)
    np.testing.assert_array_equal(t_xyz.numpy(), np.asarray(j_xyz))
    assert t_out.shape == (2, 40, 28)
    assert_close_to_scale(t_out.numpy(), np.asarray(j_out), MODULE_RTOL, 'SAModuleMSG')


@pytest.mark.parametrize('with_unknown_feats', [True, False])
def test_fp_module_matches_jax(with_unknown_feats):
    rng = np.random.RandomState(19)
    unknown = dense_cloud(rng, 2, 200, intensity=False)
    known = dense_cloud(rng, 2, 50, intensity=False)
    u_feats = rng.randn(2, 200, 5).astype(np.float32) if with_unknown_feats else None
    k_feats = rng.randn(2, 50, 9).astype(np.float32)
    j_mod = j_bb.FPModule(mlp=[16, 12])
    j_args = (jnp.asarray(unknown), jnp.asarray(known),
              None if u_feats is None else jnp.asarray(u_feats), jnp.asarray(k_feats))
    variables = _flax_variables(j_mod, 4, *j_args)
    want = np.asarray(jax.jit(lambda v, *a: j_mod.apply(v, *a))(variables, *j_args))
    t_mod = t_bb.FPModule(9 + (5 if with_unknown_feats else 0), [16, 12]).eval()
    t_mod.load_state_dict(from_flax(variables, t_mod))
    with torch.no_grad():
        got = t_mod(torch.from_numpy(unknown), torch.from_numpy(known),
                    None if u_feats is None else torch.from_numpy(u_feats),
                    torch.from_numpy(k_feats)).numpy()
    assert_close_to_scale(got, want, MODULE_RTOL, 'FPModule')


# ---- PointRCNN in both packages --------------------------------------------------

def _pointrcnn_cfg(variant: str):
    import os
    cwd = os.getcwd()
    os.chdir(REPO)   # the config names its base config relative to the repo
    try:
        cfg = cfg_from_yaml_file(POINTRCNN, CfgNode())
    finally:
        os.chdir(cwd)
    if variant != 'shipped':
        synthetic.pointrcnn_fp3(cfg)
    synthetic.tiny_pointrcnn_cfg(cfg)
    if variant == 'lite':                            # the head without its SA stack
        roi = cfg.MODEL.ROI_HEAD
        del roi['SA_CONFIG']
        roi['NUM_SAMPLED_POINTS'] = 24
        roi['ROI_POINT_EXTRA'] = 0.3
        roi['SHARED_FC'] = [16, 16]
    return cfg


@pytest.fixture(scope='module', params=['fp3', 'shipped', 'lite'])
def rcnn(request):
    points = dense_cloud(np.random.RandomState(20), 2, 384)
    pair = ModelPair(_pointrcnn_cfg(request.param), B=2, N=384, seed=0, points=points,
                     bias_scale=0.1)
    pair.variant = request.param
    return pair


def test_pointrcnn_weights_load_leaf_for_leaf(rcnn):
    """`from_flax` raised on no unmatched and no missing leaf when the pair
    was built. The file as shipped (three SA levels, two FP_MLPS) hands the
    heads the raw 1-channel input features, in both packages; with the FP
    list made whole they read the FP output."""
    state = rcnn.net.state_dict()
    width = 1 if rcnn.variant == 'shipped' else 12
    assert rcnn.net.backbone_3d.num_point_features == width
    assert rcnn.jax_out['point_features'].shape == (2, 384, width)
    assert state['point_head.cls_layers.Dense_0.weight'].shape == (16, width)
    n_fp = 2 if rcnn.variant == 'shipped' else 3
    assert sum(k.startswith('backbone_3d.fp_') and k.endswith('Dense_0.weight')
               for k in state) == n_fp
    if rcnn.variant == 'lite':
        assert state['roi_head.up_mlp.Dense_0.weight'].shape == (16, 5 + width)
    else:
        assert state['roi_head.merge_down_0.weight'].shape == (8, 8 + width)
        assert 'roi_head.xyz_up_0.bias' in state and 'roi_head.sa_2_mlp_0.Dense_0.weight' in state
    n_leaves = sum(np.asarray(v).size for tree in rcnn.variables.values()
                   for v in jax.tree_util.tree_leaves(tree))
    assert n_leaves == sum(t.numel() for k, t in state.items()
                           if not k.endswith('num_batches_tracked'))


def test_pointrcnn_head_matches_jax_on_the_jax_inputs(rcnn):
    """The ROI head alone (both architectures), fed the JAX first stage's
    outputs: proposals and pooled indices equal, predictions to 1e-5."""
    keys = ('point_coords', 'point_features', 'point_cls_scores', 'batch_cls_preds',
            'batch_box_preds')
    batch = {k: torch.from_numpy(rcnn.jax_out[k]) for k in keys}
    with torch.no_grad():
        out = rcnn.net.roi_head(batch)
    np.testing.assert_array_equal(out['roi_mask'].numpy(), rcnn.jax_out['roi_mask'])
    np.testing.assert_array_equal(out['roi_labels'].numpy(), rcnn.jax_out['roi_labels'])
    np.testing.assert_array_equal(out['rois'].numpy(), rcnn.jax_out['rois'])
    assert rcnn.jax_out['roi_mask'].sum() >= 8
    for k in ('rcnn_cls_preds', 'rcnn_reg_preds'):
        assert_close_to_scale(out[k].numpy(), rcnn.jax_out[k], MODULE_RTOL, k)


def test_pointrcnn_forward_matches_jax(rcnn):
    with torch.no_grad():
        out = rcnn.net({'points': torch.from_numpy(rcnn.points)})
    for lvl, (g, w) in enumerate(zip(out['sa_xyz'], rcnn.jax_out['sa_xyz'])):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f'sa_xyz[{lvl}]')
    for lvl, (g, w) in enumerate(zip(out['sa_features'], rcnn.jax_out['sa_features'])):
        assert_close_to_scale(g.numpy(), w, SLICE_RTOL, f'sa_features[{lvl}]')
    np.testing.assert_array_equal(out['roi_mask'].numpy(), rcnn.jax_out['roi_mask'])
    for k in ('point_features', 'point_cls_preds', 'point_box_preds', 'batch_box_preds', 'rois',
              'roi_scores', 'rcnn_cls_preds', 'rcnn_reg_preds'):
        assert_close_to_scale(out[k].numpy(), rcnn.jax_out[k], SLICE_RTOL, k)


def test_pointrcnn_predict_keeps_the_same_boxes(rcnn):
    """`predict` end to end: the same number of kept boxes, and every kept
    box of one package has its twin in the other (matched by box, since
    near-tied scores may order them differently): centers, sizes and heading
    within 1e-3, score within 1e-4, the same label."""
    fn = jax.jit(lambda v, p: rcnn.jax_model.apply(v, {'points': p},
                                                   method=rcnn.jax_model.predict))
    want = to_numpy(fn(rcnn.variables, rcnn.points))
    got = to_numpy(rcnn.net.predict({'points': torch.from_numpy(rcnn.points)}))
    assert got['pred_boxes'].shape == want['pred_boxes'].shape == (2, 16, 7)
    np.testing.assert_array_equal(got['pred_mask'].sum(-1), want['pred_mask'].sum(-1))
    assert want['pred_mask'].sum() >= 6
    for b in range(2):
        gb, wb = got['pred_boxes'][b][got['pred_mask'][b]], want['pred_boxes'][b][want['pred_mask'][b]]
        dist = np.abs(gb[:, None, :] - wb[None, :, :]).max(-1)
        twin = dist.argmin(1)
        assert sorted(twin) == list(range(len(wb)))
        assert dist.min(1).max() <= 1e-3
        np.testing.assert_allclose(got['pred_scores'][b][got['pred_mask'][b]],
                                   want['pred_scores'][b][want['pred_mask'][b]][twin], atol=1e-4)
        np.testing.assert_array_equal(got['pred_labels'][b][got['pred_mask'][b]],
                                      want['pred_labels'][b][want['pred_mask'][b]][twin])


# ---- the flagship through the non-fused SA ---------------------------------------

def test_flagship_with_fused_off_matches_jax(monkeypatch):
    """One more config through `SAModuleMSG`: the tiny flagship with
    `SA_CONFIG.FUSED: False`. Without the fused path's bf16 extraction on the
    JAX side the two forwards differ by float32 rounding only."""
    monkeypatch.chdir(REPO)
    cfg = synthetic.tiny_flagship_cfg(cfg_from_yaml_file(FLAGSHIP, CfgNode()))
    cfg.MODEL.BACKBONE_3D.SA_CONFIG.FUSED = False
    points = dense_cloud(np.random.RandomState(21), 2, 400)
    points[..., 0] *= 5.0                            # spread over more of the BEV grid
    points[..., 1] *= 5.0
    pair = ModelPair(cfg, B=2, N=400, seed=0, points=points)
    assert isinstance(pair.net.backbone_3d.sa_0, t_bb.SAModuleMSG)
    with torch.no_grad():
        out = pair.net({'points': torch.from_numpy(pair.points)})
    for k in ('point_features', 'point_cls_preds', 'point_box_preds', 'spatial_features_2d'):
        assert_close_to_scale(out[k].numpy(), pair.jax_out[k], SLICE_RTOL, k)


# ---- the sampler logic of the backbone ---------------------------------------------

def _backbone(methods, npoints, fp=()):
    cfg = CfgNode({'SA_CONFIG': {
        'NPOINTS': npoints, 'SAMPLE_METHOD': methods,
        'RADIUS': [[1.0, 2.0]] * len(npoints), 'NSAMPLE': [[4, 6]] * len(npoints),
        'MLPS': [[[8], [8]]] * len(npoints)}, 'FP_MLPS': [list(m) for m in fp]})
    return t_bb.PointNet2MSG(cfg, 4, pc_range=None).eval()


def test_random_sampling_with_a_generator_is_one_permutation_prefix():
    """'random' with a generator cannot equal `jax.random.permutation`; it is
    held to what both promise: a prefix of one permutation of the points, the
    same for every cloud of the batch, another one for another seed."""
    pts = torch.from_numpy(dense_cloud(np.random.RandomState(22), 3, 200))
    net = _backbone(['random'], [50])
    with torch.no_grad():
        new_xyz = net({'points': pts}, torch.Generator().manual_seed(5))['point_coords']
        again = net({'points': pts}, torch.Generator().manual_seed(5))['point_coords']
        other = net({'points': pts}, torch.Generator().manual_seed(6))['point_coords']
        plain = net({'points': pts})['point_coords']
    assert torch.equal(new_xyz, again) and not torch.equal(new_xyz, other)
    assert torch.equal(plain, pts[:, :50, :3])       # no generator: the prefix
    picks = [[int((pts[b, :, :3] == new_xyz[b, i]).all(-1).nonzero()[0, 0]) for i in range(50)]
             for b in range(3)]
    assert picks[0] == picks[1] == picks[2]
    assert len(set(picks[0])) == 50 and picks[0] != list(range(50))


def test_sampler_substitutions_warning_and_errors():
    pts = torch.from_numpy(dense_cloud(np.random.RandomState(23), 2, 200))
    calls = []
    real = t_bb.dispatch.farthest_point_sample

    def counting(xyz, npoint):
        calls.append((xyz.shape[1], npoint))
        return real(xyz, npoint)

    t_bb.dispatch.farthest_point_sample = counting
    try:
        with torch.no_grad(), warnings.catch_warnings():
            warnings.simplefilter('error')
            # levels 2 and 3 read FPS-ordered input: FPS there is its prefix
            _backbone(['random', 'fps', 'fps', 'fps'], [120, 60, 30, 30])({'points': pts})
            assert calls == [(120, 60)]
            # npoint above the level's input: real FPS runs and repeats picks
            calls.clear()
            out = _backbone(['fps', 'fps'], [40, 50])({'points': pts})
            assert calls == [(200, 40), (40, 50)] and out['point_coords'].shape == (2, 50, 3)
        with torch.no_grad(), pytest.warns(UserWarning, match='FPS-ordered'):
            out = _backbone(['fps', 'random'], [60, 20])({'points': pts})
        assert torch.equal(out['point_coords'], out['sa_xyz'][1][:, :20])
        with torch.no_grad(), warnings.catch_warnings():
            warnings.simplefilter('error')           # with a generator: no warning
            _backbone(['fps', 'random'], [60, 20])({'points': pts},
                                                   torch.Generator().manual_seed(0))
    finally:
        t_bb.dispatch.farthest_point_sample = real
    with pytest.raises(ValueError, match="'random' with NPOINTS=300"):
        _backbone(['random'], [300])({'points': pts})
    with pytest.raises(ValueError, match='unknown SAMPLE_METHOD'):
        _backbone(['voxel'], [30])({'points': pts})
    with pytest.raises(ValueError, match='FP_MLPS'):
        _backbone(['fps'], [30], fp=[[8], [8]])


def test_random_level_with_a_generator_keeps_the_fps_order_as_the_jax_package(monkeypatch):
    """Pins a latent behaviour copied from the JAX package (ROADMAP Queue 3,
    `pdm_ssd_tpu/models/backbones_3d/pointnet2_backbone.py:303-304`): after an
    'fps' level, a 'random' level drawn with a generator (in JAX, with a
    'sampling' rng) leaves its output marked FPS-ordered, so a following
    'fps' level takes the 'prefix' of the random subset and runs no FPS. The
    JAX side draws the port's permutation here, so both packages take the
    same subset: every level's centers agree exactly, the features within
    MODULE_RTOL."""
    pts = dense_cloud(np.random.RandomState(25), 2, 200)
    npoints = [80, 40, 20]
    cfg = CfgNode({'SA_CONFIG': {
        'NPOINTS': npoints, 'SAMPLE_METHOD': ['fps', 'random', 'fps'],
        'RADIUS': [[1.0, 2.0]] * 3, 'NSAMPLE': [[4, 6]] * 3, 'MLPS': [[[8], [8]]] * 3},
        'FP_MLPS': []})
    perm = torch.randperm(npoints[0], generator=torch.Generator().manual_seed(3))
    monkeypatch.setattr(jax.random, 'permutation', lambda key, n: jnp.asarray(perm.numpy()))
    j_net = j_bb.PointNet2MSG(model_cfg=cfg, input_channels=4)
    j_batch = {'points': jnp.asarray(pts)}
    # the JAX side jitted (the patched permutation a constant of the program):
    # one program a call instead of one an op
    variables = randomize_variables(jax.jit(lambda b: j_net.init(
        {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1)}, b))(j_batch),
        1, bias_scale=0.1)
    j_out = jax.jit(lambda v, b: j_net.apply(v, b, rngs={'sampling': jax.random.PRNGKey(2)}))(
        variables, j_batch)
    t_net = t_bb.PointNet2MSG(cfg, 4, pc_range=None).eval()
    t_net.load_state_dict(from_flax(variables, t_net))
    calls = []
    real = t_bb.dispatch.farthest_point_sample

    def counting(xyz, npoint):
        calls.append((xyz.shape[1], npoint))
        return real(xyz, npoint)

    monkeypatch.setattr(t_bb.dispatch, 'farthest_point_sample', counting)
    with torch.no_grad(), warnings.catch_warnings():
        warnings.simplefilter('error')               # a generator: no degeneracy warning
        t_out = t_net({'points': torch.from_numpy(pts)}, torch.Generator().manual_seed(3))
    assert calls == [(200, 80)]                      # level 2 ran no FPS
    t_xyz, j_xyz = t_out['sa_xyz'], [np.asarray(x) for x in j_out['sa_xyz']]
    assert torch.equal(t_xyz[2], t_xyz[1][:, perm[:40]])          # the random subset
    assert torch.equal(t_xyz[3], t_xyz[2][:, :20])                # 'fps' became 'prefix'
    np.testing.assert_array_equal(j_xyz[3], j_xyz[2][:, :20])
    for k in range(4):
        np.testing.assert_array_equal(t_xyz[k].numpy(), j_xyz[k])
    for k in range(1, 4):
        assert_close_to_scale(t_out['sa_features'][k].numpy(), np.asarray(j_out['sa_features'][k]),
                              MODULE_RTOL, f'sa_features[{k}]')


def test_num_point_features_is_the_width_of_the_returned_level():
    pts = torch.from_numpy(dense_cloud(np.random.RandomState(24), 2, 200))
    for fp, width in (((), 16), ([[12], [10]], 12), ([[10]], 1)):
        net = _backbone(['fps', 'fps'], [60, 20], fp=fp)
        with torch.no_grad():
            out = net({'points': pts})
        assert net.num_point_features == width == out['point_features'].shape[-1]
        n_pts = 200 if fp else 20
        assert out['point_coords'].shape == (2, n_pts, 3)


def test_dryrun_serves_pointrcnn_on_the_cpu(capsys):
    """The dry run serves the tiny PointRCNN, and trains it since its
    training path is ported: a finite loss, then predict."""
    from pdm_ssd_torch.tools.dryrun import dryrun
    assert np.isfinite(dryrun('cpu', cfg_file=POINTRCNN))
    assert 'PointRCNN train step + predict OK' in capsys.readouterr().out
