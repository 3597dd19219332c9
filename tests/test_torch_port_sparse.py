"""SECOND's serving path on the sparse voxel ladder: the port against the JAX
package, on the CPU.

The same numpy-seeded inputs go through the JAX function and its counterpart
in the port. Integer outputs (the voxelizer's cells, every kernel map) must
agree exactly. The JAX model never reaches a Pallas kernel on this path; the
microbench kernels' own oracles (`xla27`, `xla_gather_same_shape`) are plain
jnp one-liners and are written out here, since the microbench files run
their benchmark when imported. The port uses the plain versions of its
kernels here; the kernels themselves are held on the card (`gpu` tests in
`test_torch_port_guards.py`, `chip_smoke.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_ssd_tpu.datasets.processor.data_processor import DataProcessor
from pdm_ssd_tpu.models import get_host_prepare as j_get_host_prepare
from pdm_ssd_tpu.models.backbones_3d import sparse_backbone as j_sb
from pdm_ssd_tpu.models.backbones_3d.vfe import MeanVFE as JMeanVFE
from pdm_ssd_tpu.models.dense_heads import anchor_head as j_ah
from pdm_ssd_tpu.ops import sparse_maps as j_maps
from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
from pdm_ssd_torch.models import build_network, get_host_prepare
from pdm_ssd_torch.models.backbones_3d import sparse_backbone as t_sb
from pdm_ssd_torch.models.backbones_3d.vfe import MeanVFE
from pdm_ssd_torch.models.dense_heads import anchor_head as t_ah
from pdm_ssd_torch.ops import dispatch
from pdm_ssd_torch.ops import sparse_conv as t_sc
from pdm_ssd_torch.ops import sparse_maps as t_maps
from pdm_ssd_torch.ops import voxelize as t_vox
from pdm_ssd_torch.utils import synthetic
from pdm_ssd_torch.utils.config import cfg_from_yaml_file
from pdm_ssd_torch.utils.weights import from_flax
from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_harness import REPO, ModelPair, randomize_variables, to_numpy

SECOND = 'configs/kitti_models/second_sparse.yaml'
# a module fed the same inputs, float32 on both sides: sums in another order
MODULE_RTOL = 1e-5
# the ladder's twelve layers, the BEV convs and the head, float32 on both sides
SLICE_RTOL = 1e-4
# the file as shipped: the JAX ladder gathers, multiplies and normalises in
# bf16 (`TABLE_DTYPE: bf16`, 8 bits of mantissa through 12 layers), the port in
# float32. Measured on the tiny config (this file's seed): 3.9e-3 of
# `spatial_features`' scale, 7.4e-4 of a head output's
BF16_TABLE_RTOL = 3e-2


def assert_close_to_scale(got, want, rtol, name=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f'{name}: max |diff| {err:.3e} > {rtol} * {scale:.3e}'


def tiny_cfg(residual=False, strip_table_dtype=True):
    cfg = cfg_from_yaml_file(SECOND)
    synthetic.tiny_second_cfg(cfg)
    if strip_table_dtype:
        cfg.MODEL.BACKBONE_3D.pop('TABLE_DTYPE')
    if residual:
        cfg.MODEL.BACKBONE_3D.NAME = 'SparseVoxelResBackBone8x'
    return cfg


@pytest.fixture(autouse=True)
def _repo_cwd(monkeypatch):
    monkeypatch.chdir(REPO)   # the config names its base config relative to the repo


# ---- voxelizer -------------------------------------------------------------------

@pytest.mark.parametrize('kind', ['sparse', 'crowded cells', 'more cells than slots'])
def test_voxelize_matches_the_numpy_voxelizer(kind):
    """Cells, their order, the points kept per cell and their order, equal to
    `_numpy_voxelize`; points outside the range are dropped."""
    rng = np.random.RandomState(3)
    pc_range, vs = [0, -16, -3, 32, 16, 1], [0.5, 0.5, 0.16666667]
    N, max_pts, max_vox = {'sparse': (300, 5, 256), 'crowded cells': (900, 3, 512),
                           'more cells than slots': (700, 5, 128)}[kind]
    pts = np.stack([rng.uniform(-2, 34, N), rng.uniform(-18, 18, N), rng.uniform(-3.5, 1.5, N),
                    rng.rand(N)], -1).astype(np.float32)
    if kind == 'crowded cells':
        pts[:600, :3] = pts[:600, :3] * 0.05 + [10.0, 0.0, -1.0]
    proc = DataProcessor([], pc_range, training=False, num_point_features=4)
    proc._set_grid(vs)
    voxels, coords, fill = proc._numpy_voxelize(pts, np.asarray(vs, np.float32), max_pts, max_vox)
    assert (fill == max_pts).sum() > 5 or kind != 'crowded cells'
    got = t_vox.voxelize_batch(torch.from_numpy(pts)[None], pc_range, vs, max_pts, max_vox)
    n = len(voxels)
    assert n == max_vox or kind != 'more cells than slots'
    assert int(got['voxel_mask'][0].sum()) == n and bool(got['voxel_mask'][0, :n].all())
    np.testing.assert_array_equal(got['voxel_coords'][0, :n].numpy(), coords)
    np.testing.assert_array_equal(got['voxel_num_points'][0, :n].numpy(), fill)
    np.testing.assert_array_equal(got['voxels'][0, :n].numpy(), voxels)
    assert not got['voxels'][0, n:].any() and not got['voxel_coords'][0, n:].any()
    assert got['voxel_coords'].dtype == torch.int32 and got['voxels'].shape[1:] == (max_vox, max_pts, 4)


# ---- kernel maps -----------------------------------------------------------------

def _actives(kind, rng, grid, V, B=2):
    """(coords (B, V, 3) int32 zyx, mask (B, V)) of seeded active cells."""
    W, H, D = grid
    n = {'random': 200, 'clustered': 230, 'overflow': 250, 'empty cloud': 180,
         'shuffled': 200}[kind]
    coords, mask = np.zeros((B, V, 3), np.int32), np.zeros((B, V), bool)
    for b in range(B):
        nb = 0 if (kind == 'empty cloud' and b == 0) else n - 9 * b
        if kind == 'clustered':
            base = rng.randint(0, [D + 1 - 3, H - 6, W - 6], (nb // 15 + 1, 3))
            c = (base[:, None] + rng.randint(0, [3, 6, 6], (1, 40, 3))).reshape(-1, 3)
            flat = np.unique((c[:, 0] * H + c[:, 1]) * W + c[:, 2])[:nb]
        else:
            flat = np.sort(rng.choice((D + 1) * H * W, nb, replace=False))
        c = np.stack([flat // (H * W), (flat // W) % H, flat % W], -1)
        if kind == 'shuffled':
            c = c[rng.permutation(len(c))]
        coords[b, :len(c)], mask[b, :len(c)] = c, True
    return coords, mask


@pytest.mark.parametrize('kind', ['random', 'clustered', 'overflow', 'empty cloud', 'shuffled'])
def test_ladder_maps_equal_the_jax_package(kind):
    """Every LADDER_KEYS array, integer for integer: slot order, the absent
    slot, the truncation of a stage that overflows its cap, `sp_perm1`."""
    grid, V = (64, 64, 24), 256
    caps = [V, 100, 60, 128, 20] if kind == 'overflow' else [V, 1024, 512, 128, 128]
    coords, mask = _actives(kind, np.random.RandomState(5), grid, V)
    want = j_maps.batch_build_backbone8x(coords, mask, grid, caps)
    got = t_maps.batch_build_backbone8x(torch.from_numpy(coords), torch.from_numpy(mask), grid, caps)
    assert list(t_maps.LADDER_KEYS) == list(j_maps.LADDER_KEYS)
    for k in j_maps.LADDER_KEYS:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    sites = got['sp_sites'].numpy()
    np.testing.assert_array_equal(sites[:, 0], mask.sum(1))
    kept = np.stack([np.asarray(want[k]).sum(1) for k in
                     ('sp_mask1', 'sp_mask2', 'sp_mask3', 'sp_mask4', 'sp_mask_out')], 1)
    np.testing.assert_array_equal(np.minimum(sites, caps), kept)
    if kind == 'overflow':
        assert (sites[:, 1] > caps[1]).all() and (sites[:, 2] > caps[2]).all()
    if kind == 'shuffled':
        np.testing.assert_array_equal(
            np.take_along_axis(coords, got['sp_perm1'].numpy()[..., None].astype(np.int64), 1)[mask],
            got['sp_coords1'].numpy()[mask])


def test_ladder_shapes_and_default_caps_equal_the_jax_package():
    for grid in ((1408, 1600, 40), (64, 64, 24), (7, 6, 4)):
        assert t_maps.ladder_shapes(grid) == j_maps.ladder_shapes(grid)
    dims = t_maps.ladder_shapes((1408, 1600, 40))
    assert [d[0] for d in dims] == [41, 21, 11, 5, 2] and dims[4][1:] == (200, 176)
    assert t_maps.default_caps(40000) == j_maps.default_caps(40000)
    assert t_maps._DOWN_SPECS == j_maps._DOWN_SPECS


def test_get_host_prepare_honours_caps_and_leaves_a_prepared_batch_alone():
    cfg = tiny_cfg()
    cfg.MODEL.BACKBONE_3D.ACTIVE_CAPS = [999, 300, 200, 100, 90]
    raw = synthetic.voxel_batch(2, 500, cfg, seed=2)
    prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG)
    got = prepare(raw)
    jcfg = JCfgNode(cfg.to_dict())
    want = j_get_host_prepare(jcfg.MODEL, jcfg.DATA_CONFIG)({k: v.numpy() for k, v in raw.items()})
    assert got['sp_submap1'].shape == (2, 256, 27) and got['sp_submap2'].shape == (2, 300, 27)
    assert got['sp_outmap'].shape == (2, 90, 3)
    for k in t_maps.LADDER_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert prepare(got) is got
    assert 'sp_submap1' not in raw
    net = build_network(cfg.MODEL, 3, cfg.DATA_CONFIG, device='cpu')
    with pytest.raises(KeyError, match='get_host_prepare'):
        net.predict(raw)                      # an unprepared batch says what it lacks
    flagship = cfg_from_yaml_file('configs/kitti_models/pdm_ssd_point.yaml')
    assert get_host_prepare(flagship.MODEL, flagship.DATA_CONFIG) is None


# ---- the sparse conv and the row gather ----------------------------------------------

def make_maps(rng, V, K):
    """The microbench's neighbour maps (`tools/microbench_sparse_gather.py`,
    `make_maps`) at a small V: idx[v, k] near v, about 10% absent, and one
    row with every tap absent."""
    base = np.arange(V)[:, None]
    goff = rng.integers(-40, 40, size=(1, K))
    noise = rng.integers(-8, 8, size=(V, K))
    idx = np.clip(base + goff + noise, 0, V - 1)
    idx[rng.random((V, K)) < 0.10] = V
    idx[V // 3] = V
    return idx.astype(np.int32)


@pytest.mark.parametrize('K', [27, 3])
@pytest.mark.parametrize('Cin', [4, 64])
def test_sparse_conv_plain_matches_gather_taps_and_dot(K, Cin):
    """Against the model's `gather_taps` + `dot_general` and against the
    microbench's oracle `xla27` (`table[idx].reshape(V, K*C) @ W` with a zero
    row at V), which are the same function."""
    rng = np.random.default_rng(0)
    B, V, Cout = 2, 500, 24
    feats = rng.standard_normal((B, V, Cin)).astype(np.float32)
    nbr = np.stack([make_maps(rng, V, K) for _ in range(B)])
    w = (rng.standard_normal((K * Cin, Cout)) * 0.05).astype(np.float32)
    g = j_sb.gather_taps(jnp.asarray(feats), jnp.asarray(nbr))
    want = np.asarray(jax.lax.dot_general(g, jnp.asarray(w), (((2,), (0,)), ((), ()))))
    got = dispatch.sparse_conv(torch.from_numpy(feats), torch.from_numpy(nbr), torch.from_numpy(w))
    assert_close_to_scale(got.numpy(), want, MODULE_RTOL)
    np.testing.assert_array_equal(
        t_sc.gather_taps(torch.from_numpy(feats), torch.from_numpy(nbr)).numpy(), np.asarray(g))
    table = jnp.concatenate([jnp.asarray(feats[0]), jnp.zeros((1, Cin))])
    xla27 = np.asarray(table[jnp.asarray(nbr[0])].reshape(V, K * Cin) @ jnp.asarray(w))
    assert_close_to_scale(got[0].numpy(), xla27, MODULE_RTOL)
    assert not got[:, V // 3].any()                    # every tap absent: exactly 0
    t_sc.PLAIN_CHUNK_ROWS, keep = 64, t_sc.PLAIN_CHUNK_ROWS
    try:                                               # the chunked walk changes nothing
        small = dispatch.sparse_conv(torch.from_numpy(feats), torch.from_numpy(nbr),
                                     torch.from_numpy(w))
    finally:
        t_sc.PLAIN_CHUNK_ROWS = keep
    assert_close_to_scale(small.numpy(), got.numpy(), 1e-6)


@pytest.mark.parametrize('kind', ['submanifold', 'strided'])
def test_sparse_conv_plain_matches_dense_conv3d(kind):
    """A sparse conv over the port's maps equals the dense 3D convolution of
    the zero-filled volume, sampled at the active output sites."""
    rng = np.random.RandomState(7)
    dims, n, cap_in, cap_out, Cin, Cout = (6, 10, 12), 43, 64, 256, 5, 7
    flat = np.sort(rng.choice(np.prod(dims), n, replace=False))
    c = np.stack([flat // (dims[1] * dims[2]), (flat // dims[2]) % dims[1], flat % dims[2]], -1)
    coords = torch.zeros((cap_in, 3), dtype=torch.int32)
    coords[:n] = torch.from_numpy(c).int()
    feats = torch.zeros((cap_in, Cin))
    feats[:n] = torch.from_numpy(rng.randn(n, Cin).astype(np.float32))
    w = torch.from_numpy(rng.randn(27 * Cin, Cout).astype(np.float32))
    if kind == 'submanifold':
        stride, pad = (1, 1, 1), (1, 1, 1)
        nbr, co, n_out = t_maps._subm_map(coords, n, dims, (3, 3, 3)), coords, n
    else:
        stride, pad = (2, 2, 2), (1, 1, 1)
        co, n_out, _, _ = t_maps._down_sites(coords, n, dims, (3, 3, 3), stride, pad, cap_out)
        nbr = t_maps._down_map(coords, n, dims, co, n_out, (3, 3, 3), stride, pad)
    got = t_sc.sparse_conv_plain(feats[None], nbr[None], w)[0]
    vol = torch.zeros((1, Cin) + dims)
    vol[0, :, c[:, 0], c[:, 1], c[:, 2]] = feats[:n].T
    wd = w.reshape(3, 3, 3, Cin, Cout).permute(4, 3, 0, 1, 2)
    dense = torch.nn.functional.conv3d(vol, wd, stride=stride, padding=pad)[0]
    o = co[:n_out].long()
    torch.testing.assert_close(got[:n_out], dense[:, o[:, 0], o[:, 1], o[:, 2]].T,
                               rtol=1e-4, atol=1e-4)
    assert not got[n_out:].any()
    if kind == 'strided':                              # nothing off the active set
        on = torch.zeros(dense.shape[1:], dtype=torch.bool)
        on[o[:, 0], o[:, 1], o[:, 2]] = True
        assert float(dense[:, ~on].abs().max()) < 1e-5


def test_gather_rows_plain_bf16_matches_the_same_shape_gather():
    """`table[idx1]` in bf16 with repeated indices, the microbench's oracle
    `xla_gather_same_shape`: exact."""
    rng = np.random.default_rng(0)
    table = jnp.asarray(rng.standard_normal((520, 96)), jnp.bfloat16)
    idx1 = rng.integers(0, 520, size=(520,)).astype(np.int32)
    want = np.asarray(table[jnp.asarray(idx1)].astype(jnp.float32))
    t = torch.from_numpy(np.array(table.astype(jnp.float32))).to(torch.bfloat16)
    got = dispatch.gather_rows(t[None], torch.from_numpy(idx1)[None])[0]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


# ---- modules ---------------------------------------------------------------------

def _slot_table(rng, B=2, V=60, C=6):
    x = rng.randn(B, V, C).astype(np.float32) * 2 + 0.5
    mask = np.arange(V)[None] < np.array([V - 7, V - 20])[:B, None]
    return x, mask


def _bn_variables(rng, C):
    return {'params': {'scale': rng.uniform(0.5, 1.5, C).astype(np.float32),
                       'bias': rng.normal(0, 0.2, C).astype(np.float32)},
            'batch_stats': {'mean': rng.normal(0, 0.3, C).astype(np.float32),
                            'var': rng.uniform(0.3, 2.0, C).astype(np.float32)}}


@pytest.mark.parametrize('training', [False, True])
def test_masked_batchnorm(training):
    rng = np.random.RandomState(1)
    x, mask = _slot_table(rng)
    variables = _bn_variables(rng, x.shape[-1])
    want, mutated = j_sb.MaskedBatchNorm().apply(variables, jnp.asarray(x), jnp.asarray(mask),
                                                 training, mutable=['batch_stats'])
    bn = t_sb.MaskedBatchNorm(x.shape[-1]).train(training)
    bn.load_state_dict(from_flax(variables, bn))
    got = bn(torch.from_numpy(x), torch.from_numpy(mask))
    assert_close_to_scale(got.detach().numpy(), np.asarray(want), MODULE_RTOL)
    assert not got[~torch.from_numpy(mask)].any()
    stats = mutated['batch_stats']
    assert_close_to_scale(bn.running_mean.numpy(), np.asarray(stats['mean']), MODULE_RTOL)
    assert_close_to_scale(bn.running_var.numpy(), np.asarray(stats['var']), MODULE_RTOL)
    assert (np.asarray(stats['mean']) != variables['batch_stats']['mean']).any() == training


def _layer_inputs(rng, V=80, C=6):
    x, mask = _slot_table(rng, V=V, C=C)
    x = np.where(mask[..., None], x, 0.0).astype(np.float32)
    nbr = np.stack([make_maps(np.random.default_rng(i), V, 27) for i in range(2)])
    return x, mask, nbr


@pytest.mark.parametrize('use_relu', [True, False])
def test_sparse_conv_bn_relu(use_relu):
    rng = np.random.RandomState(2)
    x, mask, nbr = _layer_inputs(rng)
    jm = j_sb.SparseConvBNReLU(features=10, use_relu=use_relu)
    args = (jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(mask))
    variables = randomize_variables(jm.init(jax.random.PRNGKey(0), *args), 3)
    want = np.asarray(jm.apply(variables, *args))
    tm = t_sb.SparseConvBNReLU(6, 10, 27, use_relu=use_relu).eval()
    tm.load_state_dict(from_flax(variables, tm))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(nbr), torch.from_numpy(mask))
    assert_close_to_scale(got.numpy(), want, MODULE_RTOL)
    assert (want < 0).any() != use_relu
    assert not got[~torch.from_numpy(mask)].any()


def test_sparse_basic_block():
    rng = np.random.RandomState(4)
    x, mask, nbr = _layer_inputs(rng)
    jm = j_sb.SparseBasicBlock(features=6)
    args = (jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(mask))
    variables = randomize_variables(jm.init(jax.random.PRNGKey(0), *args), 5)
    want = np.asarray(jm.apply(variables, *args))
    tm = t_sb.SparseBasicBlock(6).eval()
    tm.load_state_dict(from_flax(variables, tm))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(nbr), torch.from_numpy(mask))
    assert_close_to_scale(got.numpy(), want, MODULE_RTOL)


def test_mean_vfe():
    rng = np.random.RandomState(6)
    voxels = rng.randn(2, 50, 5, 4).astype(np.float32)
    num = rng.randint(0, 6, (2, 50)).astype(np.int32)
    batch = {'voxels': voxels, 'voxel_num_points': num}
    want = JMeanVFE(model_cfg={}, num_point_features=4).apply(
        {}, {k: jnp.asarray(v) for k, v in batch.items()})['voxel_features']
    vfe = MeanVFE({}, 4)
    got = vfe({k: torch.from_numpy(v) for k, v in batch.items()})['voxel_features']
    assert vfe.get_output_feature_dim() == 4
    assert_close_to_scale(got.numpy(), np.asarray(want), MODULE_RTOL)
    assert not got[torch.from_numpy(num) == 0].any()


# ---- anchors and the head --------------------------------------------------------------

@pytest.mark.parametrize('align_center', [False, True])
def test_generate_anchors_equal_the_jax_package(align_center):
    cfg = cfg_from_yaml_file(SECOND)
    gen = [dict(c.to_dict(), align_center=align_center)
           for c in cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG]
    for grid in ((176, 200), (8, 8), (1, 3)):
        want, w_slices = j_ah.generate_anchors(gen, grid, cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
        got, g_slices = t_ah.generate_anchors(gen, grid, cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
        assert g_slices == w_slices and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_anchor_head_single_outputs_and_decoded_boxes():
    """Anchor-major outputs in the order [class][y][x][rot], the raw maps, and
    the boxes decoded with the direction classifier."""
    rng = np.random.RandomState(8)
    cfg = tiny_cfg()
    head_cfg, pc_range = cfg.MODEL.DENSE_HEAD, cfg.DATA_CONFIG.POINT_CLOUD_RANGE
    x = rng.randn(2, 5, 4, 12).astype(np.float32)              # H = 5, W = 4
    jm = j_ah.AnchorHeadSingle(model_cfg=JCfgNode(head_cfg.to_dict()), input_channels=12,
                               num_class=3, class_names=cfg.CLASS_NAMES, grid_size=(4, 5),
                               point_cloud_range=pc_range)
    variables = jm.init(jax.random.PRNGKey(0), {'spatial_features_2d': jnp.asarray(x)})
    variables = randomize_variables({**variables, 'batch_stats': {}}, 9, bias_scale=0.3)
    want = to_numpy(jm.apply(variables, {'spatial_features_2d': jnp.asarray(x)}))
    w_cls, w_boxes = to_numpy(jm.apply(variables, {k: jnp.asarray(v) for k, v in want.items()},
                                       method=jm.generate_predicted_boxes))
    tm = t_ah.AnchorHeadSingle(head_cfg, 12, 3, cfg.CLASS_NAMES, (4, 5), pc_range).eval()
    tm.load_state_dict(from_flax(variables, tm))
    with torch.no_grad():
        got = tm({'spatial_features_2d': torch.from_numpy(x)})
        g_cls, g_boxes = tm.generate_predicted_boxes(got)
    for k in ('anchor_cls_preds', 'anchor_box_preds', 'anchor_dir_preds', 'anchor_cls_preds_map',
              'anchor_box_preds_map', 'anchor_dir_preds_map'):
        assert_close_to_scale(got[k].numpy(), want[k], MODULE_RTOL, k)
    assert got['anchor_cls_preds'].shape == (2, 5 * 4 * 6, 3)
    assert_close_to_scale(g_cls.numpy(), w_cls, MODULE_RTOL)
    np.testing.assert_allclose(g_boxes.numpy(), w_boxes, rtol=1e-4, atol=1e-4)
    # the targets and losses are held in test_torch_port_second_train.py; the
    # ATSS assigner on this head's 120 anchors: the JAX package's labels
    tm.model_cfg.TARGET_ASSIGNER_CONFIG.NAME = 'ATSSTargetAssigner'
    j_cfg = head_cfg.to_dict()
    j_cfg['TARGET_ASSIGNER_CONFIG']['NAME'] = 'ATSSTargetAssigner'
    ja = j_ah.AnchorHeadSingle(model_cfg=JCfgNode(j_cfg), input_channels=12, num_class=3,
                               class_names=cfg.CLASS_NAMES, grid_size=(4, 5),
                               point_cloud_range=pc_range)
    gt = synthetic.gt_boxes(2, 3, pc_range, seed=3)
    mask = np.ones((2, 3), bool)
    w_labels = to_numpy(ja.apply({}, {'gt_boxes': jnp.asarray(gt), 'gt_mask': jnp.asarray(mask)},
                                 method=ja.assign_targets))['anchor_cls_labels']
    g_labels = tm.assign_targets({'gt_boxes': torch.from_numpy(gt),
                                  'gt_mask': torch.from_numpy(mask)})['anchor_cls_labels']
    np.testing.assert_array_equal(g_labels.numpy(), w_labels)
    assert (w_labels > 0).any(axis=1).all()


# ---- the backbone and the slice ----------------------------------------------------------

@pytest.fixture(scope='module')
def pairs():
    """The tiny SECOND in both packages, by (residual, as shipped): built on
    first use, kept for the module."""
    built = {}

    def get(residual=False, shipped=False):
        key = (residual, shipped)
        if key not in built:
            built[key] = ModelPair(tiny_cfg(residual, strip_table_dtype=not shipped), B=2,
                                   N=600, seed=0, voxels=True, bias_scale=0.1)
        return built[key]
    return get


@pytest.mark.parametrize('residual', [False, True])
def test_sparse_backbone_matches_jax(pairs, residual):
    """`spatial_features`, `encoded_sparse_out` and every `x_conv*` table of
    the plain and the residual ladder, weights through `from_flax`, random
    BatchNorm statistics. The JAX side runs with `XWIN: True`, as the file
    ships: its window gather is bitwise the plain one."""
    pair = pairs(residual)
    assert pair.cfg.MODEL.BACKBONE_3D.XWIN is True
    bb = pair.net.backbone_3d
    assert bb.residual == residual and bb.shapes[4] == (2, 8, 8) and bb.num_bev_features == 16
    with torch.inference_mode():
        out = bb(pair.net.vfe(pair.torch_inputs()))
    want = pair.jax_out
    assert out['spatial_features'].shape == (2, 8, 8, 16)
    assert_close_to_scale(out['spatial_features'].numpy(), want['spatial_features'], SLICE_RTOL)
    feats, coords, mask = out['encoded_sparse_out']
    assert_close_to_scale(feats.numpy(), want['encoded_sparse_out'][0], SLICE_RTOL)
    np.testing.assert_array_equal(coords.numpy(), want['encoded_sparse_out'][1])
    np.testing.assert_array_equal(mask.numpy(), want['encoded_sparse_out'][2])
    for k, (w_feats, w_coords, w_mask, w_stride) in want['multi_scale_3d_features_sparse'].items():
        g_feats, g_coords, g_mask, g_stride = out['multi_scale_3d_features_sparse'][k]
        assert_close_to_scale(g_feats.numpy(), w_feats, SLICE_RTOL, k)
        np.testing.assert_array_equal(g_coords.numpy(), w_coords)
        np.testing.assert_array_equal(g_mask.numpy(), w_mask)
        assert g_stride == w_stride
        assert not g_feats[~g_mask].any() and g_feats[g_mask].any()
    assert out['spatial_features_stride'] == want['spatial_features_stride'] == 8
    # the canvas holds each active out-site's row at its cell, z outer in the channels
    b, slot = 1, int(mask[1].sum()) - 1
    z, y, x = coords[b, slot].tolist()
    torch.testing.assert_close(out['spatial_features'][b, y, x, z * 8:(z + 1) * 8], feats[b, slot])


def test_sparse_backbone_with_shuffled_voxels(pairs):
    """Voxels handed over in another order give the same maps and, through
    `sp_perm1`, the same features."""
    pair = pairs(False)
    raw = {k: v for k, v in pair.torch_inputs().items() if not k.startswith('sp_')}
    n = raw['voxel_mask'].sum(1)
    shuffled = {k: v.clone() for k, v in raw.items()}
    gen = torch.Generator().manual_seed(0)
    for b in range(2):
        p = torch.randperm(int(n[b]), generator=gen)
        for k in ('voxels', 'voxel_coords', 'voxel_num_points'):
            shuffled[k][b, :int(n[b])] = raw[k][b, :int(n[b])][p]
    prepare = get_host_prepare(pair.cfg.MODEL, pair.cfg.DATA_CONFIG)
    a, b_ = prepare(raw), prepare(shuffled)
    for k in t_maps.LADDER_KEYS:
        if k != 'sp_perm1':
            assert torch.equal(a[k], b_[k]), k
    assert not torch.equal(a['sp_perm1'], b_['sp_perm1'])
    with torch.inference_mode():
        want, got = pair.net(a), pair.net(b_)
    assert_close_to_scale(got['anchor_cls_preds'].numpy(), want['anchor_cls_preds'].numpy(), 1e-6)


def match_by_box(got: dict, want: dict, atol: float) -> int:
    """Pairs each kept detection of `want` with the nearest kept box of `got`;
    returns how many found a twin within `atol` with the same label."""
    n = 0
    for b in range(len(want['pred_boxes'])):
        w, g = want['pred_boxes'][b][want['pred_mask'][b]], got['pred_boxes'][b][got['pred_mask'][b]]
        if len(w) == 0 or len(g) == 0:
            continue
        dist = np.abs(w[:, None] - g[None]).max(-1)
        twin = dist.argmin(1)
        same = want['pred_labels'][b][want['pred_mask'][b]] == \
            got['pred_labels'][b][got['pred_mask'][b]][twin]
        n += int(((dist.min(1) <= atol) & same).sum())
    return n


@pytest.mark.parametrize('residual', [False, True])
def test_second_slice_matches_jax(pairs, residual):
    """`Detector3D` of the tiny SECOND through `get_host_prepare` and
    `predict` in both packages, `TABLE_DTYPE` removed in memory on both
    sides: the maps, the head outputs, the top-K selection, the detections."""
    pair = pairs(residual)
    for k in t_maps.LADDER_KEYS:
        np.testing.assert_array_equal(pair.torch_inputs()[k].numpy(), pair.inputs[k], err_msg=k)
    with torch.inference_mode():
        out = pair.net(pair.torch_inputs())
    for k in ('voxel_features', 'spatial_features', 'spatial_features_2d', 'anchor_cls_preds',
              'anchor_box_preds', 'anchor_dir_preds'):
        assert_close_to_scale(out[k].numpy(), pair.jax_out[k], SLICE_RTOL, k)
    # the same candidates reach the NMS
    from pdm_ssd_tpu.ops.selection import two_stage_topk as j_topk
    from pdm_ssd_torch.ops.selection import two_stage_topk as t_topk
    K = 2 * pair.cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE
    w_scores = jax.nn.sigmoid(jnp.asarray(pair.jax_out['anchor_cls_preds'])).max(-1)
    g_scores = torch.sigmoid(out['anchor_cls_preds']).max(-1).values
    w_top, w_sel = j_topk(w_scores, K)
    g_top, g_sel = t_topk(g_scores, K)
    for b in range(2):
        common = len(set(np.asarray(w_sel[b]).tolist()) & set(g_sel[b].tolist()))
        assert common >= K - 2, f'{common} of {K} selected anchors in common'
    assert_close_to_scale(g_top.numpy(), np.asarray(w_top), SLICE_RTOL)
    want = pair.jax_method(pair.jax_model.predict, pair.inputs)
    got = to_numpy(pair.net.predict(pair.torch_inputs()))
    assert got['pred_boxes'].shape == want['pred_boxes'].shape == (2, 16, 7)
    np.testing.assert_array_equal(got['pred_mask'].sum(1), want['pred_mask'].sum(1))
    assert want['pred_mask'].sum() >= 8 and np.isfinite(want['pred_boxes']).all()
    # near-tied scores permute slots between the packages: match by box
    assert match_by_box(got, want, atol=1e-3) >= want['pred_mask'].sum() - 2


def test_second_as_shipped_deviates_by_the_bf16_tables_only(pairs):
    """The file's own BACKBONE_3D block: the JAX ladder runs its tables in
    bf16, the port stays in float32. The deviation is measured and bounded."""
    pair = pairs(False, shipped=True)
    assert pair.cfg.MODEL.BACKBONE_3D.TABLE_DTYPE == 'bf16'
    with torch.inference_mode():
        out = pair.net(pair.torch_inputs())
    rel = {}
    for k in ('spatial_features', 'spatial_features_2d', 'anchor_cls_preds', 'anchor_box_preds',
              'anchor_dir_preds'):
        w = pair.jax_out[k].astype(np.float64)
        rel[k] = np.abs(out[k].numpy() - w).max() / np.abs(w).max()
        assert_close_to_scale(out[k].numpy(), w, BF16_TABLE_RTOL, k)
    print('deviation from the bf16 tables, of each output\'s scale:',
          {k: f'{v:.2e}' for k, v in rel.items()})           # shown by pytest -s
    # the deviation is real: the tight bound would not hold
    assert max(rel.values()) > 10 * SLICE_RTOL


def test_from_flax_loads_every_leaf_of_the_full_width_model():
    """`second_sparse.yaml` as shipped: the flax tree's shapes from
    `jax.eval_shape` (no full-width forward here) land on the port's model."""
    from pdm_ssd_tpu.models import build_network as j_build_network
    cfg = cfg_from_yaml_file(SECOND)
    jcfg = JCfgNode(cfg.to_dict())
    jm = j_build_network(jcfg.MODEL, num_class=3, dataset_cfg=jcfg.DATA_CONFIG)
    caps = list(cfg.MODEL.BACKBONE_3D.ACTIVE_CAPS)
    V = caps[0] = 40000
    spec = {'voxels': ((1, V, 5, 4), np.float32), 'voxel_coords': ((1, V, 3), np.int32),
            'voxel_num_points': ((1, V), np.int32), 'voxel_mask': ((1, V), bool),
            'sp_perm1': ((1, V), np.int32)}
    for s, cap in zip((1, 2, 3, 4), caps):
        spec.update({f'sp_coords{s}': ((1, cap, 3), np.int32), f'sp_mask{s}': ((1, cap), bool),
                     f'sp_submap{s}': ((1, cap, 27), np.int32)})
        if s > 1:
            spec[f'sp_downmap{s}'] = ((1, cap, 27), np.int32)
    spec.update({'sp_coords_out': ((1, caps[4], 3), np.int32), 'sp_mask_out': ((1, caps[4]), bool),
                 'sp_outmap': ((1, caps[4], 3), np.int32)})
    batch = {k: jax.ShapeDtypeStruct(shape, dtype) for k, (shape, dtype) in spec.items()}
    shapes = jax.eval_shape(lambda b: jm.init({'params': jax.random.PRNGKey(0)}, b,
                                              training=False), batch)
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    net = build_network(cfg.MODEL, 3, cfg.DATA_CONFIG, device='meta')
    state = from_flax(variables, net)
    n_leaves = len(jax.tree_util.tree_leaves(shapes))
    assert n_leaves == len([k for k in state if not k.endswith('num_batches_tracked')])
    assert state['module_list_1.conv_input.kernel'].shape == (27 * 4, 16)
    assert state['module_list_1.conv_out.kernel'].shape == (3 * 64, 128)
    assert net.backbone_3d.num_bev_features == 256 and net.backbone_3d.shapes[4] == (2, 200, 176)
    assert net.dense_head.anchors_np.shape == (200 * 176 * 6, 7)
    bad = dict(variables, params={**variables['params'], 'extra': {'kernel': np.zeros((1, 1))}})
    with pytest.raises(KeyError):
        from_flax(bad, net)


def test_dry_run_of_the_tiny_second():
    from pdm_ssd_torch.tools import dryrun
    assert np.isfinite(dryrun.dryrun('cpu', cfg_file=SECOND))    # a train step, then predict
