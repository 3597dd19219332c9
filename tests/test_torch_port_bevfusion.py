"""BEVFusion in the port against the JAX package, on the CPU: `ops/bev_pool`,
Swin's window attention (with and without the shifted windows' mask), its
blocks, its pyramid and its folded FPN, drop path, the bilinear upsampling
and the GeneralizedLSSFPN neck, `DepthLSSTransform`'s BEV map, the
convolutional image backbone and the fuser, and the tiny BEVFusion
(`synthetic.tiny_bevfusion_cfg`): weights, forward, predict, losses and
gradients. Also the reference's faults that `bevfusion.yaml` and the JAX
trainer carry (ROADMAP Queue 3), in both packages.

Inputs come from numpy seeds; both packages run float32; JAX runs jitted.
Each tolerance stands beside its reason.
"""
import functools
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from pdm_ssd_torch.models.backbones_image import ConvFuser as TFuser
from pdm_ssd_torch.models.backbones_image import ConvImageBackbone as TConvBackbone
from pdm_ssd_torch.models.backbones_image import GeneralizedLSSFPN as TNeck
from pdm_ssd_torch.models.backbones_image import SwinTransformer as TSwin
from pdm_ssd_torch.models.backbones_image.swin import SwinBlock as TBlock
from pdm_ssd_torch.models.backbones_image.swin import WindowAttention as TAttention
from pdm_ssd_torch.models.backbones_image.swin import drop_path, shift_mask
from pdm_ssd_torch.models.layers import init_parameters
from pdm_ssd_torch.models.view_transforms.depth_lss import DepthLSSTransform as TLSS
from pdm_ssd_torch.ops.bev_pool import bev_pool as t_bev_pool
from pdm_ssd_torch.utils import synthetic
from pdm_ssd_torch.utils.config import CfgNode as TCfgNode
from pdm_ssd_torch.utils.config import cfg_from_yaml_file
from pdm_ssd_torch.utils.weights import from_flax, to_flax
from pdm_ssd_tpu.models.backbones_image import ConvFuser as JFuser
from pdm_ssd_tpu.models.backbones_image import ConvImageBackbone as JConvBackbone
from pdm_ssd_tpu.models.backbones_image import GeneralizedLSSFPN as JNeck
from pdm_ssd_tpu.models.backbones_image import SwinTransformer as JSwin
from pdm_ssd_tpu.models.backbones_image.swin import SwinBlock as JBlock
from pdm_ssd_tpu.models.backbones_image.swin import WindowAttention as JAttention
from pdm_ssd_tpu.models.view_transforms.depth_lss import DepthLSSTransform as JLSS
from pdm_ssd_tpu.ops.bev_pool import bev_pool as j_bev_pool
from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_harness import (REPO, ModelPair, assert_close_to_scale, hold_to_jax, leaves,
                                match_detections, open_score_gate_flax, port_loss_and_grads,
                                randomize_variables, rel_l2, to_numpy)

# one layer fed the same inputs: float32 sums in another order only
LAYER_RTOL = 1e-5
# a few layers of the same (Swin's stages, the neck, the tiny model's maps)
MODEL_RTOL = 1e-4
# bev_pool's cell sums against float64 sums of the same features: float32
# adds in another order, at most a few ulps of the largest cell
POOL_RTOL = 1e-6
# the losses of one batch
LOSS_RTOL = 1e-5
# per-leaf gradients, relative L2
GRAD_REL_L2 = 1e-3
# the tiny model's camera branch takes its gradient through the fuser's
# training-mode BatchNorm, whose backward cancels large terms: there the JAX
# package's float32 strays from its float64 by up to 2.5e-2 (Swin's stage 1
# LayerNorm scale), where the port's float32 lies within 1.4e-6 of that
# float64 but for dtransform's first conv kernel, 3.0e-3 (the JAX package's
# own: 1.6e-2); `hold_to_jax` holds those leaves to the JAX float64 run
# (104 of the 153 leaves lie further than GRAD_REL_L2 apart: the camera
# branch's)
JAX_F32_GRAD_REL_L2 = 3e-2
MAX_APART = 110
# the last Swin stage's MLP bias adds a constant to each channel of the map
# the neck's lateral conv reads before its training-mode BatchNorm, which
# takes the constant away: its gradient is 0 in exact arithmetic, float32
# noise (5e-10 of the largest) in both packages, held by its norm
NULL_GRADS = ('image_backbone/s3_b0/mlp2/bias',)
NULL_GRAD_RTOL = 1e-6
# DepthLSSTransform's BEV map: the frustum's points pass through two 3x3
# inverses and two 3x3 products whose float32 sums each package orders its
# own way, so a point that lies within rounding of a cell edge may floor
# into the next cell in one package; at most this many of the map's cells
# may then differ beyond MODEL_RTOL (a point moving takes its features
# from one cell to its neighbour: two cells); measured on the test's inputs:
# none, the maps within 3.6e-7 of scale
FLIPPED_CELLS = 4
# decoded boxes matched between the two packages' detections
BOX_ATOL = 1e-3


def _jit_apply(module, variables, *args, **kwargs):
    return to_numpy(jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(variables, *args))


def _rows(rng, shape) -> np.ndarray:
    return rng.normal(0.0, 1.0, shape).astype(np.float32)


def _seeded(module: torch.nn.Module, seed: int, bias_scale: float = 0.2) -> dict:
    """`module`'s seeded weights in the flax layout, the norms' scales,
    biases and statistics randomized, and loaded back into it, in eval
    mode."""
    init_parameters(module, torch.Generator().manual_seed(seed))
    variables = randomize_variables(to_flax(module), seed, bias_scale)
    module.load_state_dict(from_flax(variables, module))
    module.eval()
    return variables


def _port(module: torch.nn.Module, *args, **kwargs):
    with torch.no_grad():
        out = module(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args),
                     **kwargs)
    return to_numpy(out)


def load_nuscenes_cfg(name: str):
    cwd = os.getcwd()
    os.chdir(REPO)          # configs name their base config relative to the repo
    try:
        return cfg_from_yaml_file(f'configs/nuscenes_models/{name}.yaml', TCfgNode())
    finally:
        os.chdir(cwd)


# ---- bev_pool ---------------------------------------------------------------------

@pytest.mark.parametrize('Z', [1, 2])
def test_bev_pool_sums_each_cell_as_the_jax_package(Z):
    """Every cell's sum of the points that fall in it, z folded into the
    channels: against float64 sums and against the JAX package's scatter,
    with points off the grid on each axis and points masked out (both go to
    the dropped dump row)."""
    rng = np.random.RandomState(0)
    B, P, C, nx = 2, 3000, 5, (7, 6, Z)
    feats = _rows(rng, (B, P, C))
    coords = np.stack([rng.randint(-1, nx[0] + 1, (B, P)), rng.randint(-1, nx[1] + 1, (B, P)),
                       rng.randint(-1, Z + 1, (B, P))], -1).astype(np.int32)
    valid = rng.rand(B, P) < 0.8
    got = t_bev_pool(torch.from_numpy(feats), torch.from_numpy(coords), torch.from_numpy(valid),
                     nx).numpy()
    want = np.asarray(jax.jit(lambda f, c, v: j_bev_pool(f, c, v, nx))(feats, coords, valid))
    exact = np.zeros((B, nx[1], nx[0], Z, C))
    ok = valid & np.all((coords >= 0) & (coords < np.array(nx)), -1)
    for b in range(B):
        for p in np.flatnonzero(ok[b]):
            x, y, z = coords[b, p]
            exact[b, y, x, z] += feats[b, p]
    exact = exact.reshape(B, nx[1], nx[0], Z * C)
    assert got.shape == want.shape == exact.shape
    assert_close_to_scale(got, exact, POOL_RTOL, 'port')
    assert_close_to_scale(got, want, 2 * POOL_RTOL, 'jax')
    # valid=None is all valid
    all_valid = t_bev_pool(torch.from_numpy(feats), torch.from_numpy(coords), None, nx).numpy()
    full = t_bev_pool(torch.from_numpy(feats), torch.from_numpy(coords),
                      torch.ones(B, P, dtype=torch.bool), nx).numpy()
    np.testing.assert_array_equal(all_valid, full)


# ---- Swin ---------------------------------------------------------------------------

@pytest.mark.parametrize('shifted', [False, True])
def test_window_attention_matches_flax(shifted):
    """Windows of 4 x 4 over an 8 x 12 map, 2 images, 3 heads of 4: the
    relative-position bias (a parameter of the module), the scores divided
    by sqrt(head width) after the product; with `shifted`, the -100 mask of
    the shifted windows (`shift_mask`, tiled over the images as the JAX
    package tiles it)."""
    rng = np.random.RandomState(1)
    H, W, w, dim, heads = 8, 12, 4, 12, 3
    nW = (H // w) * (W // w)
    x = _rows(rng, (2, nW, w * w, dim))
    mask = shift_mask(H, W, w, w // 2) if shifted else None
    attn = TAttention(dim, w, heads)
    variables = _seeded(attn, 2)
    assert variables['params']['rel_bias'].shape == ((2 * w - 1) ** 2, heads)
    j_mask = None if mask is None else np.tile(mask, (2, 1, 1))
    want = _jit_apply(JAttention(dim, w, heads), variables, x.reshape(2 * nW, w * w, dim),
                      j_mask)
    got = _port(attn, x, None if mask is None else torch.from_numpy(mask))
    if shifted:
        assert (mask == -100).any() and (mask == 0).any()
    assert_close_to_scale(got.reshape(want.shape), want, LAYER_RTOL, 'attention')


@pytest.mark.parametrize('shift', [0, 2])
def test_swin_block_matches_flax(shift):
    """One block (LayerNorm, the cyclic roll, window attention, residual,
    LayerNorm, exact GELU MLP, residual) on an 8 x 12 map: the port builds
    its mask from the window-id map as the JAX block does."""
    rng = np.random.RandomState(3)
    x = _rows(rng, (2, 8, 12, 12))
    block = TBlock(12, 3, 4, shift, drop_path_rate=0.2)
    variables = _seeded(block, 4)
    want = _jit_apply(JBlock(12, 3, 4, shift, drop_path=0.2), variables, x)
    assert_close_to_scale(_port(block, x), want, LAYER_RTOL, 'block')


SWIN = {'EMBED_DIM': 8, 'DEPTHS': [1, 2, 1, 1], 'NUM_HEADS': [1, 2, 2, 4], 'WINDOW_SIZE': 4,
        'PATCH_SIZE': 4, 'DROP_PATH_RATE': 0.2}
SWIN_CASES = {
    # bevfusion_mini.yaml's path: 64 x 96 images, the pyramid of stages 1 to
    # 3 (8 x 12, 4 x 6 padded to 4 x 8, 2 x 3 padded to 4 x 4), normed
    'pyramid': dict(hw=(64, 96), cfg={'RETURN_PYRAMID': True, 'OUT_INDICES': [1, 2, 3],
                                      'OUT_NORM': True}),
    # 50 x 86 images: a 'SAME' patch embedding (13 x 22), odd stages whose
    # patch merging drops the last row or column, the folded FPN to 16
    # channels at the last stage's 1 x 2
    'odd, fpn': dict(hw=(50, 86), cfg={'OUT_CHANNEL': 16}),
}


@pytest.mark.parametrize('case', list(SWIN_CASES))
def test_swin_transformer_matches_jax(case):
    """`SwinTransformer` on 2 x 2 images: the patch embedding, the padding to
    window multiples before each stage (the padded tokens attend unmasked),
    the patch merging's 2 x 2 concatenation in row-major order, both outputs
    (training mode differs only by drop path, held by the next tests)."""
    spec = SWIN_CASES[case]
    cfg = {**SWIN, **spec['cfg']}
    rng = np.random.RandomState(5)
    images = _rows(rng, (2, 2, *spec['hw'], 3))
    swin = TSwin(TCfgNode(cfg))
    variables = _seeded(swin, 6)
    want = _jit_apply(JSwin(model_cfg=JCfgNode(cfg)), variables, images)
    got = _port(swin, images)
    if case == 'pyramid':
        assert [g.shape for g in got] == [(2, 2, 8, 12, 16), (2, 2, 4, 6, 32), (2, 2, 2, 3, 64)]
        for g, w in zip(got, want):
            assert_close_to_scale(g, w, MODEL_RTOL, case)
    else:
        assert got.shape == (2, 2, 1, 2, 16)
        assert_close_to_scale(got, want, MODEL_RTOL, case)


def test_drop_path_is_a_per_image_bernoulli_only_with_a_generator():
    """With a generator, each image's branch is kept (scaled by 1 / keep) or
    dropped by one uniform draw each; without one (as the train step runs
    it) the identity, as the JAX package's without a 'dropout' rng."""
    x = torch.from_numpy(_rows(np.random.RandomState(7), (64, 3, 5)))
    gen = torch.Generator().manual_seed(3)
    got = drop_path(x, 0.25, gen)
    keep = torch.rand((64, 1, 1), generator=torch.Generator().manual_seed(3)) < 0.75
    torch.testing.assert_close(got, x * keep / 0.75, rtol=0, atol=0)
    assert 0 < int(keep.sum()) < 64
    assert drop_path(x, 0.25, None) is x and drop_path(x, 0.0, gen) is x
    block = TBlock(12, 3, 4, 2, drop_path_rate=0.5)
    _seeded(block, 8)
    y = torch.from_numpy(_rows(np.random.RandomState(9), (6, 8, 12, 12)))
    with torch.no_grad():
        eval_out = block.eval()(y)
        block.train()
        torch.testing.assert_close(block(y), eval_out, rtol=0, atol=0)
        assert not torch.equal(block(y, torch.Generator().manual_seed(0)), eval_out)
        block.eval()
        torch.testing.assert_close(block(y, torch.Generator().manual_seed(0)), eval_out,
                                   rtol=0, atol=0)


def test_jax_train_step_passes_no_dropout_rng_so_drop_path_never_applies():
    """The reference's fault (ROADMAP Queue 3): the JAX package's Swin drops
    paths only with a 'dropout' rng, and its train step passes none, so
    DROP_PATH_RATE (0.2 in `bevfusion.yaml`) never applies in its training;
    a training-mode apply without the rng is the eval-mode one."""
    from pdm_ssd_tpu.runtime import trainer as j_trainer
    source = inspect.getsource(j_trainer)
    assert "'dropout'" not in source and '"dropout"' not in source
    rng = np.random.RandomState(10)
    x = _rows(rng, (4, 8, 12, 12))
    block = TBlock(12, 3, 4, 2, drop_path_rate=0.5)
    variables = _seeded(block, 11)
    j_block = JBlock(12, 3, 4, 2, drop_path=0.5)
    train = jax.jit(lambda v, a: j_block.apply(v, a, training=True))(variables, x)
    np.testing.assert_array_equal(np.asarray(train), _jit_apply(j_block, variables, x))
    dropped = jax.jit(lambda v, a: j_block.apply(v, a, training=True,
                                                 rngs={'dropout': jax.random.PRNGKey(0)}))
    assert not np.array_equal(np.asarray(dropped(variables, x)), np.asarray(train))


# ---- the neck, the view transform, the conv backbone and the fuser -----------------

# the bilinear upsamplings of the neck at the two configs' shapes:
# bevfusion.yaml's (256 x 704 images: stages at 32 x 88, 16 x 44, 8 x 22) and
# bevfusion_mini.yaml's (64 x 96: 8 x 12, 4 x 6, 2 x 3)
UPSAMPLES = [((16, 44), (32, 88)), ((8, 22), (16, 44)), ((4, 6), (8, 12)), ((2, 3), (4, 6))]


@pytest.mark.parametrize('src,dst', UPSAMPLES)
def test_bilinear_upsampling_matches_jax_image_resize(src, dst):
    """`F.interpolate(..., 'bilinear', align_corners=False)` against the JAX
    package's `jax.image.resize(..., 'bilinear')` at every upsampling the two
    configs make (the edges: torch clamps the source index, JAX drops the
    sample and renormalises, the same weights on the same pixel)."""
    x = _rows(np.random.RandomState(12), (3, *src, 5))
    want = np.asarray(jax.jit(lambda a: jax.image.resize(a, (3, *dst, 5), 'bilinear'))(x))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=dst, mode='bilinear',
                        align_corners=False).permute(0, 2, 3, 1).numpy()
    assert_close_to_scale(got, want, LAYER_RTOL, f'{src} -> {dst}')


@pytest.mark.parametrize('levels', [[(8, 12), (4, 6), (2, 3)], [(32, 88), (16, 44), (8, 22)]])
def test_neck_matches_jax(levels):
    """GeneralizedLSSFPN (IN_CHANNELS [6, 10, 12], OUT_CHANNELS 8) in eval and
    training mode at the pyramid shapes of `bevfusion_mini.yaml` and
    `bevfusion.yaml`: two output levels, the first lateral reading the raw
    coarsest stage."""
    cfg = {'IN_CHANNELS': [6, 10, 12], 'OUT_CHANNELS': 8, 'NUM_OUTS': 2, 'START_LEVEL': 0,
           'END_LEVEL': -1}
    rng = np.random.RandomState(13)
    feats = [_rows(rng, (1, 2, h, w, c)) for (h, w), c in zip(levels, cfg['IN_CHANNELS'])]
    neck = TNeck(TCfgNode(cfg))
    variables = _seeded(neck, 14)
    j_neck = JNeck(model_cfg=JCfgNode(cfg))
    want = _jit_apply(j_neck, variables, feats)
    got = _port(neck, [torch.from_numpy(f) for f in feats])
    assert [g.shape for g in got] == [(1, 2, *levels[0], 8), (1, 2, *levels[1], 8)]
    for g, w in zip(got, want):
        assert_close_to_scale(g, w, MODEL_RTOL, 'eval')
    (want, stats), got = jax.jit(lambda v, f: j_neck.apply(v, f, training=True,
                                                           mutable=['batch_stats']))(
        variables, feats), None
    neck.train()
    got = _port(neck, [torch.from_numpy(f) for f in feats])
    neck.eval()
    for g, w in zip(got, to_numpy(want)):
        assert_close_to_scale(g, w, MODEL_RTOL, 'training')
    for k, v in leaves(to_numpy(stats['batch_stats'])):
        np.testing.assert_allclose(dict(leaves(to_flax(neck)['batch_stats']))[k], v,
                                   rtol=MODEL_RTOL, atol=1e-6, err_msg=k)


def _lss_cfg(downsample: int) -> dict:
    return {'IN_CHANNEL': 8, 'OUT_CHANNEL': 6, 'IMAGE_SIZE': [64, 96], 'FEATURE_SIZE': [8, 12],
            'XBOUND': [0.0, 32.0, 1.0], 'YBOUND': [-16.0, 16.0, 1.0],
            'ZBOUND': [-4.0, 4.0, 8.0] if downsample == 1 else [-4.0, 4.0, 4.0],
            'DBOUND': [1.0, 17.0, 2.0], 'DOWNSAMPLE': downsample}


def _camera_inputs(cfg, B: int, n_cam: int, seed: int, c_in: int) -> dict:
    """A camera batch of `synthetic.camera_batch`'s rig and depth maps for
    `cfg` (a whole config), with random features in place of the images'."""
    rng = np.random.RandomState(seed)
    batch = synthetic.camera_batch(B, 4096, cfg, seed=seed, n_cam=n_cam, image_wh=(192, 128))
    fH, fW = cfg.MODEL.VTRANSFORM.FEATURE_SIZE
    out = {k: batch[k] for k in ('camera_depth', 'camera2lidar', 'camera_intrinsics',
                                 'img_aug_matrix')}
    out['camera_feats'] = torch.from_numpy(_rows(rng, (B, n_cam, fH, fW, c_in)))
    return out


@pytest.mark.parametrize('downsample', [1, 2])
def test_depth_lss_transform_matches_jax(downsample):
    """`DepthLSSTransform` on two clouds seen by two cameras of the rig (the
    sparse depth maps of the cloud, the test-time resize and crop as
    'img_aug_matrix'): dtransform, depthnet, the lifted product, the
    geometry and the pooled map, at one z level and DOWNSAMPLE 1, and at two
    levels and DOWNSAMPLE 2 (the three downsample convs); cells flipped at a
    floor edge within FLIPPED_CELLS."""
    cfg = synthetic.tiny_bevfusion_cfg(load_nuscenes_cfg('bevfusion_mini'))
    cfg.MODEL.VTRANSFORM.update(_lss_cfg(downsample))
    batch = _camera_inputs(cfg, 2, 2, 15, 8)
    assert (batch['camera_depth'] > 0).sum() > 100
    lss = TLSS(cfg.MODEL.VTRANSFORM)
    variables = _seeded(lss, 16)
    j_lss = JLSS(model_cfg=JCfgNode(cfg.MODEL.VTRANSFORM.to_dict()))
    want = _jit_apply(j_lss, variables, to_numpy(batch))['spatial_features']
    got = _port(lss, dict(batch))['spatial_features']
    nz = 1 if downsample == 1 else 2
    assert got.shape == want.shape == (2, 32 // downsample, 32 // downsample, 6 * nz)
    assert np.abs(want).max() > 0
    scale = np.abs(want).max()
    apart = np.abs(got - want).max(-1) > MODEL_RTOL * scale
    assert apart.sum() <= FLIPPED_CELLS, int(apart.sum())
    if downsample == 1:         # the pooled map itself: occupied cells exactly as many
        assert (np.abs(got).max(-1) > 0).sum() == (np.abs(want).max(-1) > 0).sum()


def test_conv_image_backbone_and_fuser_match_jax():
    """`ConvImageBackbone` (the stem, three stages of residual blocks, the
    2x nearest upsampling onto the middle stage) on 2 x 2 images of 64 x 96,
    and `ConvFuser` on two maps, in eval mode."""
    rng = np.random.RandomState(17)
    cfg = {'NUM_FILTERS': [8, 12, 16], 'OUT_CHANNEL': 10}
    images = _rows(rng, (2, 2, 64, 96, 3))
    backbone = TConvBackbone(TCfgNode(cfg))
    variables = _seeded(backbone, 18)
    want = _jit_apply(JConvBackbone(model_cfg=JCfgNode(cfg)), variables, images)
    got = _port(backbone, images)
    assert got.shape == (2, 2, 8, 12, 10)
    assert_close_to_scale(got, want, MODEL_RTOL, 'image backbone')
    lidar, camera = _rows(rng, (2, 9, 11, 5)), _rows(rng, (2, 9, 11, 7))
    fuser = TFuser(TCfgNode({'OUT_CHANNEL': 6}), 12)
    variables = _seeded(fuser, 19)
    want = _jit_apply(JFuser(model_cfg=JCfgNode({'OUT_CHANNEL': 6})), variables, lidar, camera)
    assert_close_to_scale(_port(fuser, lidar, camera), want, LAYER_RTOL, 'fuser')


# ---- the tiny model -----------------------------------------------------------------

INPUT_KEYS = ('points', 'voxels', 'voxel_coords', 'voxel_num_points', 'voxel_mask',
              'camera_imgs', 'camera_depth', 'camera2lidar', 'camera_intrinsics',
              'img_aug_matrix')


@pytest.fixture(scope='module')
def bevfusion():
    """The tiny BEVFusion in both packages on two clouds of 4096 points over
    its 32 x 32 m range, seen by two cameras of the rig, with 4 cars a cloud
    on the range's ground, its weights started from the seeded port model's
    (`test_weights_have_the_jax_layout` holds them to the JAX init's) with
    the heatmap bias at 0 (`synthetic.open_score_gate`: at its initial -2.19
    every score lies near SCORE_THRESH, where float32 rounding decides which
    candidates pass), so that one eval forward serves the forward's and
    predict's checks."""
    cfg = synthetic.tiny_bevfusion_cfg(load_nuscenes_cfg('bevfusion_mini'))
    raw = synthetic.camera_batch(2, 4096, cfg, seed=0, n_cam=2, image_wh=(192, 128))
    batch = {k: v.numpy() for k, v in raw.items()}
    gt = synthetic.gt_boxes(2, 4, cfg.DATA_CONFIG.POINT_CLOUD_RANGE, seed=1)
    gt[..., 7] = 1
    batch.update(gt_boxes=gt, gt_mask=np.ones((2, 4), bool))
    start = to_flax(synthetic.random_model(cfg, 'cpu', seed=0))
    return ModelPair(cfg, B=2, seed=0, batch=batch, variables=start, input_keys=INPUT_KEYS)


def test_weights_have_the_jax_layout(bevfusion):
    """The port's tensors in the flax layout have the paths, shapes and
    dtypes of the JAX package's init (traced, not compiled), Swin's
    `s<i>_b<j>/attn/rel_bias` included, and map back unchanged."""
    init = jax.eval_shape(lambda b: bevfusion.jax_model.init(
        {'params': jax.random.PRNGKey(0)}, b, training=False), bevfusion.inputs)
    back = to_flax(bevfusion.net)
    for kind in ('params', 'batch_stats'):
        want = {'/'.join(str(getattr(p, 'key', p)) for p in path): (a.shape, a.dtype)
                for path, a in jax.tree_util.tree_leaves_with_path(init[kind])}
        got = dict(leaves(back[kind]))
        assert {k: (v.shape, v.dtype) for k, v in got.items()} == want, kind
        for k, v in leaves(bevfusion.variables[kind]):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    params = back['params']
    assert params['image_backbone']['s2_b1']['attn']['rel_bias'].shape == (49, 4)
    assert {'lateral_0', 'lateral_1', 'fpn_0', 'fpn_1'} <= set(params['neck'])
    assert {'dt0_conv', 'dn_out', 'fuse_conv'} <= set(params['view_transform']) | \
        set(params['fuser'])


def test_forward_and_predict_match_jax(bevfusion):
    """The eval forward: the image features, the fused map and the heatmap
    head's maps within MODEL_RTOL of scale; then, with the heatmap bias at 0
    in both packages (`synthetic.open_score_gate`: at its initial -2.19
    every score lies near SCORE_THRESH, where float32 rounding decides which
    candidates pass), `predict` against the JAX package's post-processing of
    its own eval forward (the same compiled forward): the same detections by
    box and label."""
    J = bevfusion.jax_out
    with torch.no_grad():
        T = to_numpy(bevfusion.net(bevfusion.torch_inputs()))
    assert T['spatial_features_2d'].shape == (2, 32, 32, 16)
    assert_close_to_scale(T['camera_feats'], J['camera_feats'], MODEL_RTOL, 'camera_feats')
    for k in ('spatial_features', 'spatial_features_2d'):
        assert_close_to_scale(T[k], J[k], MODEL_RTOL, k)
    for k, want in J['center_head_preds'][0].items():
        assert_close_to_scale(T['center_head_preds'][0][k], want, MODEL_RTOL, k)
    gate_open = open_score_gate_flax(bevfusion.variables)
    want = bevfusion.jax_method(bevfusion.jax_model.post_process,
                                bevfusion.jax_eval_forward(gate_open))
    bevfusion.net.load_state_dict(from_flax(gate_open, bevfusion.net))
    try:
        got = bevfusion.net.predict(bevfusion.torch_inputs())
    finally:
        bevfusion.net.load_state_dict(from_flax(bevfusion.variables, bevfusion.net))
    assert match_detections(got, want, BOX_ATOL) >= 1


def test_training_loss_and_gradients_match_jax(bevfusion):
    """The training loss and its terms within LOSS_RTOL and every gradient
    (Swin's relative-position tables included) within GRAD_REL_L2 relative
    L2 of the JAX package's, from the pair's one compiled value and
    gradient; where the JAX package's own float32 strays from its float64
    (the camera branch, `hold_to_jax`), held to that float64 run; the last
    stage's null gradient by its norm; the BatchNorm statistics after the
    step."""
    batch = bevfusion.torch_batch()
    _, tb, grads, stats = port_loss_and_grads(bevfusion, batch)
    _, j_tb, j_grads, j_stats = bevfusion.jax_loss_and_grads()
    assert set(tb) == {'hm_loss', 'loc_loss', 'loss'} == set(j_tb)
    exact = functools.lru_cache(bevfusion.jax_f64_loss_and_grads)
    port_exact = functools.lru_cache(
        lambda: port_loss_and_grads(bevfusion, batch, torch.float64)[1:3])
    hold_to_jax(tb, j_tb, lambda: exact()[0], LOSS_RTOL, JAX_F32_GRAD_REL_L2, 0)
    got, want = dict(leaves(grads)), dict(leaves(j_grads))
    assert set(got) == set(want)
    assert any('rel_bias' in k for k in want)
    largest = max(np.linalg.norm(v) for v in want.values())
    for k in NULL_GRADS:
        assert max(np.linalg.norm(got.pop(k)), np.linalg.norm(want.pop(k))) \
            <= NULL_GRAD_RTOL * largest, k

    def without_null(tree):
        return {k: v for k, v in leaves(tree) if k not in NULL_GRADS}

    hold_to_jax(got, want, lambda: without_null(exact()[1]), GRAD_REL_L2, JAX_F32_GRAD_REL_L2,
                MAX_APART, lambda: without_null(port_exact()[1]))
    got, want = dict(leaves(stats)), dict(leaves(j_stats))
    for k in want:
        assert rel_l2(got[k], want[k]) <= MODEL_RTOL, k


# ---- the reference's faults in bevfusion.yaml ---------------------------------------

def test_bevfusion_yaml_grids_do_not_line_up_in_either_package():
    """ROADMAP Queue 3. As shipped, `bevfusion.yaml`'s 0.3 m pillars over
    +-51.2 m give a 341 x 341 LiDAR map, whose stride-2 BEV level comes back
    from its 2x upsampling at 342: the JAX package's BEV backbone fails while
    tracing and the port's `backbone_2d` the same way (both at the file's
    grid, narrow; the port on the meta device). The camera map is +-54 m at
    0.3 m, down 2: 180 x 180 cells; FEATURE_MAP_STRIDE 2 asks for 170 x 170
    targets on the 341 map. `synthetic.bevfusion_grid` puts all three at
    180, and both packages' BEV backbones then run."""
    from pdm_ssd_torch.models.backbones_2d.base_bev_backbone import BaseBEVBackbone as TBEV
    from pdm_ssd_torch.models.detectors.detector3d import _grid_info as t_grid_info
    from pdm_ssd_torch.models.view_transforms.depth_lss import grid_of
    from pdm_ssd_tpu.models.backbones_2d.base_bev_backbone import BaseBEVBackbone as JBEV
    from pdm_ssd_tpu.models.detectors.detector3d import _grid_info as j_grid_info
    cfg = load_nuscenes_cfg('bevfusion')
    jcfg = JCfgNode(cfg.to_dict())
    vt = cfg.MODEL.VTRANSFORM
    for cfgs, lidar in ((cfg, 341), (synthetic.bevfusion_grid(load_nuscenes_cfg('bevfusion')),
                                     180)):
        (gw, gh, _), _ = t_grid_info(cfgs.DATA_CONFIG)
        assert (gw, gh) == (lidar, lidar)
        camera = grid_of(cfgs.MODEL.VTRANSFORM)[2][:2] // int(vt.DOWNSAMPLE)
        assert tuple(camera) == (180, 180)
        stride = cfgs.MODEL.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.FEATURE_MAP_STRIDE
        assert gw // stride == (170 if lidar == 341 else 180)
        bb = dict(cfgs.MODEL.BACKBONE_2D.to_dict(), NUM_FILTERS=[4, 4],
                  NUM_UPSAMPLE_FILTERS=[4, 4])
        shape = (1, lidar, lidar, 8)
        j_bb = JBEV(model_cfg=JCfgNode(bb), input_channels=8)
        t_bb = TBEV(TCfgNode(bb), 8, device='meta')
        init = lambda: jax.eval_shape(lambda b: j_bb.init(jax.random.PRNGKey(0), b),  # noqa
                                      {'spatial_features': jnp.zeros(shape)})
        t_run = lambda: t_bb({'spatial_features': torch.zeros(shape, device='meta')})  # noqa
        if lidar == 341:
            with pytest.raises(TypeError, match='341, 341.*342, 342'):
                init()
            with pytest.raises(RuntimeError, match='341.*342|342.*341'):
                t_run()
        else:
            init()
            assert t_run()['spatial_features_2d'].shape == (1, 180, 180, 8)
    assert j_grid_info(jcfg.DATA_CONFIG)[0][:2] == (341, 341)
