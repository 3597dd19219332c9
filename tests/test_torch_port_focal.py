"""The focal SECOND (`configs/kitti_models/second_focal.yaml`,
`VoxelBackBone8xFocal`) in the port against the JAX package, on the CPU.

The focal ladder's maps (each focal stage's maximal dilation, the spawn
tables, the strict `> 0` spawn bound, saturation), their transposes, which
only the port builds, the focal split's bits and features, and the tiny
model's forward, importance loss, loss, gradients and three Adam steps.
Inputs come from numpy seeds; the port's sparse convs run their plain
versions here (the kernel is held on the card at these shapes by
`chip_smoke.py` phase 36).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_ssd_torch.models import get_host_prepare
from pdm_ssd_torch.models.backbones_3d import sparse_backbone_focal as t_focal
from pdm_ssd_torch.ops import sparse_maps as t_maps
from pdm_ssd_torch.utils import synthetic
from pdm_ssd_torch.utils.config import cfg_from_yaml_file
from pdm_ssd_torch.utils.weights import from_flax, to_flax
from pdm_ssd_tpu.models import get_host_prepare as j_get_host_prepare
from pdm_ssd_tpu.models.backbones_3d import sparse_backbone_focal as j_focal
from pdm_ssd_tpu.ops import sparse_maps as j_maps
from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_harness import (REPO, ModelPair, assert_close_to_scale, hold_to_jax,
                                jax_train_steps, leaves, port_loss_and_grads, rel_l2)

FOCAL = 'configs/kitti_models/second_focal.yaml'
CLASS_NAMES = ['Car', 'Pedestrian', 'Cyclist']
# the ladder, the focal layers and the head, float32 on both sides
FWD_RTOL = 1e-4
# a loss of one forward, relative
LOSS_RTOL = 1e-5
# gradients, relative L2 per leaf; measured on this batch: 1.1e-5 at a
# BatchNorm scale of the last focal layer
GRAD_REL_L2 = 1e-4
# the focal split's features: the same products, the 26 spawn masks summed
# in another order
SPLIT_ATOL = 1e-5
# parameters after three Adam steps, relative L2 per leaf, as the other
# families' tests hold them
STEP_PARAM_REL_L2 = 1e-3


def load_cfg():
    cwd = os.getcwd()
    os.chdir(REPO)          # the config names its base config relative to the repo
    try:
        return cfg_from_yaml_file(FOCAL)
    finally:
        os.chdir(cwd)


def tiny_cfg():
    return synthetic.tiny_second_focal_cfg(load_cfg())


@pytest.fixture(scope='module')
def pair():
    """The tiny focal SECOND in both packages and a training batch of 2
    LiDAR-like clouds with 8 boxes each, prepared by each package's own
    `get_host_prepare` (the port's adds the transposed maps)."""
    return ModelPair(tiny_cfg(), B=2, N=3000, seed=0, voxels=True, bias_scale=0.1,
                     train_boxes=8)


# ---- the maps ----------------------------------------------------------------------

GRID = (32, 32, 24)      # (W, H, D): stage-1 dims (25, 32, 32), output (1, 4, 4)


def _actives(kind, rng, V=64):
    """(coords (V, 3) zyx in no order, n) of seeded active cells: random,
    clustered, many (the dilated tables saturate), or all on the planes
    z = 0, y = 0 or x = 0 (where no spawn may land)."""
    D, H, W = j_maps.ladder_shapes(GRID)[0]
    n = {'random': 50, 'clustered': 60, 'saturating': 64, 'zero planes': 40, 'empty': 0}[kind]
    if kind == 'clustered':
        base = rng.randint(0, [D - 3, H - 4, W - 4], (6, 3))
        c = (base[:, None] + rng.randint(0, [3, 4, 4], (1, 30, 3))).reshape(-1, 3)
        flat = np.unique((c[:, 0] * H + c[:, 1]) * W + c[:, 2])[:n]
    elif kind == 'zero planes':
        c = rng.randint(0, [D, H, W], (n, 3))
        c[np.arange(n), rng.randint(0, 3, n)] = 0
        flat = np.unique((c[:, 0] * H + c[:, 1]) * W + c[:, 2])
    else:
        flat = rng.choice(D * H * W, n, replace=False)
    c = np.stack([flat // (H * W), (flat // W) % H, flat % W], -1)[rng.permutation(len(flat))]
    coords = np.zeros((V, 3), np.int32)
    coords[:len(c)] = c
    return coords, len(c)


CAPS = {'saturating': ([64, 96, 64, 48, 40], [300, 200, 150])}
DEFAULT_CAPS = ([64, 128, 96, 64, 64], [512, 768, 512])


@pytest.mark.parametrize('kind', ['random', 'clustered', 'saturating', 'zero planes', 'empty'])
def test_focal_maps_equal_the_jax_package(kind):
    """`build_focal_ladder_maps` equals the JAX package's integer for integer
    (the stable `fl_perm1`, each stage's candidate and dilated tables, the
    spawn tables with their strict `> 0` bound, the stages below built from
    the dilated tables); saturated tables keep every base site and cut the
    spawn candidates in flat-key order."""
    coords, n = _actives(kind, np.random.RandomState(7))
    caps, ecaps = CAPS.get(kind, DEFAULT_CAPS)
    want = j_maps.build_focal_ladder_maps(coords, n, GRID, caps, ecaps)
    got = t_maps.build_focal_ladder_maps(torch.from_numpy(coords), n, GRID, caps, ecaps)
    assert set(got) == set(want) == set(t_maps.FOCAL_KEYS)
    for k in t_maps.FOCAL_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]).astype(
            got[k].numpy().dtype), err_msg=k)
    e1 = got['fl_emask1'].numpy()
    if kind == 'saturating':
        assert e1.all()                       # the dilated table is full
        orig = got['fl_eorig1'].numpy()
        assert np.array_equal(np.sort(orig[orig < caps[0]]), np.arange(n))   # every site kept
    if kind == 'zero planes':
        ec = got['fl_ecoords1'].numpy()
        on_plane = (ec.min(-1) == 0) & e1
        assert on_plane.any() and (got['fl_espawn1'].numpy()[on_plane] == caps[0]).all()


def _brute_inverse(down: np.ndarray, cap_in: int) -> np.ndarray:
    cap_out, K = down.shape
    up = np.full((cap_in, K), cap_out, np.int32)
    for i in range(cap_out):
        for k in range(K):
            if down[i, k] < cap_in:
                up[down[i, k], K - 1 - k] = i
    return up


def test_transposed_focal_maps_equal_a_brute_force_inverse():
    """The training prepare's `fl_upmap{2,3,4}` and `fl_upmap_out`: the
    transpose of each strided map over its input table (the dilated tables
    of stages 1 to 3, stage 4's candidates), held against a loop."""
    coords, mask = [], []
    for seed in (1, 2):
        c, n = _actives('clustered', np.random.RandomState(seed))
        coords.append(c)
        mask.append(np.arange(len(c)) < n)
    caps, ecaps = DEFAULT_CAPS
    maps = t_maps.batch_build_focal(torch.from_numpy(np.stack(coords)),
                                    torch.from_numpy(np.stack(mask)), GRID, caps, ecaps)
    up = t_maps.batch_invert_focal(maps, caps, ecaps)
    assert set(up) == set(t_maps.FOCAL_UPMAP_KEYS)
    for key, down, cap_in in (('fl_upmap2', 'fl_downmap2', ecaps[0]),
                              ('fl_upmap3', 'fl_downmap3', ecaps[1]),
                              ('fl_upmap4', 'fl_downmap4', ecaps[2]),
                              ('fl_upmap_out', 'fl_outmap', caps[3])):
        for b in range(2):
            want = _brute_inverse(maps[down][b].numpy(), cap_in)
            np.testing.assert_array_equal(up[key][b].numpy(), want, err_msg=f'{key} {b}')
            assert (want < maps[down].shape[1]).any()


def test_get_host_prepare_equals_the_jax_package_and_adds_the_transposes():
    """The focal prepare with the JAX package's default capacities (the tiny
    config names none): every JAX tensor equal; in training the port adds
    the four transposed maps."""
    cfg = tiny_cfg()
    raw = synthetic.voxel_train_batch(2, 3000, cfg, 8, seed=3)
    jcfg = JCfgNode(cfg.to_dict())
    want = j_get_host_prepare(jcfg.MODEL, jcfg.DATA_CONFIG)({k: v.numpy() for k, v in raw.items()})
    for training in (False, True):
        got = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG, training=training)(raw)
        assert set(got) == set(want) | (set(t_maps.FOCAL_UPMAP_KEYS) if training else set())
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]).astype(
                got[k].numpy().dtype), err_msg=k)
    assert [got[f'fl_emask{s}'].shape[1] for s in (1, 2, 3)] == [1024, 2048, 1536]


# ---- the focal split ---------------------------------------------------------------

@pytest.mark.parametrize('topk,mask_multi,skip', [(True, False, False), (False, False, False),
                                                   (True, True, False), (True, False, True)])
def test_focal_split_matches_jax(topk, mask_multi, skip):
    """`focal_split` on the same inputs: the activation bits exact (the
    stable top-k rank of the voxels' own masks, the spawn bits), the
    features within SPLIT_ATOL, zero where a bit is off."""
    rng = np.random.RandomState(11)
    dims = (6, 7, 8)
    B, cap, cap_e, C = 2, 36, 600, 5
    eorig, espawn, emask, act = [], [], [], []
    for b in range(B):
        n = 30 - 4 * b
        flat = np.sort(rng.choice(np.prod(dims), n, replace=False))
        c = np.zeros((cap, 3), np.int32)
        c[:n] = np.stack([flat // 56, (flat // 8) % 7, flat % 8], -1)
        _, ne, eo, es = j_maps._dilate_table(c, n, dims, cap_e)
        eorig.append(eo)
        espawn.append(es)
        emask.append(np.arange(cap_e) < ne)
        act.append(np.arange(cap) < n)
    x = rng.normal(size=(B, cap, C)).astype(np.float32)
    imps = (rng.normal(size=(B, cap, 27)) * 2).astype(np.float32)
    imps[0, 3, 26] = imps[0, 4, 26]           # an exact tie of two voxels' own masks
    args = [np.stack(a) for a in (act, eorig, espawn, emask)]
    kw = dict(topk=topk, threshold=0.5, mask_multi=mask_multi, skip_mask_kernel=skip)
    jf, jb = j_focal.focal_split(jnp.asarray(x), jnp.asarray(args[0]), jnp.asarray(imps),
                                 *(jnp.asarray(a) for a in args[1:]), **kw)
    tf, tb = t_focal.focal_split(torch.from_numpy(x), torch.from_numpy(args[0]),
                                 torch.from_numpy(imps), *(torch.from_numpy(a) for a in args[1:]),
                                 **kw)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=SPLIT_ATOL, rtol=0)
    assert tb.numpy().sum() > args[0].sum()    # spawns landed


# ---- the model ---------------------------------------------------------------------

def test_weights_round_trip(pair):
    """`from_flax` reaches every leaf, `conv_imp` as the Dense kernel flax
    stores ((27 * Cin, 27), not transposed); `to_flax` gives the tree back."""
    back = to_flax(pair.net)
    for kind in ('params', 'batch_stats'):
        want, got = dict(leaves(pair.variables[kind])), dict(leaves(back[kind]))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    params = dict(leaves(pair.variables['params']))
    for s, ch in zip((1, 2, 3), (4, 8, 8)):
        assert params[f'module_list_1/focal{s}/conv_imp/kernel'].shape == (27 * ch, 27)
    np.testing.assert_array_equal(pair.net.backbone_3d.focal2.conv_imp.kernel.detach().numpy(),
                                  params['module_list_1/focal2/conv_imp/kernel'])


def test_forward_matches_jax(pair):
    """The eval-mode forward: each focal stage's activation bits exact, its
    features, the BEV map and the head's outputs within FWD_RTOL of scale."""
    with torch.inference_mode():
        got = pair.net(pair.torch_inputs())
    want = pair.jax_out
    for s in (1, 2, 3):
        g, w = got['multi_scale_3d_features_sparse'][f'x_conv{s}'], \
            want['multi_scale_3d_features_sparse'][f'x_conv{s}']
        np.testing.assert_array_equal(g[2].numpy(), w[2], err_msg=f'bits of stage {s}')
        assert_close_to_scale(g[0].numpy(), w[0], FWD_RTOL, f'x_conv{s}')
    for k in ('spatial_features', 'spatial_features_2d', 'anchor_cls_preds', 'anchor_box_preds',
              'anchor_dir_preds'):
        assert_close_to_scale(got[k].numpy(), want[k], FWD_RTOL, k)
    assert float(got['loss_box_of_pts']) == 0.0 == float(want['loss_box_of_pts'])


def test_training_loss_and_gradients_match_jax(pair):
    """`forward_with_loss` in training mode: every loss term, the focal
    importance loss ('loss_box_of_pts') included, within LOSS_RTOL; every
    gradient within GRAD_REL_L2 relative L2 (or held to the JAX package's
    float64 run where its float32 strays), the importance convs' included."""
    loss, tb, grads, stats = port_loss_and_grads(pair, pair.torch_inputs())
    j_loss, j_tb, j_grads, j_stats = pair.jax_loss_and_grads()
    assert set(tb) == set(j_tb) and 'loss_box_of_pts' in tb and tb['loss_box_of_pts'] > 0
    for k, v in tb.items():
        np.testing.assert_allclose(v, float(j_tb[k]), rtol=LOSS_RTOL, err_msg=k)
    hold_to_jax(grads, j_grads, lambda: pair.jax_f64_loss_and_grads()[1], GRAD_REL_L2,
                jax_rtol=1e-2, max_apart=2)
    g = dict(leaves(grads))
    assert all(np.abs(g[f'module_list_1/focal{s}/conv_imp/kernel']).max() > 0 for s in (1, 2, 3))
    for k, v in leaves(stats):
        assert rel_l2(v, dict(leaves(j_stats))[k]) <= GRAD_REL_L2, k


def test_three_train_steps_track_jax(pair):
    """Three steps of each package's train step from the same state on one
    batch: each step's loss within 1e-3 and every leaf of parameters and
    BatchNorm statistics within STEP_PARAM_REL_L2."""
    from pdm_ssd_torch.runtime.trainer import create_train_state, make_train_step
    j_losses, j_params, j_stats = jax_train_steps(pair, 3)
    net = pair.net
    net.load_state_dict(from_flax(pair.variables, net))
    optimizer, _ = create_train_state(net, pair.cfg.OPTIMIZATION, 10, 2)
    t_step = make_train_step(net, optimizer)
    try:
        for j_loss in j_losses:
            t_metrics = t_step(pair.torch_inputs())
            np.testing.assert_allclose(float(t_metrics['loss']), j_loss, rtol=1e-3)
        got = to_flax(net)
    finally:
        net.load_state_dict(from_flax(pair.variables, net))
        net.eval()
    for kind, tree in (('params', j_params), ('batch_stats', j_stats)):
        want = dict(leaves(tree))
        for k, g in leaves(got[kind]):
            assert rel_l2(g, want[k]) <= STEP_PARAM_REL_L2, f'{kind}/{k}'


def test_shipped_config_builds_at_full_width():
    """`second_focal.yaml` as shipped builds on the meta device with the
    shipped widths: 27 importance logits per voxel at each focal stage, the
    256-channel BEV input."""
    from pdm_ssd_torch.models import build_network
    cfg = load_cfg()
    net = build_network(cfg.MODEL, 3, cfg.DATA_CONFIG, device='meta')
    bb = net.backbone_3d
    assert [tuple(getattr(bb, f'focal{s}').conv_imp.kernel.shape) for s in (1, 2, 3)] == [
        (27 * 16, 27), (27 * 32, 27), (27 * 64, 27)]
    assert bb.num_bev_features == 256 and bb.shapes[4] == (2, 200, 176)


def test_dry_run_of_the_tiny_focal_second():
    from pdm_ssd_torch.tools import dryrun
    assert np.isfinite(dryrun.dryrun('cpu', cfg_file=FOCAL))     # a train step, then predict
