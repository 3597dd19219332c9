"""VoxelNeXt (`configs/kitti_models/voxelnext.yaml`) in the port against the
JAX package, on the CPU.

The BEV slot table of the ladder's output (`sparse_maps.build_bev_maps`),
the head's forward (`VoxelNeXtHead`: sparse height compression, 9-tap
submanifold convs over the BEV slots), its targets, losses, gradients and
decode, and the train and eval loops. Inputs come from numpy seeds; the
port's sparse convs run their plain versions here (the kernel is held on the
card at these shapes by `chip_smoke.py` phase 36).
"""
import os

import jax
import numpy as np
import pytest
import torch

from pdm_ssd_torch.models import build_network, get_host_prepare
from pdm_ssd_torch.models.dense_heads.voxelnext_head import VoxelNeXtHead
from pdm_ssd_torch.ops import sparse_maps as t_maps
from pdm_ssd_torch.utils import synthetic
from pdm_ssd_torch.utils.config import cfg_from_yaml_file
from pdm_ssd_torch.utils.weights import from_flax, to_flax
from pdm_ssd_tpu.models import build_network as j_build_network
from pdm_ssd_tpu.models import get_host_prepare as j_get_host_prepare
from pdm_ssd_tpu.models.dense_heads.voxelnext_head import VoxelNeXtHead as JVoxelNeXtHead
from pdm_ssd_tpu.ops import sparse_maps as j_maps
from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_harness import (REPO, ModelPair, assert_close_to_scale, hold_to_jax, leaves,
                                match_detections, open_score_gate_flax, port_loss_and_grads,
                                rel_l2, to_numpy)

VOXELNEXT = 'configs/kitti_models/voxelnext.yaml'
CLASS_NAMES = ['Car', 'Pedestrian', 'Cyclist']
# the ladder, the BEV layers and the head, float32 on both sides: sums in
# another order
FWD_RTOL = 1e-4
# a loss of one forward, relative
LOSS_RTOL = 1e-5
# gradients, relative L2 per leaf; measured on this batch: 3.2e-6
GRAD_REL_L2 = 1e-4
# box targets: the same float32 arithmetic on the same boxes
BOX_TARGET_ATOL = 1e-5


def load_cfg():
    cwd = os.getcwd()
    os.chdir(REPO)          # the config names its base config relative to the repo
    try:
        return cfg_from_yaml_file(VOXELNEXT)
    finally:
        os.chdir(cwd)


def tiny_cfg():
    return synthetic.tiny_voxelnext_cfg(load_cfg())


def jax_model(cfg):
    """The JAX package's model, given the class names as its training CLI
    gives them (its head maps CLASS_NAMES_EACH_HEAD through them)."""
    jcfg = JCfgNode(cfg.to_dict())
    return j_build_network(jcfg.MODEL, num_class=3, dataset_cfg=jcfg.DATA_CONFIG,
                           class_names=CLASS_NAMES)


@pytest.fixture(scope='module')
def pair():
    """The tiny VoxelNeXt in both packages and a training batch of 2
    LiDAR-like clouds with 8 boxes each, prepared for training by each
    package (the ladder's transposed maps and the BEV slot table)."""
    cfg = tiny_cfg()
    return ModelPair(cfg, B=2, N=3000, seed=0, jax_model=jax_model(cfg), voxels=True,
                     bias_scale=0.1, train_boxes=8)


# ---- the BEV slot table ------------------------------------------------------------

def _out_sites(kind, rng, dims=(2, 10, 12), cap=64):
    """(coords (cap, 3) zyx sorted by flat key, n): distinct output sites."""
    D, H, W = dims
    n = {'random': 40, 'saturating': cap, 'one cell': 2, 'empty cloud': 0}[kind]
    if kind == 'one cell':      # both z of one (y, x) cell
        flat = np.array([3 * W + 4, H * W + 3 * W + 4])
    else:
        flat = np.sort(rng.choice(D * H * W, n, replace=False))
    c = np.zeros((cap, 3), np.int32)
    c[:len(flat)] = np.stack([flat // (H * W), (flat // W) % H, flat % W], -1)
    return c, len(flat)


@pytest.mark.parametrize('kind', ['random', 'saturating', 'one cell', 'empty cloud'])
def test_bev_maps_equal_the_jax_package(kind):
    """`build_bev_maps` equals the JAX package's builder integer for integer:
    slots in y*W + x order, `cap` where absent, the 3x3 map with x inner,
    the out-to-BEV map. On an empty cloud the JAX builder raises (it indexes
    an empty array); the port's table is then all absent."""
    rng = np.random.RandomState(4)
    coords, n = _out_sites(kind, rng, cap=24 if kind == 'saturating' else 64)
    got = {k: v.numpy() for k, v in t_maps.build_bev_maps(torch.from_numpy(coords), n,
                                                          (10, 12)).items()}
    if kind == 'empty cloud':
        cap = len(coords)
        assert not got['sp_bev_mask'].any()
        assert (got['sp_bev_from_out'] == cap).all() and (got['sp_bev_submap'] == cap).all()
        with pytest.raises(IndexError):
            j_maps.build_bev_maps(coords, n, (10, 12))
        return
    want = j_maps.build_bev_maps(coords, n, (10, 12))
    assert set(got) == set(want) == set(t_maps.BEV_KEYS)
    for k in t_maps.BEV_KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    if kind == 'one cell':
        assert got['sp_bev_mask'].sum() == 1 and (got['sp_bev_from_out'][:2] == 0).all()


@pytest.mark.parametrize('training', [False, True])
def test_get_host_prepare_equals_the_jax_package(training):
    """The port's prepare of a voxelized batch (built on the batch's device)
    holds every tensor the JAX package's prepare holds, equal: the ladder's
    maps, in training their transposes, and the BEV slot table."""
    cfg = tiny_cfg()
    raw = (synthetic.voxel_train_batch(2, 3000, cfg, 8, seed=3) if training
           else synthetic.voxel_batch(2, 3000, cfg, seed=3))
    jcfg = JCfgNode(cfg.to_dict())
    want = j_get_host_prepare(jcfg.MODEL, jcfg.DATA_CONFIG, training=training)(
        {k: v.numpy() for k, v in raw.items()})
    got = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG, training=training)(raw)
    assert set(want) <= set(got)
    assert set(t_maps.BEV_KEYS) <= set(want) and ('sp_upmap_out' in got) == training
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]).astype(
            got[k].numpy().dtype), err_msg=k)
    assert int(got['sp_bev_mask'].sum()) > 0


# ---- the model ---------------------------------------------------------------------

def test_weights_round_trip_and_head_names(pair):
    """`from_flax` reaches every leaf (the head's `head_0/{name}_conv0`,
    `{name}_out` and `shared_conv`); `to_flax` gives the tree back."""
    back = to_flax(pair.net)
    for kind in ('params', 'batch_stats'):
        want = dict(leaves(pair.variables[kind]))
        got = dict(leaves(back[kind]))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    head = dict(leaves(pair.variables['params']))
    assert head['dense_head/shared_conv/kernel'].shape == (9 * 8, 8)
    assert head['dense_head/head_0/hm_out/kernel'].shape == (8, 3)
    assert list(pair.net.dense_head.head_0.head_dict) == ['center', 'center_z', 'dim', 'rot',
                                                          'hm']


def test_forward_matches_jax(pair):
    """The eval-mode forward: every branch of the head over the BEV slots
    within FWD_RTOL of its scale."""
    with torch.inference_mode():
        got = pair.net(pair.torch_inputs())
    want = pair.jax_out
    assert got['voxelnext_head_order'] == ['center', 'center_z', 'dim', 'rot']
    for g, w in zip(got['voxelnext_preds'], want['voxelnext_preds']):
        assert set(g) == set(w)
        for k in g:
            assert_close_to_scale(g[k].numpy(), w[k], FWD_RTOL, k)
    x, coords, mask = got['encoded_sparse_out']
    assert_close_to_scale(x.numpy(), want['encoded_sparse_out'][0], FWD_RTOL, 'encoded')
    assert 'spatial_features' not in got       # no reader of the dense BEV map


def _target_case(case, seed=6):
    """(gt_boxes (B, M, 8), gt_mask, bev_coords, bev_mask): the tiny
    config's BEV slots of a prepared batch and seeded boxes; 'ties' puts box
    centres half way between two occupied slots and adds a box of zero
    size and a padded one."""
    cfg = tiny_cfg()
    batch = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG)(synthetic.voxel_batch(2, 3000, cfg,
                                                                               seed=2))
    coords, mask = batch['sp_bev_coords'].numpy(), batch['sp_bev_mask'].numpy()
    gt = synthetic.gt_boxes(2, 8, cfg.DATA_CONFIG.POINT_CLOUD_RANGE, seed)
    gmask = np.ones((2, 8), bool)
    if case == 'ties':
        for b in range(2):
            (y0, x0), (y1, x1) = coords[b, 0], coords[b, 1]
            gt[b, 0, 0] = ((x0 + x1) / 2) * 8 * 0.5 + 0.0     # stride 8, 0.5 m voxels
            gt[b, 0, 1] = ((y0 + y1) / 2) * 8 * 0.5 - 16.0
        gt[0, 1, 3] = 0.0                # no size: zero targets
        gmask[1, 2] = False              # padding
    return gt, gmask, coords, mask


@pytest.mark.parametrize('case', ['random', 'ties'])
def test_assign_targets_match_jax(case):
    """`assign_targets`: 'inds' and 'masks' exact (ties to the first slot),
    heatmaps and box targets within BOX_TARGET_ATOL, a box of no size zero
    targets."""
    cfg = tiny_cfg()
    head_cfg = cfg.MODEL.DENSE_HEAD
    args = dict(point_cloud_range=tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE), voxel_size=(0.5, 0.5))
    j_head = JVoxelNeXtHead(model_cfg=JCfgNode(head_cfg.to_dict()), input_channels=8,
                            num_class=3, class_names=tuple(CLASS_NAMES), **args)
    t_head = VoxelNeXtHead(head_cfg, 8, 3, args['point_cloud_range'], args['voxel_size'],
                           class_names=tuple(CLASS_NAMES), device='meta')
    gt, gmask, coords, mask = _target_case(case)
    want = to_numpy(jax.jit(j_head.assign_targets)(gt, gmask, coords, mask))   # one program
    got = to_numpy(t_head.assign_targets(*(torch.from_numpy(a) for a in (gt, gmask, coords,
                                                                         mask))))
    for g, w in zip(got, want):
        for k in ('inds', 'masks'):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        for k in ('heatmaps', 'target_boxes', 'target_boxes_src'):
            np.testing.assert_allclose(g[k], w[k], atol=BOX_TARGET_ATOL, rtol=0, err_msg=k)
        assert g['heatmaps'].max() == 1.0
    if case == 'ties':
        assert got[0]['masks'][0, 1] == 0 and not got[0]['target_boxes'][0, 1].any()
        assert got[0]['masks'][1, 2] == 0


def test_training_loss_and_gradients_match_jax(pair):
    """`forward_with_loss` in training mode: 'hm_loss', 'loc_loss' and the
    loss within LOSS_RTOL, every parameter's gradient within GRAD_REL_L2
    relative L2 (or, where the JAX package's float32 strays, held to its
    float64 run), the batch statistics after the step within GRAD_REL_L2."""
    loss, tb, grads, stats = port_loss_and_grads(pair, pair.torch_inputs())
    j_loss, j_tb, j_grads, j_stats = pair.jax_loss_and_grads()
    assert set(tb) == set(j_tb) == {'hm_loss', 'loc_loss', 'loss'}
    for k, v in tb.items():
        np.testing.assert_allclose(v, float(j_tb[k]), rtol=LOSS_RTOL, err_msg=k)
    hold_to_jax(grads, j_grads, lambda: pair.jax_f64_loss_and_grads()[1], GRAD_REL_L2,
                jax_rtol=1e-2, max_apart=2)
    for k, v in leaves(stats):
        assert rel_l2(v, dict(leaves(j_stats))[k]) <= GRAD_REL_L2, k
    sparse = [k for k, v in leaves(j_grads) if k.endswith('kernel') and v.shape[0] % 9 == 0
              and 'dense_head' in k and '_out' not in k]
    assert len(sparse) == 6 and all(np.abs(dict(leaves(grads))[k]).max() > 0 for k in sparse)


def test_predict_matches_jax(pair):
    """`predict` (top-K over the BEV slots, the centre limit, circle NMS),
    the heatmap bias at 0 on both sides: detections matched by box and
    label."""
    variables = open_score_gate_flax(pair.variables)
    j_model = pair.jax_model
    want = to_numpy(jax.jit(lambda v, b: j_model.apply(v, b, method=j_model.predict))(
        variables, pair.inputs))
    net = pair.net
    net.load_state_dict(from_flax(variables, net))
    try:
        got = net.predict(pair.torch_inputs())
    finally:
        net.load_state_dict(from_flax(pair.variables, net))
    assert want['pred_mask'].sum() > 8
    assert match_detections(got, want) == want['pred_mask'].sum()


def test_shipped_config_builds_at_full_width_with_every_leaf():
    """`voxelnext.yaml` as shipped: the flax tree's shapes (`jax.eval_shape`)
    land on the port's model, built on the meta device; the head reads the
    ladder's 128 output channels."""
    cfg = load_cfg()
    jm = jax_model(cfg)
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
    co = caps[4]
    spec.update({'sp_coords_out': ((1, co, 3), np.int32), 'sp_mask_out': ((1, co), bool),
                 'sp_outmap': ((1, co, 3), np.int32), 'sp_bev_coords': ((1, co, 2), np.int32),
                 'sp_bev_mask': ((1, co), bool), 'sp_bev_from_out': ((1, co), np.int32),
                 'sp_bev_submap': ((1, co, 9), np.int32)})
    batch = {k: jax.ShapeDtypeStruct(shape, dtype) for k, (shape, dtype) in spec.items()}
    shapes = jax.eval_shape(lambda b: jm.init({'params': jax.random.PRNGKey(0)}, b,
                                              training=False), batch)
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    net = build_network(cfg.MODEL, 3, cfg.DATA_CONFIG, device='meta')
    state = from_flax(variables, net)
    assert len(jax.tree_util.tree_leaves(shapes)) == len(
        [k for k in state if not k.endswith('num_batches_tracked')])
    assert state['dense_head.shared_conv.kernel'].shape == (9 * 128, 64)
    assert state['dense_head.head_0.hm_conv0.kernel'].shape == (9 * 64, 64)


def test_dry_run_of_the_tiny_voxelnext():
    from pdm_ssd_torch.tools import dryrun
    assert np.isfinite(dryrun.dryrun('cpu', cfg_file=VOXELNEXT))   # a train step, then predict


# ---- the loops ---------------------------------------------------------------------

@pytest.fixture(scope='module')
def mini(tmp_path_factory):
    """The port's 3-frame mini set with its infos."""
    from pdm_ssd_torch.datasets.kitti import kitti_dataset, synthetic as t_syn
    root = tmp_path_factory.mktemp('mini_kitti_voxelnext')
    t_syn.make_mini_kitti(root)
    cfg = load_cfg().DATA_CONFIG
    cfg.DATA_PATH = str(root)
    kitti_dataset.create_kitti_infos(cfg, CLASS_NAMES, root, root, workers=1)
    return root


def test_train_and_eval_loops_on_a_small_set(mini, tmp_path):
    """The tiny VoxelNeXt through `train_model` for 2 epochs on the mini set,
    the batches given their maps and transposes per batch: a checkpoint
    each, a resume into a fresh model after the first that restores weights
    and the schedule's iteration exactly, and the second epoch from there
    equal bit for bit to an uninterrupted run; then `eval_one_epoch` with
    finite recall and AP."""
    from pdm_ssd_torch.datasets import build_dataloader
    from pdm_ssd_torch.runtime import eval_utils, trainer
    cfg = tiny_cfg()
    cfg.DATA_CONFIG.DATA_PATH = str(mini)
    train_prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG, training=True)
    _, loader, _ = build_dataloader(cfg.DATA_CONFIG, CLASS_NAMES, 2, root_path=mini, workers=0,
                                    training=True, seed=0)

    def fresh(seed):
        net = build_network(cfg.MODEL, 3, cfg.DATA_CONFIG, device='cpu', seed=seed)
        opt, sched = trainer.create_train_state(net, cfg.OPTIMIZATION, len(loader), 2)
        return net, opt, sched

    def run(net, opt, sched, epochs, ckpt_dir, start=0):
        np.random.seed(start)
        torch.manual_seed(start)
        return trainer.train_model(net, opt, sched, loader, epochs, ckpt_dir=ckpt_dir,
                                   start_epoch=start, host_prepare=train_prepare)

    whole = fresh(0)
    losses = run(*whole, 1, tmp_path / 'whole') + run(*whole, 2, tmp_path / 'whole', start=1)
    net, opt, sched = fresh(0)
    run(net, opt, sched, 1, tmp_path / 'cut')
    resumed, r_opt, r_sched = fresh(5)
    assert trainer.resume(tmp_path / 'cut', resumed, r_opt) == 1 and r_opt.count == opt.count
    for p, q in zip(net.parameters(), resumed.parameters()):
        assert torch.equal(p, q)
    run(resumed, r_opt, r_sched, 2, tmp_path / 'cut', start=1)
    assert len(losses) == 2 and all(np.isfinite(losses))
    for p, q in zip(whole[0].parameters(), resumed.parameters()):
        assert torch.equal(p, q)
    vds, vloader, _ = build_dataloader(cfg.DATA_CONFIG, CLASS_NAMES, 2, root_path=mini,
                                       workers=0, training=False)
    np.random.seed(0)
    ret = eval_utils.eval_one_epoch(resumed, vloader, vds, CLASS_NAMES, device='cpu',
                                    host_prepare=get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG))
    assert np.isfinite(ret['recall/rcnn_0.3']) and np.isfinite(ret['Car_3d/moderate_R40'])
    assert ret['infer_fps'] > 0
