"""The pillar family of `Detector3D` in the port against the JAX package, on
the CPU: `PillarVFE`, `PointPillarScatter`, and the tiny shrinks of
`pointpillar.yaml` (`synthetic.tiny_pointpillar_cfg`: PillarVFE, the
scatter, the three-level BEV backbone, the anchor head),
`centerpoint_pillar.yaml` (`tiny_centerpoint_pillar_cfg`:
DynamicPillarVFE, CenterHead, circle NMS) and `pillarnet.yaml`
(`tiny_pillarnet_cfg`: GridPointBackbone, CenterHead at stride 4), each
built in both packages with one set of randomized weights carried by
`from_flax`. Inputs come from numpy seeds; both packages run float32; JAX
runs jitted. Each tolerance stands beside its reason.
"""
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_ssd_torch.models.backbones_2d.map_to_bev import PointPillarScatter
from pdm_ssd_torch.models.backbones_3d.vfe import PillarVFE
from pdm_ssd_torch.utils import synthetic
from pdm_ssd_torch.utils.config import CfgNode as TCfgNode
from pdm_ssd_torch.utils.weights import from_flax, to_flax
from pdm_ssd_tpu.models.backbones_2d import map_to_bev as j_m2b
from pdm_ssd_tpu.models.backbones_3d import vfe as j_vfe
from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_harness import (ModelPair, assert_close_to_scale, hold_to_jax,
                                leaves, load_cfg, match_detections,
                                open_score_gate_flax, port_loss_and_grads,
                                randomize_variables, rel_l2, to_numpy)

CLASS_NAMES = ['Car', 'Pedestrian', 'Cyclist']
# a module or model fed the same inputs: float32 sums in another order only
MODULE_RTOL = 1e-4
# the losses of one batch: float32 sums in another order
LOSS_RTOL = 1e-5
# per-leaf gradients, relative L2: float32 rounding of the backward's sums
GRAD_REL_L2 = 1e-4
# ... except at the few leaves where the JAX package's own float32 value
# lies further than that from its float64 one (`hold_to_jax`): there the
# port's float32 value is held to the bound above of the JAX package's
# float64 one, and the JAX package's float32 to these. Measured on the tiny
# PillarNet's batch: the six leaves of its first grid level, the JAX
# package's gradients up to 1.1e-3 from its float64, the port's float32
# within 3.5e-5 of it (the port's float64 within 7.1e-7: the JAX package
# sums the cells' points in float32 even then). At most twice as many
# leaves may be held so (another CPU may sum in another order)
JAX_F32_LOSS_RTOL = 3e-4
JAX_F32_GRAD_REL_L2 = 3e-3
MAX_APART = 12
# BatchNorm running statistics after one training step, relative L2 per
# leaf: the batch statistics of the same activations, summed in another order
STATS_REL_L2 = 1e-5
# a detection of one package is the other's when its box agrees to this
# (metres, radians) and its label is the same
BOX_ATOL = 1e-3

TINY = {'pointpillar': synthetic.tiny_pointpillar_cfg,
        'centerpoint_pillar': synthetic.tiny_centerpoint_pillar_cfg,
        'pillarnet': synthetic.tiny_pillarnet_cfg}
CONFIGS = list(TINY)


def tiny(name):
    return TINY[name](load_cfg(name))


@pytest.fixture(scope='module')
def pairs():
    """Each tiny config in both packages, built on first use: the voxel
    model on a training batch of LiDAR-like clouds (8 boxes a cloud), the
    point models on uniform KITTI-range clouds with their boxes."""
    built = {}

    def get(name):
        if name not in built:
            if name == 'pointpillar':
                built[name] = ModelPair(tiny(name), B=2, N=3000, seed=0, voxels=True,
                                        bias_scale=0.1, train_boxes=8)
            else:       # the shipped configs' points per cell: 16384 on 704 x 800
                N = 4096 if name == 'pillarnet' else 1024
                built[name] = ModelPair(tiny(name), B=2, N=N, seed=1, bias_scale=0.1)
        return built[name]
    return get


def train_batch(pair) -> dict:
    return pair.torch_inputs() if 'voxels' in pair.inputs else pair.torch_batch()


# ---- PillarVFE and the scatter ----------------------------------------------------

def _pillars(seed, B=2, V=40, P=6):
    """Pillars of 0 to P points on a 0.16 m grid, out-of-range coords, the
    padded points filled with garbage (the VFE must zero them)."""
    rng = np.random.RandomState(seed)
    coords = np.stack([np.zeros((B, V)), rng.randint(0, 50, (B, V)), rng.randint(0, 40, (B, V))],
                      -1).astype(np.int32)
    num = rng.randint(0, P + 1, (B, V)).astype(np.int32)
    num[:, :3] = [0, 1, P]
    centers = (coords[..., ::-1] + 0.5) * np.float32([0.16, 0.16, 4.0]) + np.float32(
        [0, -39.68, -3])
    voxels = np.concatenate([centers[:, :, None, :] + rng.uniform(-0.08, 0.08, (B, V, P, 3)),
                             rng.rand(B, V, P, 1)], -1).astype(np.float32)
    pad = np.arange(P)[None, None] >= num[..., None]
    voxels[pad] = rng.randn(int(pad.sum()), 4) * 50
    return {'voxels': voxels, 'voxel_num_points': num, 'voxel_coords': coords}


@pytest.mark.parametrize('opts', [{}, {'USE_ABSLOTE_XYZ': False, 'WITH_DISTANCE': True,
                                       'NUM_FILTERS': [8, 16]}])
def test_pillar_vfe_matches_jax(opts):
    """Eval forward within MODULE_RTOL of scale; in training mode the same
    output and running statistics within STATS_REL_L2: flax's BatchNorm takes
    them over all B * V * P rows, the zeroed padded points included (the
    statistics of the valid points alone differ by far more)."""
    cfg = {'NAME': 'PillarVFE', 'USE_NORM': True, 'NUM_FILTERS': [16], **opts}
    voxel, pc = (0.16, 0.16, 4.0), (0.0, -39.68, -3.0, 69.12, 39.68, 1.0)
    batch = _pillars(seed=3)
    j_mod = j_vfe.PillarVFE(model_cfg=JCfgNode(cfg), num_point_features=4, voxel_size=voxel,
                            point_cloud_range=pc)
    variables = randomize_variables(jax.jit(j_mod.init)(jax.random.PRNGKey(0), dict(batch)), 4)
    want = np.asarray(jax.jit(j_mod.apply)(variables, dict(batch))['pillar_features'])
    (j_train, mutated) = jax.jit(lambda v, b: j_mod.apply(v, b, training=True,
                                                          mutable=['batch_stats']))(
        variables, dict(batch))
    port = PillarVFE(TCfgNode(cfg), 4, voxel, pc).eval()
    port.load_state_dict(from_flax(variables, port))
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    seen = []
    port.pfn_0.register_forward_hook(lambda m, inp, out: seen.append(out))
    with torch.no_grad():
        got = port(dict(t_batch))['pillar_features'].numpy()
        port.train()
        got_train = port(dict(t_batch))['pillar_features'].numpy()
    assert_close_to_scale(got, want, MODULE_RTOL, 'eval')
    assert not got[:, 0].any() and (got[:, 1:] != 0).any()          # an empty pillar pools to 0
    assert_close_to_scale(got_train, np.asarray(j_train['pillar_features']), MODULE_RTOL, 'train')
    want_stats = dict(leaves(to_numpy(mutated['batch_stats'])))
    got_stats = dict(leaves(to_flax(port)['batch_stats']))
    assert set(got_stats) == set(want_stats)
    for k in want_stats:
        assert rel_l2(got_stats[k], want_stats[k]) <= STATS_REL_L2, k
    # the batch mean behind flax's update, against the first layer's output
    # averaged over every row and over the valid points alone
    old = dict(leaves(variables['batch_stats']))['pfn_bn_0/mean']
    batch_mean = (want_stats['pfn_bn_0/mean'] - 0.99 * old) / 0.01
    out = seen[-1]
    valid = torch.arange(6) < t_batch['voxel_num_points'][..., None]
    assert_close_to_scale(out.reshape(-1, out.shape[-1]).mean(0).numpy(), batch_mean, 1e-3,
                          'mean over all rows')
    assert np.abs(out[valid].mean(0).numpy() - batch_mean).max() > 0.1 * np.abs(batch_mean).max()


def test_point_pillar_scatter_matches_jax_exactly():
    """Canvas cells exact: valid pillars land in their cell, pillars out of
    the grid or masked out add nothing."""
    rng = np.random.RandomState(5)
    B, V, C, W, H = 2, 60, 5, 12, 9
    coords = np.stack([np.zeros((B, V)), rng.randint(-2, H + 2, (B, V)),
                       rng.randint(-2, W + 2, (B, V))], -1).astype(np.int32)
    for b in range(B):                                           # distinct cells per cloud
        _, first = np.unique(coords[b, :, 1] * 100 + coords[b, :, 2], return_index=True)
        keep = np.zeros(V, bool)
        keep[first] = True
        coords[b, ~keep] = [0, -1, -1]
    feats = rng.randn(B, V, C).astype(np.float32)
    mask = rng.rand(B, V) > 0.2
    batch = {'pillar_features': feats, 'voxel_coords': coords, 'voxel_mask': mask}
    j_mod = j_m2b.PointPillarScatter(model_cfg=JCfgNode({'NUM_BEV_FEATURES': C}),
                                     grid_size=(W, H))
    want = np.asarray(j_mod.apply({}, dict(batch))['spatial_features'])
    got = PointPillarScatter(TCfgNode({'NUM_BEV_FEATURES': C}), (W, H))(
        {k: torch.from_numpy(v) for k, v in batch.items()})['spatial_features'].numpy()
    assert got.shape == want.shape == (B, H, W, C)
    np.testing.assert_array_equal(got, want)
    filled = (want != 0).any(-1).sum()
    inside = ((coords[..., 1] >= 0) & (coords[..., 1] < H) & (coords[..., 2] >= 0)
              & (coords[..., 2] < W) & mask).sum()
    assert filled == inside > 20


# ---- the three tiny models ----------------------------------------------------------

@pytest.mark.parametrize('name', CONFIGS)
def test_weights_round_trip(name, pairs):
    """`from_flax` reaches every tensor; `to_flax(from_flax(v)) == v`."""
    pair = pairs(name)
    n_leaves = sum(a.size for tree in pair.variables.values() for _, a in leaves(tree))
    n_port = sum(t.numel() for k, t in pair.net.state_dict().items()
                 if not k.endswith('num_batches_tracked'))
    assert n_leaves == n_port
    back = to_flax(pair.net)
    for kind in ('params', 'batch_stats'):
        want, got = dict(leaves(pair.variables[kind])), dict(leaves(back[kind]))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


FORWARD_KEYS = {'pointpillar': ('pillar_features', 'spatial_features', 'spatial_features_2d',
                                'anchor_cls_preds', 'anchor_box_preds', 'anchor_dir_preds'),
                'centerpoint_pillar': ('spatial_features', 'spatial_features_2d'),
                'pillarnet': ('spatial_features', 'spatial_features_2d')}


@pytest.mark.parametrize('name', CONFIGS)
def test_forward_matches_jax(name, pairs):
    pair = pairs(name)
    J = pair.jax_out
    with torch.no_grad():
        T = to_numpy(pair.net(pair.torch_inputs()))
    for k in FORWARD_KEYS[name]:
        assert_close_to_scale(T[k], J[k], MODULE_RTOL, k)
    if name == 'centerpoint_pillar':         # DynamicPillarVFE's canvas at stride 1
        assert T['spatial_features'].shape == (2, 100, 88, 7)
    if name == 'pillarnet':
        for k in range(4):
            assert_close_to_scale(T['multi_scale_bev'][k], J['multi_scale_bev'][k], MODULE_RTOL,
                                  f'multi_scale_bev[{k}]')
    for k, want in J.get('center_head_preds', [{}])[0].items():
        assert_close_to_scale(T['center_head_preds'][0][k], want, MODULE_RTOL, k)


@pytest.mark.parametrize('name', CONFIGS)
def test_training_loss_gradients_and_statistics_match_jax(name, pairs):
    """The training-mode loss and each term within LOSS_RTOL, every
    parameter's gradient within GRAD_REL_L2 relative L2 (or, at a few
    leaves, as `hold_to_jax` holds them), and every running statistic
    after the step within STATS_REL_L2."""
    pair = pairs(name)
    batch = train_batch(pair)
    _, tb, grads, stats = port_loss_and_grads(pair, batch)
    _, j_tb, j_grads, j_stats = pair.jax_loss_and_grads()
    exact = functools.lru_cache(pair.jax_f64_loss_and_grads)
    hold_to_jax(tb, j_tb, lambda: exact()[0], LOSS_RTOL, JAX_F32_LOSS_RTOL, len(tb))
    hold_to_jax(grads, j_grads, lambda: exact()[1], GRAD_REL_L2, JAX_F32_GRAD_REL_L2, MAX_APART)
    want, got = dict(leaves(j_stats)), dict(leaves(stats))
    assert set(got) == set(want) and len(want) > 10
    worst = max((rel_l2(got[k], want[k]), k) for k in want)
    assert worst[0] <= STATS_REL_L2, f'{worst[1]}: relative L2 {worst[0]:.3e}'


@pytest.mark.parametrize('name', CONFIGS)
def test_predict_matches_jax(name, pairs):
    """`predict` with the classification bias at 0 in both packages
    (`synthetic.open_score_gate`): the same number of boxes kept per cloud,
    matched by box and label."""
    pair = pairs(name)
    gated = open_score_gate_flax(pair.variables)
    want = to_numpy(jax.jit(lambda v, b: pair.jax_model.apply(v, b, method=pair.jax_model.predict))(
        gated, pair.inputs))
    net = pair.net
    net.load_state_dict(from_flax(gated, net))
    try:
        got = net.predict(pair.torch_inputs())
    finally:
        net.load_state_dict(from_flax(pair.variables, net))
    assert match_detections(got, want, BOX_ATOL) > 4


# ---- the eval loop on a mini set ---------------------------------------------------------

def test_eval_loop_matches_jax(pairs, tmp_path):
    """`eval_one_epoch` of the tiny `pointpillar.yaml` through both packages'
    voxel data paths (the JAX package's numpy voxelizer, which keeps the
    port's key order) with one set of weights, the score gate open: the
    same detections per frame matched by box and class, recall and every AP
    R40 entry within 1e-4."""
    from pdm_ssd_torch.datasets import build_dataloader as t_build_dataloader
    from pdm_ssd_torch.datasets.kitti import kitti_dataset as t_kitti
    from pdm_ssd_torch.datasets.kitti import synthetic as t_syn
    from pdm_ssd_torch.runtime import eval_utils as t_eval_utils
    from pdm_ssd_tpu.datasets import build_dataloader as j_build_dataloader
    from pdm_ssd_tpu.datasets.kitti import kitti_dataset as j_kitti
    from pdm_ssd_tpu.datasets.kitti import synthetic as j_syn
    from pdm_ssd_tpu.datasets.processor.data_processor import DataProcessor as JProcessor
    from pdm_ssd_tpu.runtime import eval_utils as j_eval_utils
    t_root, j_root = tmp_path / 'port', tmp_path / 'jax'
    cfg = tiny('pointpillar')
    # every pillar of the 32 x 32 grid fits: no cap cuts the clouds
    cfg.DATA_CONFIG.DATA_PROCESSOR[-1].MAX_NUMBER_OF_VOXELS = {'train': 1024, 'test': 1024}
    t_syn.make_mini_kitti(t_root)
    j_syn.make_mini_kitti(j_root)
    t_cfg = TCfgNode(cfg.DATA_CONFIG.to_dict())
    t_cfg.DATA_PATH = str(t_root)
    j_cfg = JCfgNode(cfg.DATA_CONFIG.to_dict())
    j_cfg.DATA_PATH = str(j_root)
    t_kitti.create_kitti_infos(t_cfg, CLASS_NAMES, t_root, t_root, workers=1)
    j_kitti.create_kitti_infos(j_cfg, CLASS_NAMES, j_root, j_root, workers=1)
    pair = pairs('pointpillar')             # the voxel cap changes the data, not the model
    gated = open_score_gate_flax(pair.variables)
    pair.net.load_state_dict(from_flax(gated, pair.net))
    t_set, t_loader, _ = t_build_dataloader(t_cfg, CLASS_NAMES, batch_size=2, root_path=t_root,
                                            workers=0, training=False)
    j_set, j_loader, _ = j_build_dataloader(j_cfg, CLASS_NAMES, batch_size=2, root_path=j_root,
                                            workers=0, training=False)
    try:
        got = t_eval_utils.eval_one_epoch(pair.net, t_loader, t_set, CLASS_NAMES, device='cpu',
                                          result_dir=tmp_path / 'out_port')
    finally:
        pair.net.load_state_dict(from_flax(pair.variables, pair.net))
    variables = jax.tree_util.tree_map(jnp.asarray, gated)
    (tmp_path / 'out_jax' / 'final_result' / 'data').mkdir(parents=True)
    native = JProcessor._native_voxelize
    JProcessor._native_voxelize = lambda *args: None
    try:
        want = j_eval_utils.eval_one_epoch(pair.jax_model, variables['params'],
                                           variables['batch_stats'], j_loader, j_set,
                                           CLASS_NAMES, result_dir=tmp_path / 'out_jax')
    finally:
        JProcessor._native_voxelize = native
    t_annos = pickle.loads((tmp_path / 'out_port' / 'result.pkl').read_bytes())
    j_annos = pickle.loads((tmp_path / 'out_jax' / 'result.pkl').read_bytes())
    assert [a['frame_id'] for a in t_annos] == [a['frame_id'] for a in j_annos]
    assert all(len(a['name']) > 0 for a in t_annos)
    for t, j in zip(t_annos, j_annos):
        assert len(t['name']) == len(j['name']), t['frame_id']
        free = np.ones(len(j['name']), bool)
        for i in range(len(t['name'])):
            d = np.abs(j['boxes_lidar'] - t['boxes_lidar'][i]).max(1)
            d = np.where(free & (j['name'] == t['name'][i]), d, np.inf)
            k = int(np.argmin(d))
            assert d[k] <= BOX_ATOL, (t['frame_id'], i, d[k])
            free[k] = False
    metrics = [k for k in want if k.startswith('recall/') or 'R40' in k]
    assert len(metrics) >= 3 + 3 * 4 * 3
    for k in metrics:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
