"""The nuScenes half of the PDM family in the port against the JAX package,
on the CPU: the generated mini set (tables, sweeps, infos), the dataset's
samples (multi-sweep, CBGS, the velocity columns) and batches, the
devkit-free nuScenes evaluator, the tiny `pdm_ssd_nuscenes.yaml`
(`synthetic.tiny_nuscenes_cfg`: forward, loss, gradients, predict) and its
variant with `bevfusion.yaml`'s six head groups, the 'vel' and 'iou'
branches, IOU_REG_LOSS and PRED_VELOCITY (`synthetic.multihead_variant`,
PDMSSD's per-class NMS), the eval loop through both packages, and the
train and test CLIs.

Inputs come from numpy seeds; both packages run float32; JAX runs jitted.
Each tolerance stands beside its reason.
"""
import copy
import functools
import os
import pickle
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from pdm_ssd_torch.datasets import build_dataloader as t_build_dataloader
from pdm_ssd_torch.datasets.nuscenes import nuscenes_eval as t_eval
from pdm_ssd_torch.datasets.nuscenes import nuscenes_info as t_info
from pdm_ssd_torch.datasets.nuscenes import synthetic as t_syn
from pdm_ssd_torch.datasets.nuscenes.nuscenes_dataset import NuScenesDataset as TDataset
from pdm_ssd_torch.tools.mini_root import MARKER
from pdm_ssd_torch.utils import synthetic
from pdm_ssd_torch.utils.config import CfgNode, cfg_from_yaml_file
from pdm_ssd_torch.utils.weights import from_flax, to_flax
from pdm_ssd_tpu.datasets import build_dataloader as j_build_dataloader
from pdm_ssd_tpu.datasets.nuscenes import nuscenes_eval as j_eval
from pdm_ssd_tpu.datasets.nuscenes import nuscenes_info as j_info
from pdm_ssd_tpu.datasets.nuscenes import synthetic as j_syn
from pdm_ssd_tpu.datasets.nuscenes.nuscenes_dataset import NuScenesDataset as JDataset
from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_harness import (ModelPair, assert_close_to_scale, hold_to_jax, leaves,
                                match_detections, open_score_gate_flax, port_loss_and_grads,
                                rel_l2, to_numpy, to_torch)

REPO = Path(__file__).resolve().parents[1]
CLASS_NAMES = list(synthetic.NUSCENES_CLASSES)
# infos: float64 transforms of the same JSON in the same order; both
# packages' arrays are float32 or float64 from the same numpy calls
INFO_ATOL = 1e-6
# the evaluator: float64 numpy on the same annotations in the same order
METRIC_ATOL = 1e-9
# a module or model fed the same inputs: float32 sums in another order only
MODULE_RTOL = 1e-4
# the losses of one batch: float32 sums in another order
LOSS_RTOL = 1e-5
# per-leaf gradients, relative L2: float32 rounding of the backward's sums
# (convolutions over whole maps, BatchNorm on batch statistics); measured
# 3.1e-5 at worst on the tiny model's batch (12 boxes a cloud)
GRAD_REL_L2 = 1e-3
# the six-group variant (`synthetic.multihead_variant`, on the JAX
# package's init): where the JAX package's own float32 strays from its
# float64 (`hold_to_jax`; any loss term, at most VARIANT_MAX_APART gradient
# leaves), its float32 within these of its float64 and the port's float32
# within LOSS_RTOL or GRAD_REL_L2 of that float64
VARIANT_JAX_F32_LOSS_RTOL = 1e-4
VARIANT_JAX_F32_GRAD_REL_L2 = 1e-2
VARIANT_MAX_APART = 4
# decoded boxes: the gathered maps, atan2 and the cell arithmetic
BOX_ATOL = 1e-4
# NDS and mAP of one set of weights through both eval loops: the detections
# differ by float32 rounding only
EVAL_ATOL = 1e-4
# frames of the mini set of the loop tests: CBGS keeps round(frames / 10)
# of them for the one class the set holds, two batches of 2
MINI_SAMPLES = 40
MINI_SWEEPS = 3
POINTS = 2048


def load_nuscenes_cfg():
    cwd = os.getcwd()
    os.chdir(REPO)          # configs name their base config relative to the repo
    try:
        return cfg_from_yaml_file('configs/nuscenes_models/pdm_ssd_nuscenes.yaml', CfgNode())
    finally:
        os.chdir(cwd)


def mini_cfg(root, tiny=True):
    """`pdm_ssd_nuscenes.yaml` reading the mini set at `root` (the VERSION
    subdirectory dropped, the train infos also the test split's), MAX_SWEEPS
    MINI_SWEEPS and POINTS points a cloud; with `tiny` shrunk by
    `synthetic.tiny_nuscenes_cfg`."""
    cfg = load_nuscenes_cfg()
    if tiny:
        synthetic.tiny_nuscenes_cfg(cfg)
    ds = cfg.DATA_CONFIG
    ds.DATA_PATH = str(root)
    ds.VERSION = ''
    ds.MAX_SWEEPS = MINI_SWEEPS
    info = f'nuscenes_infos_{MINI_SWEEPS}sweeps_train.pkl'
    ds.INFO_PATH = {'train': [info], 'test': [info]}
    for proc in ds.DATA_PROCESSOR:
        if proc.NAME == 'sample_points':
            proc.NUM_POINTS = {'train': POINTS, 'test': POINTS}
    return cfg


@pytest.fixture(scope='module')
def mini(tmp_path_factory):
    """The mini set of MINI_SAMPLES frames at MINI_SWEEPS sweeps, written by
    the port's tool and by the JAX package's generator (no cameras)."""
    from pdm_ssd_torch.tools import make_mini_nuscenes
    base = tmp_path_factory.mktemp('nuscenes')
    make_mini_nuscenes.main(['--root', str(base / 'port'), '--samples', str(MINI_SAMPLES),
                             '--max_sweeps', str(MINI_SWEEPS)])
    j_syn.make_mini_nuscenes(base / 'jax', with_cams=False, n_samples=MINI_SAMPLES,
                             max_sweeps=MINI_SWEEPS)
    return base / 'port', base / 'jax'


def _files(root):
    """The files under `root` but the port's tools' marker (`tools/mini_root.MARKER`),
    which the JAX package's generator does not write."""
    return sorted(p.relative_to(root) for p in root.rglob('*')
                  if p.is_file() and p.name != MARKER)


def test_tool_writes_the_jax_generators_files(mini):
    """The port's `make_mini_nuscenes` and the JAX package's generator
    without cameras write the same files: tables and sweeps byte for byte,
    info pickles equal as `test_create_infos_match_jax` holds them."""
    t_root, j_root = mini
    assert (t_root / MARKER).exists()
    assert _files(t_root) == _files(j_root)
    for rel in _files(j_root):
        if rel.suffix != '.pkl':
            assert (t_root / rel).read_bytes() == (j_root / rel).read_bytes(), rel
    for split in ('train', 'val'):
        name = f'nuscenes_infos_{MINI_SWEEPS}sweeps_{split}.pkl'
        _assert_infos_equal(pickle.loads((t_root / name).read_bytes()),
                            pickle.loads((j_root / name).read_bytes()))


@pytest.mark.parametrize('kw', [{}, {'ego_xy': (-3.0, 7.5), 'ego_yaw': -1.2, 'n_samples': 5}])
def test_write_tables_is_byte_equal_to_jax(tmp_path, kw):
    """`write_tables` with the same arguments: the same JSON bytes and sweep
    files."""
    t_syn.write_tables(tmp_path / 'port', **kw)
    j_syn.write_tables(tmp_path / 'jax', **kw)
    assert _files(tmp_path / 'port') == _files(tmp_path / 'jax')
    for rel in _files(tmp_path / 'jax'):
        assert (tmp_path / 'port' / rel).read_bytes() == (tmp_path / 'jax' / rel).read_bytes()


def _assert_infos_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert (g['token'], g['lidar_path'], g['cams']) == (w['token'], w['lidar_path'], w['cams'])
        np.testing.assert_array_equal(g['gt_names'], w['gt_names'])
        np.testing.assert_array_equal(g['num_lidar_pts'], w['num_lidar_pts'])
        for k in ('gt_boxes', 'timestamp'):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=INFO_ATOL, err_msg=k)
        assert g['gt_boxes'].dtype == w['gt_boxes'].dtype
        assert len(g['sweeps']) == len(w['sweeps'])
        for gs, ws in zip(g['sweeps'], w['sweeps']):
            assert gs['lidar_path'] == ws['lidar_path']
            for k in ('transform_matrix', 'time_lag'):
                np.testing.assert_allclose(gs[k], ws[k], rtol=0, atol=INFO_ATOL, err_msg=k)


@pytest.mark.parametrize('max_sweeps', [1, 3])
def test_create_infos_match_jax(tmp_path, max_sweeps):
    """`create_nuscenes_infos` on one set of tables (an ego pose that turns
    the velocities): infos equal, arrays within INFO_ATOL, paths equal, the
    sweeps' chains and time lags too."""
    root = t_syn.write_tables(tmp_path, ego_xy=(-3.0, 7.5), ego_yaw=-1.2, n_samples=4)
    t_info.create_nuscenes_infos(root, 'v1.0-mini', max_sweeps=max_sweeps)
    got = {s: pickle.loads((root / f'nuscenes_infos_{max_sweeps}sweeps_{s}.pkl').read_bytes())
           for s in ('train', 'val')}
    j_info.create_nuscenes_infos(root, 'v1.0-mini', max_sweeps=max_sweeps)
    for split in ('train', 'val'):
        want = pickle.loads((root / f'nuscenes_infos_{max_sweeps}sweeps_{split}.pkl')
                            .read_bytes())
        _assert_infos_equal(got[split], want)
    assert len(got['train']) == 4 and len(got['train'][3]['sweeps']) == max_sweeps - 1
    assert abs(np.hypot(*got['train'][1]['gt_boxes'][0, 7:9]) - 2.0) < 1e-4


# ---- the dataset ------------------------------------------------------------------

def _spread_infos(infos, seed):
    """The mini set's infos with 1 to 4 boxes each of the 10 classes and of
    one class outside the list ('animal'), within the range, with
    velocities: a scene for CBGS and class filtering."""
    rng = np.random.RandomState(seed)
    out = []
    for info in infos:
        n = rng.randint(1, 5)
        names = rng.choice(CLASS_NAMES + ['animal'], n)
        boxes = np.concatenate([rng.uniform(-40, 40, (n, 2)), rng.uniform(-2, 0, (n, 1)),
                                rng.uniform(0.5, 5, (n, 3)), rng.uniform(-3, 3, (n, 1)),
                                rng.normal(0, 3, (n, 2))], 1).astype(np.float32)
        out.append({**info, 'gt_boxes': boxes, 'gt_names': names,
                    'num_lidar_pts': np.full(n, 5)})
    return out


DATASET_CASES = {
    'test': dict(training=False),
    'train_cbgs': dict(training=True),
    'pred_velocity': dict(training=True, PRED_VELOCITY=True),
    'nan_velocity': dict(training=True, PRED_VELOCITY=True, SET_NAN_VELOCITY_TO_ZEROS=True),
    'no_cbgs': dict(training=True, BALANCED_RESAMPLING=False),
}


def _datasets(mini, case, infos_name='spread.pkl'):
    t_root, j_root = mini
    kw = dict(DATASET_CASES[case])
    training = kw.pop('training')
    out = []
    for root, Dataset, Node in ((t_root, TDataset, CfgNode), (j_root, JDataset, JCfgNode)):
        ds_cfg = mini_cfg(root).DATA_CONFIG
        ds_cfg.INFO_PATH = {'train': [infos_name], 'test': [infos_name]}
        ds_cfg.update(kw)
        np.random.seed(3)               # CBGS draws from np.random
        out.append(Dataset(Node(ds_cfg.to_dict()), CLASS_NAMES, training=training,
                           root_path=root))
    return out


def _write_spread(mini, nan: bool):
    for root in mini:
        infos = pickle.loads((root / f'nuscenes_infos_{MINI_SWEEPS}sweeps_train.pkl')
                             .read_bytes())
        infos = _spread_infos(infos[:12], seed=5)
        if nan:
            for info in infos[::3]:
                info['gt_boxes'][0, 7:9] = np.nan
        (root / 'spread.pkl').write_bytes(pickle.dumps(infos))


def _assert_sample_equal(got, want, where=''):
    assert set(got) == set(want), (where, set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray) and w.dtype != object:
            assert g.dtype == w.dtype and g.shape == w.shape, (where, k)
            np.testing.assert_array_equal(g, w, err_msg=f'{where} {k}')
        elif isinstance(w, np.ndarray):
            assert list(g) == list(w), (where, k)
        else:
            assert g == w, (where, k)


@pytest.mark.parametrize('case', sorted(DATASET_CASES))
def test_dataset_samples_and_batches_match_jax(mini, case):
    """`NuScenesDataset` of both packages on the same infos, under one
    `np.random` seed: the same resampled info list (CBGS in training), every
    sample equal bit for bit (points of 3 sweeps with their time lags, the
    augmentations, `sample_points`, the boxes filtered to the class list,
    the velocity columns dropped or kept, NaN velocities zeroed), then
    `collate_batch` of them equal, `metadata` carried."""
    _write_spread(mini, nan=case == 'nan_velocity')
    t_ds, j_ds = _datasets(mini, case)
    assert [i['token'] for i in t_ds.infos] == [i['token'] for i in j_ds.infos]
    if case in ('train_cbgs', 'pred_velocity', 'nan_velocity'):
        assert len(t_ds.infos) != 12            # resampled
    assert len(t_ds) > 0
    samples = {}
    for name, ds in (('port', t_ds), ('jax', j_ds)):
        np.random.seed(11)
        samples[name] = [ds[i] for i in range(len(ds))]
    for i, (g, w) in enumerate(zip(samples['port'], samples['jax'])):
        _assert_sample_equal(g, w, f'sample {i}')
        assert g['points'].shape == (POINTS, 5)
        if 'gt_boxes' in g:
            width = 10 if 'velocity' in case else 8
            assert g['gt_boxes'].shape[1] == width and np.isfinite(g['gt_boxes']).all()
    got = t_ds.collate_batch(samples['port'][:3])
    want = j_ds.collate_batch(samples['jax'][:3])
    _assert_sample_equal(got, want, 'batch')
    assert [m['token'] for m in got['metadata']] == [t_ds.infos[i]['token'] for i in range(3)] \
        or case != 'test'


def _eval_annos(seed, velocity, empty_class=None, duplicates=False, at_threshold=False):
    """Seeded ground truth and predictions of 6 samples over the 10 classes:
    predictions near half the ground truth (some beyond 4 m), false
    positives, and with `duplicates` a second prediction on some boxes;
    `empty_class` has no ground truth (and predictions), with `at_threshold`
    a prediction lies exactly 2 m from its box in x."""
    rng = np.random.RandomState(seed)
    C = 9 if velocity else 7
    gts, preds = [], []
    for s in range(6):
        n = rng.randint(3, 12)
        names = rng.choice(CLASS_NAMES, n)
        if empty_class is not None:
            names = np.where(names == empty_class, 'car', names)
        boxes = np.concatenate([rng.uniform(-40, 40, (n, 2)), rng.uniform(-2, 0, (n, 1)),
                                rng.uniform(0.5, 5, (n, 3)), rng.uniform(-3, 3, (n, 1)),
                                rng.normal(0, 3, (n, 2))], 1)[:, :C]
        gts.append({'name': names, 'boxes_3d': boxes})
        hit = rng.rand(n) < 0.6
        pb = boxes[hit] + np.concatenate([rng.normal(0, 1.5, (hit.sum(), 3)),
                                          rng.normal(0, 0.3, (hit.sum(), 3)),
                                          rng.normal(0, 0.5, (hit.sum(), C - 6))], 1)
        pn = names[hit]
        if at_threshold and len(pb):
            pb[0, :2] = boxes[hit][0, :2] + [2.0, 0.0]
        m = rng.randint(1, 6)
        fp = np.concatenate([rng.uniform(-40, 40, (m, 2)), rng.uniform(-2, 0, (m, 1)),
                             rng.uniform(0.5, 5, (m, 3)), rng.uniform(-3, 3, (m, C - 6))], 1)
        pb = np.concatenate([pb, fp])
        pn = np.concatenate([pn, rng.choice(CLASS_NAMES, m)])
        if duplicates:
            pb = np.concatenate([pb, pb[:2] + 0.1])
            pn = np.concatenate([pn, pn[:2]])
        preds.append({'name': pn, 'boxes_3d': pb, 'score': rng.rand(len(pn))})
    return gts, preds


EVAL_CASES = {'velocity': dict(velocity=True), 'no_velocity': dict(velocity=False),
              'empty_classes': dict(velocity=True, empty_class='bus'),
              'duplicates': dict(velocity=False, duplicates=True),
              'at_threshold': dict(velocity=True, at_threshold=True)}


@pytest.mark.parametrize('case', sorted(EVAL_CASES))
def test_evaluate_nuscenes_matches_jax(case):
    """`evaluate_nuscenes` of both packages on seeded annotations: the same
    report and every metric (per-class AP and TP errors, mAP, mATE ...,
    NDS) within METRIC_ATOL; AVE only with velocities."""
    gts, preds = _eval_annos(4, **EVAL_CASES[case])
    got_str, got = t_eval.evaluate_nuscenes(gts, preds, CLASS_NAMES)
    want_str, want = j_eval.evaluate_nuscenes(gts, preds, CLASS_NAMES)
    assert set(got) == set(want) and got_str == want_str
    for k in want:
        assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])
    assert ('mVELE' in got) == EVAL_CASES[case]['velocity']
    assert 0 < got['mAP'] < 1 and 0 < got['NDS'] < 1


# ---- the tiny model ---------------------------------------------------------------

@pytest.fixture(scope='module')
def nus():
    """The tiny `pdm_ssd_nuscenes.yaml` in both packages, built with the
    config's class names, on a seeded nuScenes-like batch (5 features, 12
    boxes a cloud of the 10 classes). The weights start from the seeded port
    model's (`to_flax`), not from the JAX package's init, whose compile
    would be most of the pair's set-up; `test_nus_weights_have_the_jax_layout`
    holds their layout to that init's."""
    cfg = synthetic.tiny_nuscenes_cfg(load_nuscenes_cfg())
    batch = synthetic.nuscenes_batch(2, 1024, 12, seed=0)
    start = to_flax(synthetic.random_model(cfg, 'cpu', seed=0))
    return ModelPair(cfg, B=2, N=1024, seed=0, batch=batch, variables=start)


def test_nus_weights_have_the_jax_layout(nus):
    """The port's tensors in the flax layout (`to_flax`), the pair's
    starting weights, have the paths, shapes and dtypes of the JAX package's
    init (traced, not compiled), and map back onto the port unchanged."""
    init = jax.eval_shape(lambda b: nus.jax_model.init(
        {'params': jax.random.PRNGKey(0)}, b, training=False), nus.inputs)
    back = to_flax(nus.net)
    for kind in ('params', 'batch_stats'):
        want = {'/'.join(str(getattr(p, 'key', p)) for p in path): (a.shape, a.dtype)
                for path, a in jax.tree_util.tree_leaves_with_path(init[kind])}
        got = dict(leaves(back[kind]))
        assert {k: (v.shape, v.dtype) for k, v in got.items()} == want, kind
        for k, v in leaves(nus.variables[kind]):
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_forward_and_predict_match_jax(nus):
    """The training-mode forward (the program the JAX package compiles for
    the loss): the BEV maps and the head's maps within MODULE_RTOL of scale;
    then `predict` with the score gate open: the same detections by box and
    label."""
    J = nus.jax_train_forward()
    nus.net.train()
    try:
        with torch.no_grad():
            T = to_numpy(nus.net(nus.torch_inputs()))
    finally:
        nus.net.eval()
        nus.net.load_state_dict(from_flax(nus.variables, nus.net))
    for k in ('spatial_features', 'spatial_features_2d'):
        assert_close_to_scale(T[k], J[k], MODULE_RTOL, k)
    for k, want in J['center_head_preds'][0].items():
        assert_close_to_scale(T['center_head_preds'][0][k], want, MODULE_RTOL, k)
    variables = nus.variables
    nus.variables = open_score_gate_flax(variables)
    nus.net.load_state_dict(from_flax(nus.variables, nus.net))
    try:
        want = nus.jax_method(nus.jax_model.predict, {'points': nus.points})
        got = nus.net.predict(nus.torch_inputs())
    finally:
        nus.variables = variables
        nus.net.load_state_dict(from_flax(variables, nus.net))
    assert match_detections(got, want) > 8


def test_training_loss_and_gradients_match_jax(nus):
    """The training loss and its terms within LOSS_RTOL, every gradient
    within GRAD_REL_L2 relative L2 of the JAX package's."""
    _, tb, grads, _ = port_loss_and_grads(nus, nus.torch_batch())
    _, j_tb, j_grads, _ = nus.jax_loss_and_grads()
    assert set(tb) == {'hm_loss', 'loc_loss', 'loss'} == set(j_tb)
    for k, want in j_tb.items():
        np.testing.assert_allclose(float(tb[k]), float(want), rtol=LOSS_RTOL, err_msg=k)
    got = dict(leaves(grads))
    for k, want in leaves(j_grads):
        assert rel_l2(got[k], want) <= GRAD_REL_L2, (k, rel_l2(got[k], want))


# ---- the tiny model with six head groups ------------------------------------------

@pytest.fixture(scope='module')
def variant():
    """The tiny shrink of `pdm_ssd_nuscenes.yaml` as `synthetic.multihead_variant`
    sets it (six groups, 'vel' and 'iou', IOU_REG_LOSS, PRED_VELOCITY, IoU
    rectification) in both packages, built with the config's class names, on
    a seeded nuScenes-like batch whose boxes carry velocity. Its weights are
    the JAX package's init: from the port's seeded weights one IoU loss
    term lies 1.9e-5 apart (the polygon clip in float32), past LOSS_RTOL,
    and `hold_to_jax` then compiles the float64 program (about 19 s) to
    pass it."""
    cfg = synthetic.multihead_variant(synthetic.tiny_nuscenes_cfg(load_nuscenes_cfg()))
    batch = synthetic.nuscenes_batch(2, 1024, 12, seed=0, velocity=True)
    return ModelPair(cfg, B=2, N=1024, seed=0, batch=batch, jax_init=True)


def test_variant_weights_round_trip_and_head_names(variant):
    """Six `head_<i>` groups with 'vel' and 'iou' branches; the flax tree's
    leaves map onto the port's tensors and back unchanged."""
    names = variant.net.dense_head.head_names
    assert names == [f'head_{i}' for i in range(6)]
    assert {'vel_out', 'iou_out', 'hm_out'} <= set(dict(variant.net.dense_head.head_3
                                                        .named_children()))
    back = to_flax(variant.net)
    for kind in ('params', 'batch_stats'):
        want = dict(leaves(variant.variables[kind]))
        got = dict(leaves(back[kind]))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_variant_forward_and_predict_match_jax(variant):
    """The training-mode forward (the one program the JAX package compiles
    for the loss and gradients): every group's maps within MODULE_RTOL of
    scale; then `predict` with every group's score gate open: the same
    detections by box and label."""
    J = variant.jax_train_forward()
    variant.net.train()
    try:
        with torch.no_grad():
            T = to_numpy(variant.net(variant.torch_inputs()))
    finally:
        variant.net.eval()
        variant.net.load_state_dict(from_flax(variant.variables, variant.net))
    for k in ('spatial_features', 'spatial_features_2d'):
        assert_close_to_scale(T[k], J[k], MODULE_RTOL, k)
    assert len(T['center_head_preds']) == 6
    for t_preds, j_preds in zip(T['center_head_preds'], J['center_head_preds']):
        for k, want in j_preds.items():
            assert_close_to_scale(t_preds[k], want, MODULE_RTOL, k)
    variables = variant.variables
    variant.variables = open_score_gate_flax(variables)
    variant.net.load_state_dict(from_flax(variant.variables, variant.net))
    try:
        want = variant.jax_method(variant.jax_model.predict, {'points': variant.points})
        got = variant.net.predict(variant.torch_inputs())
    finally:
        variant.variables = variables
        variant.net.load_state_dict(from_flax(variables, variant.net))
    assert match_detections(got, want) > 8


def test_variant_training_loss_and_gradients_match_jax(variant):
    """The training-mode loss and each of its 24 terms (hm, loc, iou and
    iou_reg of six groups) within LOSS_RTOL, every gradient within
    GRAD_REL_L2 relative L2, or at a few leaves as `hold_to_jax` holds
    them; the 'vel' and 'iou' branches receive gradient."""
    _, tb, grads, _ = port_loss_and_grads(variant, variant.torch_batch())
    _, j_tb, j_grads, _ = variant.jax_loss_and_grads()
    assert len(tb) == 25 and 'iou_reg_loss_head_5' in tb
    exact = functools.lru_cache(variant.jax_f64_loss_and_grads)
    hold_to_jax(tb, j_tb, lambda: exact()[0], LOSS_RTOL, VARIANT_JAX_F32_LOSS_RTOL, len(tb))
    hold_to_jax(grads, j_grads, lambda: exact()[1], GRAD_REL_L2, VARIANT_JAX_F32_GRAD_REL_L2,
               VARIANT_MAX_APART)
    head = grads['dense_head']
    assert np.abs(head['head_2']['vel_out']['kernel']).sum() > 0
    assert np.abs(head['head_2']['iou_out']['kernel']).sum() > 0


@pytest.mark.parametrize('kind', ['class_specific_nms', 'multi_classes_nms'])
def test_pdm_ssd_post_process_per_class_nms_matches_jax(variant, kind):
    """PDMSSD's post-processing of the JAX package's (training-mode) forward
    maps (every group's score gate open) with NMS_TYPE class_specific_nms, SCORE_THRESH
    gating each class: the same slots and keep mask. multi_classes_nms
    needs an anchor head's per-class scores: both packages refuse it
    (the JAX package by an assertion)."""
    J = {'center_head_preds': [{**p, 'hm': p['hm'] + 2.19}
                               for p in variant.jax_train_forward()['center_head_preds']]}
    d = copy.deepcopy(variant.cfg.MODEL.to_dict())
    d['POST_PROCESSING']['NMS_CONFIG'].update(NMS_TYPE=kind, NMS_THRESH=0.2,
                                              NMS_PRE_MAXSIZE=32, NMS_POST_MAXSIZE=4)
    from pdm_ssd_tpu.models import build_network as j_build_network
    jcfg = JCfgNode(variant.cfg.to_dict())
    j_model = j_build_network(JCfgNode(d), 10, jcfg.DATA_CONFIG,
                              class_names=list(variant.cfg.CLASS_NAMES))
    nms_cfg = variant.net.model_cfg.POST_PROCESSING.NMS_CONFIG
    saved = copy.deepcopy(nms_cfg.to_dict())
    nms_cfg.update(d['POST_PROCESSING']['NMS_CONFIG'])
    try:
        t_in = {'center_head_preds': to_torch(J['center_head_preds'])}
        j_post = jax.jit(functools.partial(j_model.apply, method=j_model.post_process))
        if kind == 'multi_classes_nms':
            with pytest.raises(AssertionError):
                j_post(variant.variables, J)
            with pytest.raises(ValueError, match='per-class scores'):
                variant.net.post_process(t_in)
            return
        want = to_numpy(j_post(variant.variables, J))
        with torch.no_grad():
            got = to_numpy(variant.net.post_process(t_in))
    finally:
        nms_cfg.update(saved)
    assert got['pred_mask'].shape == (2, 40)
    for k in ('pred_mask', 'pred_labels'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got['pred_boxes'], want['pred_boxes'], rtol=0, atol=BOX_ATOL)
    assert got['pred_mask'].sum() > 8


# ---- the loops --------------------------------------------------------------------

def test_eval_loop_matches_jax(mini, nus, tmp_path):
    """`eval_one_epoch` of both packages over the mini set's frames at B=4
    (the last batch partial), the tiny model's weights with the score gate
    open: the same detections in every frame by box and class, with the
    sample's token; NDS, mAP and recall within EVAL_ATOL; result.pkl
    written."""
    from pdm_ssd_torch.runtime import eval_utils as t_eval_utils
    from pdm_ssd_tpu.runtime import eval_utils as j_eval_utils
    t_root, j_root = mini
    variables = open_score_gate_flax(nus.variables)
    nus.net.load_state_dict(from_flax(variables, nus.net))
    cfg = mini_cfg(t_root)
    try:
        t_set, t_loader, _ = t_build_dataloader(cfg.DATA_CONFIG, CLASS_NAMES, batch_size=4,
                                                root_path=t_root, workers=0, training=False)
        j_set, j_loader, _ = j_build_dataloader(JCfgNode(mini_cfg(j_root).DATA_CONFIG.to_dict()),
                                                CLASS_NAMES, batch_size=4, root_path=j_root,
                                                workers=0, training=False)
        np.random.seed(7)       # the sweeps taken and `sample_points` draw from np.random
        got = t_eval_utils.eval_one_epoch(nus.net, t_loader, t_set, CLASS_NAMES, device='cpu',
                                          result_dir=tmp_path / 'port')
    finally:
        nus.net.load_state_dict(from_flax(nus.variables, nus.net))
    jv = jax.tree_util.tree_map(jax.numpy.asarray, variables)
    (tmp_path / 'jax' / 'final_result' / 'data').mkdir(parents=True)   # as tools/test.py does
    np.random.seed(7)
    want = j_eval_utils.eval_one_epoch(nus.jax_model, jv['params'], jv['batch_stats'],
                                       j_loader, j_set, CLASS_NAMES, result_dir=tmp_path / 'jax')
    t_annos = pickle.loads((tmp_path / 'port' / 'result.pkl').read_bytes())
    j_annos = pickle.loads((tmp_path / 'jax' / 'result.pkl').read_bytes())
    assert len(t_annos) == MINI_SAMPLES
    assert [a['metadata'] for a in t_annos] == [a['metadata'] for a in j_annos]
    for t, j in zip(t_annos, j_annos):
        assert t['frame_id'] == j['frame_id']
        det = {'pred_boxes': t['boxes_lidar'][None], 'pred_labels': np.array([
            CLASS_NAMES.index(n) for n in t['name']])[None],
            'pred_mask': np.ones((1, len(t['name'])), bool)}
        ref = {'pred_boxes': j['boxes_lidar'][None], 'pred_labels': np.array([
            CLASS_NAMES.index(n) for n in j['name']])[None],
            'pred_mask': np.ones((1, len(j['name'])), bool)}
        match_detections(det, ref)
    assert sum(len(a['name']) for a in t_annos) > MINI_SAMPLES
    for k in ('NDS', 'mAP', 'mTRANSE', 'recall/rcnn_0.3', 'recall/rcnn_0.5'):
        assert abs(got[k] - want[k]) <= EVAL_ATOL, (k, got[k], want[k])
    assert got['infer_fps'] > 0 and got['loop_fps'] > 0


def test_train_and_test_clis_run_pdm_ssd_nuscenes_on_the_cpu(mini, tmp_path, monkeypatch):
    """`tools.train` one epoch, then `tools.test` of its checkpoint, with
    `--device cpu`, on the mini set (the tiny shrink written as a YAML): the
    checkpoint, `result.pkl` and NDS and mAP in the log."""
    from pdm_ssd_torch.tools import test as test_cli
    from pdm_ssd_torch.tools import train as train_cli
    t_root, _ = mini
    d = mini_cfg(t_root).to_dict()
    for k in ('TAG', 'EXP_GROUP_PATH'):
        d.pop(k, None)
    cfg_file = tmp_path / 'tiny_nuscenes.yaml'
    cfg_file.write_text(yaml.safe_dump(d))
    out = tmp_path / 'out'
    common = ['--cfg_file', str(cfg_file), '--batch_size', '2', '--workers', '0',
              '--device', 'cpu', '--output_dir', str(out)]
    monkeypatch.chdir(REPO)
    train_cli.main(common + ['--epochs', '1'])
    ckpt = out / 'ckpt' / 'checkpoint_epoch_1.pth'
    assert ckpt.exists()
    ret = test_cli.main(common + ['--ckpt', str(ckpt)])
    assert (out / 'eval' / 'result.pkl').exists()
    log = ''.join(p.read_text() for p in out.rglob('*.log'))
    assert 'NDS: ' in log and 'mAP: ' in log and 'recall_rcnn_0.7' in log
    assert 0 <= ret['NDS'] <= 1 and np.isfinite(ret['mAP'])


def test_dryrun_trains_and_predicts_the_nuscenes_config_on_the_cpu(capsys):
    """`tools.dryrun --cfg_file configs/nuscenes_models/pdm_ssd_nuscenes.yaml
    --device cpu`: one train step and one predict of the tiny shrink on
    nuScenes-like clouds of 5 features, a finite loss."""
    from pdm_ssd_torch.tools import dryrun
    loss = dryrun.dryrun('cpu', cfg_file='configs/nuscenes_models/pdm_ssd_nuscenes.yaml')
    assert np.isfinite(loss)
    assert 'PDMSSD train step + predict OK' in capsys.readouterr().out
