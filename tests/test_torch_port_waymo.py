"""The Waymo sequence data path of the port against the JAX package, on the
CPU: the mini-Waymo generator, `WaymoDataset` sample for sample and its
batches (the multi-frame stack, the poses, the offline proposals through
the world flip, rotation and scaling), `transform_prebox_to_current`, the
devkit-free AP/APH evaluator, the raw-data tooling on mock frames, the
missing voxel step of `mppnet_16frame.yaml`, and `tools.train` /
`tools.test` on `mppnet_mini.yaml`'s tiny shrink.

Inputs come from numpy seeds; both packages run the same numpy code, so
every sample is held bit for bit. Each tolerance stands beside its reason.
"""
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from pdm_ssd_torch.datasets.waymo import waymo_eval as t_eval
from pdm_ssd_torch.datasets.waymo import waymo_utils as t_utils
from pdm_ssd_torch.datasets.waymo.waymo_dataset import WaymoDataset as TDataset
from pdm_ssd_torch.tools.mini_root import MARKER
from pdm_ssd_torch.utils import synthetic
from pdm_ssd_torch.utils.config import CfgNode, cfg_from_yaml_file
from pdm_ssd_tpu.datasets.processor.data_processor import DataProcessor as JProcessor
from pdm_ssd_tpu.datasets.waymo import waymo_eval as j_eval
from pdm_ssd_tpu.datasets.waymo import waymo_utils as j_utils
from pdm_ssd_tpu.datasets.waymo.synthetic import make_mini_waymo as j_make
from pdm_ssd_tpu.datasets.waymo.waymo_dataset import WaymoDataset as JDataset
from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
from test_waymo_tooling import mock_frame
from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
MINI_CFG = 'configs/waymo_models/mppnet_mini.yaml'
FULL_CFG = 'configs/waymo_models/mppnet_16frame.yaml'
# the mini set of these tests: one sequence of 8 frames, as the generator's
# default, with fewer background points
FRAMES = 8
N_BG = 1200
# the evaluator: float64 numpy on the same annotations; the rotated overlap
# of each package is float32 (the JAX package's C++ one where it builds, the
# port's polygon clip), so an IoU may differ in its last float32 bits, and a
# metric only where a pair sits at a threshold, which no case here does
METRIC_ATOL = 1e-9


def load_cfg(name):
    cwd = os.getcwd()
    os.chdir(REPO)          # configs name their base config relative to the repo
    try:
        return cfg_from_yaml_file(name, CfgNode())
    finally:
        os.chdir(cwd)


@pytest.fixture(scope='module')
def mini(tmp_path_factory):
    """The mini set written by the port's tool and by the JAX package's
    generator from seed 0."""
    from pdm_ssd_torch.tools import make_mini_waymo
    base = tmp_path_factory.mktemp('waymo')
    make_mini_waymo.main(['--root', str(base / 'port'), '--frames', str(FRAMES), '--n_bg',
                          str(N_BG)])
    j_make(base / 'jax', n_seq=1, n_frames=FRAMES, n_bg=N_BG, seed=0, with_pred_boxes=True,
           class_name='Vehicle')
    return base / 'port', base / 'jax'


def _files(root):
    """The files under `root` but the port's tools' marker (`tools/mini_root.MARKER`),
    which the JAX package's generator does not write."""
    return sorted(p.relative_to(root) for p in root.rglob('*')
                  if p.is_file() and p.name != MARKER)


def test_tool_writes_the_jax_generators_files_byte_for_byte(mini):
    """`python -m pdm_ssd_torch.tools.make_mini_waymo` and the JAX package's
    `make_mini_waymo` with one seed: the same frames, sequence infos,
    ImageSets and `pred_boxes.pkl`, byte for byte."""
    t_root, j_root = mini
    assert (t_root / MARKER).exists()
    files = _files(j_root)
    assert files == _files(t_root)
    assert len(files) == FRAMES + 4       # the frames, the infos, two splits, the proposals
    for rel in files:
        assert (t_root / rel).read_bytes() == (j_root / rel).read_bytes(), rel


# the cases of the dataset test: (training, USE_PREDBOX, augmentations on)
DATASET_CASES = {'test': (False, True, False), 'test_no_predbox': (False, False, False),
                 'train_aug': (True, True, True), 'train_no_aug': (True, True, False),
                 'train_aug_no_predbox': (True, False, True)}


def _datasets(mini, case):
    training, predbox, aug = DATASET_CASES[case]
    out = []
    for root, Dataset, Node in ((mini[0], TDataset, CfgNode), (mini[1], JDataset, JCfgNode)):
        ds_cfg = load_cfg(MINI_CFG).DATA_CONFIG
        ds_cfg.DATA_PATH = str(root)
        ds_cfg.USE_PREDBOX = predbox
        ds_cfg.ROI_BOXES_PATH = {'train': str(root / 'pred_boxes.pkl'),
                                 'test': str(root / 'pred_boxes.pkl')}
        if not aug:
            ds_cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST = []
        out.append(Dataset(Node(ds_cfg.to_dict()), ['Vehicle'], training=training,
                           root_path=root))
    return out


def _assert_sample_equal(got, want, where=''):
    assert set(got) == set(want), (where, set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        if k == 'metadata':             # an object array in the port's batch, a list in the JAX one's
            assert list(g) == list(w), (where, k)
        elif isinstance(w, np.ndarray):
            if k == 'voxel_coords':     # int64 from the JAX package's numpy voxelizer
                w = w.astype(np.int32)
            assert g.dtype == w.dtype and g.shape == w.shape, (where, k, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=f'{where} {k}')
        else:
            assert g == w, (where, k)


@pytest.mark.parametrize('case', sorted(DATASET_CASES))
def test_dataset_samples_and_batches_match_jax(mini, case, monkeypatch):
    """`WaymoDataset` of both packages over the mini set, `mppnet_mini.yaml`'s
    data path (4 frames: three pose-composed past frames with their
    timestamps, ego points removed; `sample_points` to 2048; the voxel
    step), under one `np.random` seed: every sample equal bit for bit, the
    frame stack (4, 512, 6), the poses, and with USE_PREDBOX the offline
    proposals in (4, 16) slots moved with the ground truth by the world
    flip, rotation and scaling; then `collate_batch` of the first three.
    The JAX package's C voxelizer orders cells by first appearance, so its
    numpy one (`_numpy_voxelize`, the contract the port keeps) runs here."""
    monkeypatch.setattr(JProcessor, '_native_voxelize', lambda self, *a: None)
    training, predbox, aug = DATASET_CASES[case]
    t_ds, j_ds = _datasets(mini, case)
    assert len(t_ds) == len(j_ds) == FRAMES
    samples = {}
    for name, ds in (('port', t_ds), ('jax', j_ds)):
        np.random.seed(11)
        samples[name] = [ds[i] for i in range(len(ds))]
    flips = 0
    for i, (g, w) in enumerate(zip(samples['port'], samples['jax'])):
        _assert_sample_equal(g, w, f'sample {i}')
        assert g['points_multi_frame'].shape == (4, 512, 6) and g['poses'].shape == (4, 4, 4)
        assert ('roi_boxes' in g) == predbox
        if predbox:
            assert g['roi_boxes'].shape == (4, 16, 9) and g['roi_labels'].shape == (4, 16)
        flips += bool(g.get('flip_x', False)) + bool(g.get('flip_y', False))
    if aug:
        assert flips > 0 and 'noise_rot' in samples['port'][0]
    got = t_ds.collate_batch(samples['port'][:3])
    want = j_ds.collate_batch(samples['jax'][:3])
    _assert_sample_equal(got, want, 'batch')
    assert got['points_multi_frame'].shape == (3, 4, 512, 6)


def test_transform_prebox_to_current_matches_jax():
    """Boxes of 9 and 11 columns re-expressed from a previous frame's pose in
    the current one's: the same float64 numpy in both packages, bit for
    bit."""
    rng = np.random.RandomState(0)

    def pose():
        yaw = rng.uniform(-np.pi, np.pi)
        c, s = np.cos(yaw), np.sin(yaw)
        p = np.eye(4)
        p[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        p[:3, 3] = rng.uniform(-20, 20, 3)
        return p

    for width in (9, 11):
        boxes = rng.uniform(-10, 10, (7, width))
        boxes[:, 3:6] = np.abs(boxes[:, 3:6]) + 1
        pre, cur = pose(), pose()
        got = TDataset.transform_prebox_to_current(boxes.copy(), pre, cur)
        want = JDataset.transform_prebox_to_current(boxes.copy(), pre, cur)
        np.testing.assert_array_equal(got, want)
        assert not np.allclose(got[:, :2], boxes[:, :2])


def _box(x, y, yaw=0.0, dims=(4.6, 2.0, 1.8)):
    return np.array([x, y, 0.0, *dims, yaw], np.float64)


def _seeded_annos(seed):
    """Ground truth and predictions of 5 frames over three classes: matches
    a few centimetres off, some turned by pi (APH), low-point ground truth
    (LEVEL_2 only), misses and false positives, scores spread."""
    rng = np.random.RandomState(seed)
    classes = ['Vehicle', 'Pedestrian', 'Cyclist']
    dims = {'Vehicle': (4.6, 2.0, 1.8), 'Pedestrian': (0.9, 0.9, 1.7), 'Cyclist': (1.8, 0.8, 1.7)}
    gts, preds = [], []
    for _ in range(5):
        n = rng.randint(2, 7)
        names = rng.choice(classes, n)
        boxes = np.stack([_box(*rng.uniform(-40, 40, 2), rng.uniform(-np.pi, np.pi), dims[c])
                          for c in names])
        gts.append({'name': names, 'boxes_3d': boxes,
                    'num_points_in_gt': rng.choice([2, 4, 30, 80], n)})
        hit = rng.rand(n) < 0.7
        pb = boxes[hit].copy()
        pb[:, :2] += rng.normal(0, 0.05, (len(pb), 2))
        pb[:, 6] += np.where(rng.rand(len(pb)) < 0.3, np.pi, 0.0)
        fp = np.stack([_box(*rng.uniform(-40, 40, 2), 0.0, dims['Vehicle'])
                       for _ in range(rng.randint(1, 3))])
        preds.append({'name': np.concatenate([names[hit], ['Vehicle'] * len(fp)]),
                      'boxes_3d': np.concatenate([pb, fp]), 'score': rng.rand(len(pb) + len(fp))})
    return gts, preds, classes


def _eval_case(case):
    """The four cases of `tests/test_waymo_eval.py`, then a seeded scene."""
    if case == 'seeded':
        return _seeded_annos(3)
    one = {'name': np.array(['Vehicle']), 'boxes_3d': _box(10, 0)[None],
           'num_points_in_gt': np.array([50])}
    if case == 'perfect':
        gt = [{'name': np.array(['Vehicle', 'Vehicle']),
               'boxes_3d': np.stack([_box(10, 0), _box(30, 5)]),
               'num_points_in_gt': np.array([50, 3])}]
        return gt, [{'name': gt[0]['name'], 'boxes_3d': gt[0]['boxes_3d'],
                     'score': np.array([0.9, 0.8])}], ['Vehicle']
    if case == 'heading':
        return [one], [{'name': np.array(['Vehicle']), 'boxes_3d': _box(10, 0, yaw=np.pi)[None],
                        'score': np.array([0.9])}], ['Vehicle']
    if case == 'level2':
        ped = (0.9, 0.9, 1.7)
        gt = [{'name': np.array(['Pedestrian', 'Pedestrian']),
               'boxes_3d': np.stack([_box(10, 0, dims=ped), _box(20, 0, dims=ped)]),
               'num_points_in_gt': np.array([50, 2])}]
        return gt, [{'name': np.array(['Pedestrian']), 'boxes_3d': _box(10, 0, dims=ped)[None],
                     'score': np.array([0.9])}], ['Pedestrian']
    return [one], [{'name': np.array(['Vehicle', 'Vehicle']),
                    'boxes_3d': np.stack([_box(10, 0), _box(50, 20)]),
                    'score': np.array([0.8, 0.9])}], ['Vehicle']


@pytest.mark.parametrize('case', ['perfect', 'heading', 'level2', 'false_positive', 'seeded'])
def test_evaluate_waymo_matches_jax(case):
    """`evaluate_waymo` of both packages: the same report, and AP and APH at
    LEVEL_1 and LEVEL_2 per class and their means within METRIC_ATOL, on
    the cases of the JAX package's own test and on a seeded scene of three
    classes (heading flips, LEVEL_2-only ground truth, false positives)."""
    gts, preds, classes = _eval_case(case)
    got_str, got = t_eval.evaluate_waymo(gts, preds, classes)
    want_str, want = j_eval.evaluate_waymo(gts, preds, classes)
    assert set(got) == set(want) and got_str == want_str
    for k in want:
        assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])
    if case == 'heading':
        assert got['Vehicle_L1_AP'] > 0.98 and got['Vehicle_L1_APH'] < 0.05
    if case == 'seeded':
        assert 0 < got['mean_L2_APH'] < got['mean_L2_AP'] < 1


def test_generate_labels_sequences_and_gt_database_match_jax(tmp_path):
    """On `tests/test_waymo_tooling.py`'s mock frames: `generate_labels`
    equal array for array; `process_single_sequence` at interval 2 writes
    the same frames and infos, and reads its cache back; the GT database of
    the extracted sequence the same crops and db infos."""
    frames = [mock_frame(np.random.RandomState(t), n_obj=4, n_unknown=2, t=t) for t in range(5)]
    for fr in frames:
        pose = np.array(fr.pose.transform).reshape(4, 4)
        got, want = t_utils.generate_labels(fr, pose), j_utils.generate_labels(fr, pose)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got['gt_boxes_lidar'].shape == (4, 9)
    infos = {}
    for name, utils in (('port', t_utils), ('jax', j_utils)):
        infos[name] = utils.process_single_sequence(
            tmp_path / name / 'mock_seq.tfrecord', tmp_path / name / 'waymo_processed_data',
            sampled_interval=2, frame_iter=iter(frames))
        again = utils.process_single_sequence(
            tmp_path / name / 'mock_seq.tfrecord', tmp_path / name / 'waymo_processed_data',
            sampled_interval=2, frame_iter=None)
        assert len(again) == 3
    assert pickle.dumps(infos['port']) == pickle.dumps(infos['jax'])
    seq = Path('waymo_processed_data') / 'mock_seq'
    for rel in _files(tmp_path / 'jax' / seq):
        assert (tmp_path / 'port' / seq / rel).read_bytes() == \
            (tmp_path / 'jax' / seq / rel).read_bytes(), rel

    classes = ['Vehicle', 'Pedestrian', 'Cyclist']
    db = {}
    for name, Dataset, Node in (('port', TDataset, CfgNode), ('jax', JDataset, JCfgNode)):
        root = tmp_path / name
        (root / 'ImageSets').mkdir()
        (root / 'ImageSets' / 'train.txt').write_text('mock_seq\n')
        info_path = root / 'waymo_infos_train.pkl'
        info_path.write_bytes(pickle.dumps(infos[name]))
        cfg = Node({'DATA_PATH': str(root), 'DATA_SPLIT': {'train': 'train', 'test': 'train'},
                    'POINT_CLOUD_RANGE': [-75, -75, -2, 75, 75, 4],
                    'POINT_FEATURE_ENCODING': {
                        'encoding_type': 'absolute_coordinates_encoding',
                        'used_feature_list': ['x', 'y', 'z', 'intensity'],
                        'src_feature_list': ['x', 'y', 'z', 'intensity', 'elongation']},
                    'DATA_PROCESSOR': []})
        ds = Dataset(dataset_cfg=cfg, class_names=classes, training=True, root_path=root)
        assert len(ds) == 3
        db[name] = ds.create_groundtruth_database(info_path, root, used_classes=classes)
    assert sum(len(v) for v in db['jax'].values()) > 0
    assert pickle.dumps(db['port']) == pickle.dumps(db['jax'])
    for rel in _files(tmp_path / 'jax' / 'gt_database_train'):
        assert (tmp_path / 'port' / 'gt_database_train' / rel).read_bytes() == \
            (tmp_path / 'jax' / 'gt_database_train' / rel).read_bytes(), rel


def test_mppnet_16frame_data_path_has_no_voxel_step_in_either_package(mini, monkeypatch):
    """A fault of the reference that the port copies (ROADMAP Queue 3):
    `mppnet_16frame.yaml`'s data path, from `waymo_dataset.yaml`, ends with
    `calculate_grid_size`, so its batches hold no 'voxels' in either package
    and MeanVFE has nothing to read; its sample is the file's 16 frames of
    16384 points. `synthetic.waymo_voxel_step` puts a voxel step in its
    place (0.2 x 0.2 x 6 m, a 752 x 752 x 1 grid: see the next test), as the
    chip smoke runs it."""
    monkeypatch.setattr(JProcessor, '_native_voxelize', lambda self, *a: None)
    t_root, j_root = mini
    samples = {}
    for name, root, Dataset, Node in (('port', t_root, TDataset, CfgNode),
                                      ('jax', j_root, JDataset, JCfgNode)):
        ds_cfg = load_cfg(FULL_CFG).DATA_CONFIG
        ds_cfg.DATA_PATH = str(root)
        ds = Dataset(Node(ds_cfg.to_dict()), ['Vehicle', 'Pedestrian', 'Cyclist'],
                     training=False, root_path=root)
        np.random.seed(2)
        samples[name] = ds[FRAMES - 1]
    _assert_sample_equal(samples['port'], samples['jax'], '16frame')
    assert 'voxels' not in samples['port']
    assert samples['port']['points_multi_frame'].shape == (16, 16384, 6)
    assert samples['port']['points'].shape == (163840, 6)

    from pdm_ssd_torch.models import build_network
    cfg = load_cfg(FULL_CFG)
    net = build_network(cfg.MODEL, 3, cfg.DATA_CONFIG, device='meta', class_names=cfg.CLASS_NAMES)
    with pytest.raises(KeyError, match='voxels'):
        net.vfe({k: torch.from_numpy(v[None]) for k, v in samples['port'].items()
                 if k == 'points'})

    synthetic.waymo_voxel_step(cfg)
    ds = synthetic.waymo_set(cfg, t_root, FRAMES)
    np.random.seed(2)
    item = ds[FRAMES - 1]
    assert item['voxels'].shape[1:] == (5, 6) and len(item['voxels']) > 1000
    assert item['voxel_coords'][:, 0].max() == 0 and item['voxel_coords'][:, 1:].max() < 752


def test_mppnet_16frame_bev_levels_do_not_line_up_at_the_file_grid_in_either_package():
    """A second fault of the reference that the port copies (ROADMAP Queue
    3): at the grid `mppnet_16frame.yaml` computes (0.4 m voxels over 150.4
    m, 376 cells, a 47 x 47 BEV map after the ladder's 8x) the BEV
    backbone's stride-2 level comes back from its 2x upsampling at 48 x 48,
    so the two levels cannot be concatenated: the JAX package's init fails
    while tracing (traced by `jax.eval_shape`, nothing compiled), and the
    port's `backbone_2d` on a 47 x 47 map the same way. At 0.2 m (752 cells,
    a 94 x 94 map) the levels line up; `synthetic.WAYMO_VOXEL_STEP` takes
    that grid, with the file's widths."""
    import jax
    import jax.numpy as jnp
    from pdm_ssd_tpu.models import build_network as j_build_network

    from pdm_ssd_torch.models import build_network
    cfg = load_cfg(FULL_CFG)
    jcfg = JCfgNode(cfg.to_dict())
    T, R = 16, 96
    S = jax.ShapeDtypeStruct
    batch = {'points': S((1, 64, 6), jnp.float32), 'voxels': S((1, 32, 5, 6), jnp.float32),
             'voxel_coords': S((1, 32, 3), jnp.int32), 'voxel_num_points': S((1, 32), jnp.int32),
             'voxel_mask': S((1, 32), jnp.bool_),
             'points_multi_frame': S((1, T, 64, 6), jnp.float32)}
    model = j_build_network(jcfg.MODEL, num_class=3, dataset_cfg=jcfg.DATA_CONFIG,
                            class_names=list(cfg.CLASS_NAMES))
    with pytest.raises(TypeError, match=r'\(1, 47, 47, 256\), \(1, 48, 48, 256\)'):
        jax.eval_shape(lambda b: model.init({'params': jax.random.PRNGKey(0)}, b,
                                            training=False), batch)
    net = build_network(cfg.MODEL, 3, cfg.DATA_CONFIG, device='cpu', class_names=cfg.CLASS_NAMES)
    with pytest.raises(RuntimeError, match='47'), torch.no_grad():
        net.backbone_2d({'spatial_features': torch.zeros((1, 47, 47, 64))})
    assert R == cfg.DATA_CONFIG.SEQUENCE_CONFIG.MAX_PRED_BOXES
    synthetic.waymo_voxel_step(cfg)
    net = build_network(cfg.MODEL, 3, cfg.DATA_CONFIG, device='cpu', class_names=cfg.CLASS_NAMES)
    with torch.no_grad():
        out = net.backbone_2d({'spatial_features': torch.zeros((1, 94, 94, 64))})
    assert out['spatial_features_2d'].shape[1:3] == (94, 94)


def test_train_and_test_clis_run_mppnet_mini_on_the_cpu(mini, tmp_path, monkeypatch):
    """`tools.train` one epoch, then `tools.test` of its checkpoint, with
    `--device cpu`, on the mini set (`mppnet_mini.yaml`'s tiny shrink written
    as a YAML): the checkpoint, `result.pkl`, and Waymo AP and APH at both
    levels in the log."""
    from pdm_ssd_torch.tools import test as test_cli
    from pdm_ssd_torch.tools import train as train_cli
    t_root, _ = mini
    cfg = synthetic.tiny_mppnet_cfg(load_cfg(MINI_CFG))
    ds = cfg.DATA_CONFIG
    ds.DATA_PATH = str(t_root)
    ds.ROI_BOXES_PATH = {'train': str(t_root / 'pred_boxes.pkl'),
                         'test': str(t_root / 'pred_boxes.pkl')}
    d = cfg.to_dict()
    for k in ('TAG', 'EXP_GROUP_PATH'):
        d.pop(k, None)
    cfg_file = tmp_path / 'tiny_mppnet.yaml'
    cfg_file.write_text(yaml.safe_dump(d))
    out = tmp_path / 'out'
    common = ['--cfg_file', str(cfg_file), '--batch_size', '4', '--workers', '0',
              '--device', 'cpu', '--output_dir', str(out)]
    monkeypatch.chdir(REPO)
    train_cli.main(common + ['--epochs', '1'])
    ckpt = out / 'ckpt' / 'checkpoint_epoch_1.pth'
    assert ckpt.exists()
    ret = test_cli.main(common + ['--ckpt', str(ckpt)])
    assert (out / 'eval' / 'result.pkl').exists()
    log = ''.join(p.read_text() for p in out.rglob('*.log'))
    for k in ('Vehicle_L1_AP', 'Vehicle_L1_APH', 'Vehicle_L2_AP', 'mean_L2_APH', 'recall_rcnn_0.7'):
        assert k in log, k
    # the offline proposals are the ground truth within 5 cm: AP near 1 (the
    # 101-point sum of 1 / 101 rounds to 1 + 7e-16)
    assert all(0.9 <= ret[k] <= 1 + 1e-12 for k in ('Vehicle_L1_AP', 'mean_L2_APH'))
    assert len(pickle.loads((out / 'eval' / 'result.pkl').read_bytes())) == FRAMES
