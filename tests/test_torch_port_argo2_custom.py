"""The port's Argoverse 2 and custom data paths, their evaluators and the six
per-object, frustum and pyramid augmentations against the JAX package, on
the CPU.

The mini sets come from the port's generator (`make_mini_sets --set argo2`
and `--set custom`, 4 frames a split), once for the module, and both
packages read the same files. The raw Argo2 feather files are built as the
JAX package's own test builds them (`tests/test_dataset_tooling.py`), and
its evaluator is held on the cases of `tests/test_argo2_eval.py`.
"""
import copy
import pickle
import shutil
import sys

import numpy as np
import pytest

from pdm_ssd_torch.datasets import build_dataloader as t_build_dataloader
from pdm_ssd_torch.datasets.argo2 import argo2_dataset as t_argo2
from pdm_ssd_torch.datasets.argo2 import argo2_eval as t_argo2_eval
from pdm_ssd_torch.datasets.argo2 import argo2_utils as t_au
from pdm_ssd_torch.datasets.augmentor.data_augmentor import DataAugmentor as TDataAugmentor
from pdm_ssd_torch.datasets.custom import custom_dataset as t_custom
from pdm_ssd_torch.datasets.custom import synthetic as custom_synthetic
from pdm_ssd_torch.datasets.synthetic_scene import scene
from pdm_ssd_torch.tools.make_mini_sets import make
from pdm_ssd_torch.utils import synthetic
from pdm_ssd_torch.utils.config import CfgNode
from pdm_ssd_tpu.datasets import build_dataloader as j_build_dataloader
from pdm_ssd_tpu.datasets.argo2 import argo2_dataset as j_argo2
from pdm_ssd_tpu.datasets.argo2 import argo2_eval as j_argo2_eval
from pdm_ssd_tpu.datasets.argo2 import argo2_utils as j_au
from pdm_ssd_tpu.datasets.augmentor.data_augmentor import DataAugmentor as JDataAugmentor
from pdm_ssd_tpu.datasets.custom import custom_dataset as j_custom
from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode

from test_argo2_eval import _random_frames
from test_torch_port_kitti import assert_deep_equal
from torch_port_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

N_POINTS = 2048
FRAMES = 4


def data_cfg(set_name, root, local_augmentations: bool = False):
    cfg = synthetic.flagship_on(set_name, root, local_augmentations)
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == 'sample_points':
            proc.NUM_POINTS = {'train': N_POINTS, 'test': N_POINTS}
    return cfg


@pytest.fixture(scope='module')
def sets(tmp_path_factory):
    base = tmp_path_factory.mktemp('sets')
    return {name: make(name, base / name, frames=FRAMES, n_bg=1500)
            for name in ('argo2', 'custom')}


@pytest.mark.parametrize('training', [True, False], ids=['train', 'test'])
@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('set_name', ['argo2', 'custom'])
def test_samples_and_batches_match_jax_exactly(sets, set_name, training, seed):
    """Every index of the split, `np.random` seeded the same before each
    side's `__getitem__` (training: the world flip, rotation and scaling;
    the custom set's GT sampling from its own database and the six local
    augmentations before them): the same points, boxes and mask, and the
    same collated batch."""
    cfg = data_cfg(set_name, sets[set_name], local_augmentations=set_name == 'custom')
    t_set, _, _ = t_build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=0,
                                     training=training)
    j_set, _, _ = j_build_dataloader(JCfgNode(cfg.DATA_CONFIG.to_dict()), cfg.CLASS_NAMES, 2,
                                     workers=0, training=training)
    assert len(t_set) == len(j_set) == FRAMES
    if training and set_name == 'custom':
        assert len(t_set.data_augmentor.data_augmentor_queue) == 10
    samples = {}
    for side, ds in (('port', t_set), ('jax', j_set)):
        np.random.seed(seed)
        samples[side] = [ds[i] for i in range(len(ds))]
    for t, j in zip(samples['port'], samples['jax']):
        assert t['points'].shape == (N_POINTS, 4)
        assert_deep_equal(t, j)
    t_batch = t_set.collate_batch(samples['port'])
    assert t_batch['gt_mask'].sum() >= FRAMES
    assert_deep_equal(t_batch, j_set.collate_batch(samples['jax']))


def feather_tree(root, rng):
    """The raw Argo2 layout of the JAX package's feather test: one log of two
    sweeps and its annotations."""
    pd = pytest.importorskip('pandas')
    try:
        pd.DataFrame({'x': [1.0]}).to_feather(root / 'probe.feather')
    except Exception:
        pytest.skip('no feather engine available')
    d = root / 'train' / 'log0' / 'sensors' / 'lidar'
    d.mkdir(parents=True)
    for ts in (1000, 2000):
        pd.DataFrame({'x': rng.uniform(-30, 30, 200), 'y': rng.uniform(-30, 30, 200),
                      'z': rng.uniform(-2, 3, 200),
                      'intensity': rng.uniform(0, 255, 200)}).to_feather(d / f'{ts}.feather')
    yaw = 0.7
    pd.DataFrame({
        'timestamp_ns': [1000, 2000, 2000], 'track_uuid': ['t0', 't0', 't1'],
        'category': ['REGULAR_VEHICLE', 'REGULAR_VEHICLE', 'PEDESTRIAN'],
        'length_m': [4.5, 4.5, 0.8], 'width_m': [2.0, 2.0, 0.6], 'height_m': [1.7, 1.7, 1.8],
        'qw': [np.cos(yaw / 2)] * 3, 'qx': [0.0] * 3, 'qy': [0.0] * 3,
        'qz': [np.sin(yaw / 2)] * 3,
        'tx_m': [10.0, 12.0, 5.0], 'ty_m': [5.0, 5.0, -3.0], 'tz_m': [0.5, 0.5, 0.9],
        'num_interior_pts': [30, 28, 12]}).to_feather(root / 'train' / 'log0' / 'annotations.feather')


def test_raw_argo2_readers_and_infos_match_jax(tmp_path):
    """On the raw feather files: `create_argo2_infos` deep-equal, each
    sweep and each timestamp's annotations from the readers equal, every
    sample of the feather `lidar_path` equal, `quat_to_yaw` equal."""
    rng = np.random.RandomState(0)
    feather_tree(tmp_path, rng)
    for side, mod in (('port', t_au), ('jax', j_au)):
        (tmp_path / side).mkdir()
        mod.create_argo2_infos(tmp_path, tmp_path / side, splits=('train',))
    t_infos = pickle.loads((tmp_path / 'port' / 'argo2_infos_train.pkl').read_bytes())
    assert_deep_equal(t_infos,
                      pickle.loads((tmp_path / 'jax' / 'argo2_infos_train.pkl').read_bytes()))
    assert [len(i['gt_names']) for i in t_infos] == [1, 2]
    ann = tmp_path / 'train' / 'log0' / 'annotations.feather'
    for info in t_infos:
        path = tmp_path / 'train' / info['lidar_path']
        np.testing.assert_array_equal(t_au.read_lidar_sweep(path), j_au.read_lidar_sweep(path))
        for got, want in zip(t_au.read_annotations(ann, info['timestamp_ns']),
                             j_au.read_annotations(ann, info['timestamp_ns'])):
            np.testing.assert_array_equal(got, want)
    q = rng.normal(size=(4, 30))
    np.testing.assert_array_equal(t_au.quat_to_yaw(*q), j_au.quat_to_yaw(*q))
    shutil.copy(tmp_path / 'port' / 'argo2_infos_train.pkl', tmp_path / 'argo2_infos_train.pkl')
    cfg = {'DATASET': 'Argo2Dataset', 'DATA_PATH': str(tmp_path / 'train'),
           'INFO_PATH': {'train': ['../argo2_infos_train.pkl'],
                         'test': ['../argo2_infos_train.pkl']},
           'POINT_CLOUD_RANGE': [-50, -50, -3, 50, 50, 5],
           'POINT_FEATURE_ENCODING': {
               'encoding_type': 'absolute_coordinates_encoding',
               'used_feature_list': ['x', 'y', 'z', 'intensity'],
               'src_feature_list': ['x', 'y', 'z', 'intensity']},
           'DATA_PROCESSOR': []}
    names = ['REGULAR_VEHICLE', 'PEDESTRIAN']
    t_set = t_argo2.Argo2Dataset(CfgNode(cfg), names, training=False, root_path=tmp_path / 'train')
    j_set = j_argo2.Argo2Dataset(JCfgNode(cfg), names, training=False, root_path=tmp_path / 'train')
    for i in range(len(t_set)):
        assert len(t_set[i]['points']) == 200
        assert_deep_equal(t_set[i], j_set[i], f'sample {i}')


def test_raw_argo2_readers_raise_without_pandas(sets, tmp_path, monkeypatch):
    """Without pandas the feather readers raise an ImportError naming the
    format and the `.npy` / `.bin` sweeps; the mini set's `.npy` sweeps read
    on."""
    feather_tree(tmp_path, np.random.RandomState(0))
    monkeypatch.setitem(sys.modules, 'pandas', None)
    sweep = tmp_path / 'train' / 'log0' / 'sensors' / 'lidar' / '1000.feather'
    with pytest.raises(ImportError, match=r'Argoverse 2 sweep \(\.feather\).*\.npy or \.bin'):
        t_au.read_lidar_sweep(sweep)
    with pytest.raises(ImportError, match=r'Argoverse 2 annotations.*\.npy or \.bin'):
        t_au.read_annotations(tmp_path / 'train' / 'log0' / 'annotations.feather')
    cfg = data_cfg('argo2', sets['argo2'])
    t_set, _, _ = t_build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=0,
                                     training=False)
    assert t_set[0]['points'].shape == (N_POINTS, 4)


def argo2_cases():
    """The annos of `tests/test_argo2_eval.py`'s cases: perfect detections,
    a constant 1.5 m offset, a class without a true positive, a GT beyond
    the range, and the fuzz's random frames."""
    rng = np.random.default_rng(0)
    gts, _ = _random_frames(rng)
    cases = [(gts, [{'name': g['name'], 'boxes_3d': g['boxes_3d'],
                     'score': np.linspace(0.9, 0.5, len(g['name']))} for g in gts])]
    car = np.asarray(['Car'], object)
    gt = [{'name': car, 'boxes_3d': np.asarray([[10.0, 0, 0, 4, 2, 1.5, 0.3]])}]
    for x, y in ((11.5, 0.0), (50.0, 40.0)):
        cases.append((gt, [{'name': car, 'boxes_3d': np.asarray([[x, y, 0, 4, 2, 1.5, 0.3]]),
                            'score': np.asarray([0.9])}]))
    cases.append(([{'name': np.asarray(['Car', 'Car'], object),
                    'boxes_3d': np.asarray([[10.0, 0, 0, 4, 2, 1.5, 0.0],
                                            [200.0, 0, 0, 4, 2, 1.5, 0.0]])}],
                  [{'name': car, 'boxes_3d': np.asarray([[10.0, 0, 0, 4, 2, 1.5, 0.0]]),
                    'score': np.asarray([0.9])}]))
    rng = np.random.default_rng(7)
    for _ in range(10):
        cases.append(_random_frames(rng, n_frames=int(rng.integers(1, 5))))
    return cases


def test_argo2_cds_matches_jax():
    """Every case's string and dict equal, NaN where the JAX package's is
    (a class without GT), every other entry within 1e-9."""
    for i, (gts, dets) in enumerate(argo2_cases()):
        t_str, t_dict = t_argo2_eval.evaluate_argo2(copy.deepcopy(gts), copy.deepcopy(dets),
                                                    ['Car', 'Ped'])
        j_str, j_dict = j_argo2_eval.evaluate_argo2(copy.deepcopy(gts), copy.deepcopy(dets),
                                                    ['Car', 'Ped'])
        assert t_str == j_str and t_dict.keys() == j_dict.keys(), i
        for k, v in j_dict.items():
            assert (np.isnan(v) and np.isnan(t_dict[k])) or abs(t_dict[k] - v) <= 1e-9, (i, k)


@pytest.mark.parametrize('metric', ['argo2', 'nuscenes'])
def test_argo2_evaluation_matches_jax(sets, metric):
    """`Argo2Dataset.evaluation` on the mini val split's GT, jittered, with
    misses and false positives: the CDS protocol, and under METRIC:
    nuscenes the distance-matched mAP / NDS, equal to the JAX package's."""
    cfg = data_cfg('argo2', sets['argo2'])
    cfg.DATA_CONFIG.METRIC = metric
    t_set, _, _ = t_build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=0,
                                     training=False)
    j_set, _, _ = j_build_dataloader(JCfgNode(cfg.DATA_CONFIG.to_dict()), cfg.CLASS_NAMES, 2,
                                     workers=0, training=False)
    rng = np.random.RandomState(2)
    dets = []
    for info in t_set.infos:
        keep = rng.rand(len(info['gt_names'])) > 0.2
        boxes = info['gt_boxes'][keep] + rng.normal(0, 0.3, (int(keep.sum()), 7))
        dets.append({'name': np.concatenate([info['gt_names'][keep], ['PEDESTRIAN']]),
                     'boxes_3d': np.concatenate([boxes, [[15.0, 3.0, -1.0, 0.8, 0.6, 1.7, 0]]]),
                     'score': rng.rand(int(keep.sum()) + 1)})
    t_str, t_dict = t_set.evaluation(copy.deepcopy(dets), cfg.CLASS_NAMES)
    j_str, j_dict = j_set.evaluation(copy.deepcopy(dets), cfg.CLASS_NAMES)
    assert t_str == j_str and t_dict.keys() == j_dict.keys()
    assert t_dict['mAP'] > 0.3
    for k, v in j_dict.items():
        assert (np.isnan(v) and np.isnan(t_dict[k])) or abs(t_dict[k] - v) <= 1e-9, k


def test_custom_tooling_matches_jax_file_for_file(sets, tmp_path):
    """`get_infos` and `create_groundtruth_database` of both packages on the
    mini set's points and labels: the same info pickles, the same dbinfos
    and every database crop byte for byte."""
    roots = {}
    for side, mod, node in (('port', t_custom, CfgNode), ('jax', j_custom, JCfgNode)):
        root = roots[side] = tmp_path / side
        for sub in ('points', 'labels', 'ImageSets'):
            shutil.copytree(sets['custom'] / sub, root / sub)
        cfg = node(custom_synthetic.tooling_cfg(root).to_dict())
        for split in ('train', 'val'):
            ds = mod.CustomDataset(cfg, custom_synthetic.CLASS_NAMES, training=split == 'train',
                                   root_path=root)
            with open(root / f'custom_infos_{split}.pkl', 'wb') as f:
                pickle.dump(ds.get_infos(has_label=True), f)
        ds.create_groundtruth_database(root / 'custom_infos_train.pkl',
                                       used_classes=custom_synthetic.CLASS_NAMES, split='train')
    for name in ('custom_infos_train.pkl', 'custom_infos_val.pkl', 'custom_dbinfos_train.pkl'):
        assert_deep_equal(pickle.loads((roots['port'] / name).read_bytes()),
                          pickle.loads((roots['jax'] / name).read_bytes()), name)
        assert (roots['port'] / name).read_bytes() == (sets['custom'] / name).read_bytes(), name
    crops = sorted(p.name for p in (roots['port'] / 'gt_database').iterdir())
    assert crops == sorted(p.name for p in (roots['jax'] / 'gt_database').iterdir())
    assert len(crops) >= 3 * FRAMES
    for name in crops:
        assert ((roots['port'] / 'gt_database' / name).read_bytes()
                == (roots['jax'] / 'gt_database' / name).read_bytes()), name


def test_custom_recall_matches_jax(sets):
    """The recall at IoU 0.3, 0.5 and 0.7 (the port's `boxes_iou3d` on CPU
    tensors, the JAX package's jax op) on jittered GT of the val split:
    equal, and spread across the thresholds."""
    cfg = data_cfg('custom', sets['custom'])
    t_set, _, _ = t_build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=0,
                                     training=False)
    j_set, _, _ = j_build_dataloader(JCfgNode(cfg.DATA_CONFIG.to_dict()), cfg.CLASS_NAMES, 2,
                                     workers=0, training=False)
    rng = np.random.RandomState(3)
    dets = []
    for info in t_set.custom_infos:
        gt = info['annos']['gt_boxes_lidar']
        spread = rng.choice([0.02, 0.1, 0.4], (len(gt), 1))   # a box's jitter
        boxes = gt + (rng.normal(0, 1, gt.shape) * spread).astype(np.float32)
        dets.append({'name': info['annos']['name'], 'boxes_lidar': boxes[:-1],
                     'score': rng.rand(len(gt) - 1)})
    t_str, t_dict = t_set.evaluation(copy.deepcopy(dets), cfg.CLASS_NAMES)
    j_str, j_dict = j_set.evaluation(copy.deepcopy(dets), cfg.CLASS_NAMES)
    assert t_str == j_str and t_dict == j_dict
    assert 0 < t_dict['recall_0.7'] < t_dict['recall_0.5'] < t_dict['recall_0.3'] < 1


HEAVY = {'random_local_pyramid_aug': {'DROP_PROB': 0.6, 'SPARSIFY_PROB': 0.6,
                                      'SPARSIFY_MAX_NUM': 20, 'SWAP_PROB': 0.6,
                                      'SWAP_MAX_NUM': 20},
         'random_world_frustum_dropout': {'DIRECTION': ['top', 'left'],
                                          'INTENSITY_RANGE': [0.2, 0.4]},
         'random_local_frustum_dropout': {'DIRECTION': ['bottom', 'right'],
                                          'INTENSITY_RANGE': [0.2, 0.4]}}


@pytest.mark.parametrize('which', [a['NAME'] for a in synthetic.LOCAL_AUGMENTATIONS]
                         + ['chained', 'chained, heavy'])
def test_local_augmentations_match_jax_bit_for_bit(which):
    """Each of the six augmentations alone, and all six chained (at the
    queue test's settings and at heavier ones: every pyramid step taken for
    most boxes, two frustum directions), on three seeded scenes: the port's
    `DataAugmentor` gives the JAX package's boxes and points bit for bit
    and leaves `np.random` in the same state."""
    augs = [CfgNode(a) for a in synthetic.LOCAL_AUGMENTATIONS
            if which.startswith('chained') or a['NAME'] == which]
    if which.endswith('heavy'):
        for a in augs:
            a.update(HEAVY.get(a.NAME, {}))
    t_aug = TDataAugmentor(None, augs, ['Car'])
    j_aug = JDataAugmentor(None, [JCfgNode(a.to_dict()) for a in augs], ['Car'])
    assert [f.func.__name__ for f in t_aug.data_augmentor_queue] == [a.NAME for a in augs]
    moved = 0
    for seed in range(3):
        points, boxes, _, _ = scene(np.random.RandomState(seed), ('vehicle', 'pedestrian'),
                                    (0.6, 0.4), n_bg=800)
        out, states = {}, {}
        for side, aug in (('port', t_aug), ('jax', j_aug)):
            np.random.seed(seed)
            out[side] = aug.forward({'gt_boxes': boxes.copy(), 'points': points.copy()})
            states[side] = np.random.get_state()
        for key in ('gt_boxes', 'points'):
            got, want = out['port'][key], out['jax'][key]
            assert got.dtype == want.dtype and got.shape == want.shape, (seed, key)
            assert got.tobytes() == want.tobytes(), (seed, key)
        assert all(np.array_equal(a, b) for a, b in zip(states['port'], states['jax']))
        moved += (out['port']['points'].shape != points.shape
                  or not np.array_equal(out['port']['points'], points))
    assert moved == 3
