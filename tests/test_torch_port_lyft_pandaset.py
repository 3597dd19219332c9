"""The port's Lyft and Pandaset data paths against the JAX package, on the
CPU: the info creators, the raw readers, every sample and batch, and the
Lyft mAP that both sets are scored by.

The mini sets come from the port's generator (`make_mini_sets --set lyft`
and `--set pandaset`, 4 frames a split), once for the module, and both
packages read the same files. The raw Lyft tables and Pandaset `.pkl.gz`
tree are built as the JAX package's own tests build them
(`tests/test_dataset_tooling.py`).
"""
import copy
import pickle
import sys

import numpy as np
import pytest

from pdm_ssd_torch.datasets import build_dataloader as t_build_dataloader
from pdm_ssd_torch.datasets.lyft import lyft_dataset as t_lyft
from pdm_ssd_torch.datasets.lyft import lyft_utils as t_lyft_utils
from pdm_ssd_torch.datasets.nuscenes import nuscenes_info as t_ni
from pdm_ssd_torch.datasets.pandaset import pandaset_dataset as t_pandaset
from pdm_ssd_torch.datasets.pandaset import pandaset_utils as t_pu
from pdm_ssd_torch.tools.make_mini_sets import make
from pdm_ssd_torch.utils import synthetic
from pdm_ssd_torch.utils.config import CfgNode
from pdm_ssd_tpu.datasets import build_dataloader as j_build_dataloader
from pdm_ssd_tpu.datasets.lyft import lyft_dataset as j_lyft
from pdm_ssd_tpu.datasets.lyft import lyft_utils as j_lyft_utils
from pdm_ssd_tpu.datasets.pandaset import pandaset_dataset as j_pandaset
from pdm_ssd_tpu.datasets.pandaset import pandaset_utils as j_pu
from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode

from test_dataset_tooling import _make_lyft_tables, _make_pandaset_tree
from test_torch_port_kitti import assert_deep_equal
from torch_port_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

N_POINTS = 2048
FRAMES = 4


def data_cfg(set_name, root):
    cfg = synthetic.flagship_on(set_name, root)
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == 'sample_points':
            proc.NUM_POINTS = {'train': N_POINTS, 'test': N_POINTS}
    return cfg


@pytest.fixture(scope='module')
def sets(tmp_path_factory):
    base = tmp_path_factory.mktemp('sets')
    return {name: make(name, base / name, frames=FRAMES, n_bg=1500)
            for name in ('lyft', 'pandaset')}


@pytest.mark.parametrize('training', [True, False], ids=['train', 'test'])
@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('set_name', ['lyft', 'pandaset'])
def test_samples_and_batches_match_jax_exactly(sets, set_name, training, seed):
    """Every index of the split, `np.random` seeded the same before each
    side's `__getitem__` (training: the world flip, rotation and scaling):
    the same points, boxes and mask, and the same collated batch."""
    cfg = data_cfg(set_name, sets[set_name])
    t_set, _, _ = t_build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=0,
                                     training=training)
    j_set, _, _ = j_build_dataloader(JCfgNode(cfg.DATA_CONFIG.to_dict()), cfg.CLASS_NAMES, 2,
                                     workers=0, training=training)
    assert len(t_set) == len(j_set) == FRAMES
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


def test_lyft_info_creator_matches_jax(sets, tmp_path):
    """Both packages' `create_lyft_infos`, on the JAX tests' tables and on
    the mini set's (every class of Lyft's flat names, 2 scenes): deep-equal
    pickles; the port's nuScenes name map is back after the call."""
    _make_lyft_tables(tmp_path, np.random.RandomState(0))
    cases = [(tmp_path, ['scene-0'], []), (sets['lyft'], ['scene-0'], ['scene-1'])]
    before = dict(t_ni.NAME_MAP)
    for i, (root, train, val) in enumerate(cases):
        for side, mod in (('port', t_lyft_utils), ('jax', j_lyft_utils)):
            (tmp_path / f'{side}{i}').mkdir()
            mod.create_lyft_infos(root, tmp_path / f'{side}{i}', version='trainval',
                                  train_scenes=train, val_scenes=val)
        for split in ('train', 'val'):
            name = f'lyft_infos_{split}.pkl'
            got = pickle.loads((tmp_path / f'port{i}' / name).read_bytes())
            assert_deep_equal(got, pickle.loads((tmp_path / f'jax{i}' / name).read_bytes()), name)
            assert len(got) == (2 if i == 0 else FRAMES) * (split == 'train' or i == 1)
    assert t_ni.NAME_MAP == before


def test_lyft_name_map_is_restored_on_error(monkeypatch):
    """`fill_lyft_infos` swaps the port's own nuScenes name map for the call
    (not the JAX package's) and puts it back when the call raises."""
    from pdm_ssd_tpu.datasets.nuscenes import nuscenes_info as j_ni
    seen = {}

    def fail(tables, scene_names, max_sweeps):
        seen['map'] = dict(t_ni.NAME_MAP)
        raise RuntimeError('table error')
    monkeypatch.setattr(t_ni, 'fill_infos', fail)
    before, j_before = t_ni.NAME_MAP, dict(j_ni.NAME_MAP)
    with pytest.raises(RuntimeError, match='table error'):
        t_lyft_utils.fill_lyft_infos(None, ['scene-0'])
    assert seen['map'] == {c: c for c in t_lyft_utils.LYFT_CLASSES}
    assert t_ni.NAME_MAP is before and j_ni.NAME_MAP == j_before


def lyft_annos(rng, n_frames: int = 4) -> tuple:
    """GT and predictions of three Lyft classes: near copies of the GT
    (some with a swapped name), misses and false positives."""
    classes = ['car', 'pedestrian', 'bicycle']
    gts, preds = [], []
    for _ in range(n_frames):
        ng, nfp = rng.randint(1, 7), rng.randint(0, 4)
        gb = np.concatenate([rng.uniform(0, 40, (ng, 2)), rng.uniform(-1, 0, (ng, 1)),
                             rng.uniform(0.6, 4.5, (ng, 3)), rng.uniform(-3, 3, (ng, 1))], 1)
        names = np.asarray(classes)[rng.randint(0, 3, ng)]
        keep = rng.rand(ng) > 0.2
        pb = gb[keep] + rng.normal(0, 0.05, (int(keep.sum()), 7))
        fp = np.concatenate([rng.uniform(0, 40, (nfp, 2)), np.zeros((nfp, 1)),
                             np.full((nfp, 3), 2.0), np.zeros((nfp, 1))], 1)
        pn = np.concatenate([names[keep], np.asarray(classes)[rng.randint(0, 3, nfp)]])
        pn[:int(keep.sum())][rng.rand(int(keep.sum())) < 0.1] = 'car'
        gts.append({'name': names, 'boxes_3d': gb})
        preds.append({'name': pn, 'boxes_3d': np.concatenate([pb, fp]),
                      'score': rng.rand(len(pn))})
    return gts, preds


# the JAX package's host overlap runs its native library where it is built
# (`pdm_ssd_tpu/csrc`), else the numpy clipping that the port copies; the
# two differ by up to 2.8e-5 of IoU on these boxes
NATIVE_IOU_ATOL = 1e-4


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_lyft_map_matches_jax(seed, monkeypatch):
    """The same string and dict within 1e-9 on seeded annos, against the
    JAX package as it runs (its native overlap where built: no IoU lies
    within NATIVE_IOU_ATOL of a threshold here) and against its numpy path;
    `_iou3d` equal to the numpy path's within 1e-12, to the native one's
    within NATIVE_IOU_ATOL."""
    import pdm_ssd_tpu.csrc
    gts, preds = lyft_annos(np.random.RandomState(seed))
    classes = ['car', 'pedestrian', 'bicycle']
    t_str, t_dict = t_lyft.lyft_map(copy.deepcopy(gts), copy.deepcopy(preds), classes)
    got = t_lyft._iou3d(gts[0]['boxes_3d'], preds[0]['boxes_3d'])
    np.testing.assert_allclose(got, j_lyft._iou3d(gts[0]['boxes_3d'], preds[0]['boxes_3d']),
                               rtol=0, atol=NATIVE_IOU_ATOL)
    for native in (True, False):
        if not native:
            monkeypatch.setattr(pdm_ssd_tpu.csrc, 'rotated_overlap_bev', lambda *a: None,
                                raising=False)
            np.testing.assert_allclose(
                got, j_lyft._iou3d(gts[0]['boxes_3d'], preds[0]['boxes_3d']), rtol=0, atol=1e-12)
        j_str, j_dict = j_lyft.lyft_map(copy.deepcopy(gts), copy.deepcopy(preds), classes)
        assert t_str == j_str and t_dict.keys() == j_dict.keys() and t_dict['mAP'] > 0.1
        for k, v in j_dict.items():
            assert abs(t_dict[k] - v) <= 1e-9, (native, k, t_dict[k], v)


def test_pose_algebra_matches_jax():
    rng = np.random.RandomState(4)
    for _ in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        pose = {'position': dict(zip('xyz', rng.uniform(-50, 50, 3))),
                'heading': dict(zip('wxyz', q))}
        pts = rng.uniform(-30, 30, (50, 3))
        np.testing.assert_array_equal(t_pu.quat_to_rot(q), j_pu.quat_to_rot(q))
        np.testing.assert_array_equal(t_pu.world_to_ego(pts, pose), j_pu.world_to_ego(pts, pose))
        assert t_pu.zrot_world_to_ego(pose) == j_pu.zrot_world_to_ego(pose)


def raw_pandaset_cfg(root):
    return {'DATASET': 'PandasetDataset', 'DATA_PATH': str(root),
            'INFO_PATH': {'train': ['pandaset_infos_train.pkl'],
                          'test': ['pandaset_infos_train.pkl']},
            'SEQUENCES': {'train': ['001']},
            'TRAINING_CATEGORIES': {'Car': 'Car'},
            'POINT_CLOUD_RANGE': [-50, -50, -3, 50, 50, 5],
            'POINT_FEATURE_ENCODING': {
                'encoding_type': 'absolute_coordinates_encoding',
                'used_feature_list': ['x', 'y', 'z', 'intensity'],
                'src_feature_list': ['x', 'y', 'z', 'intensity']},
            'DATA_PROCESSOR': []}


def test_raw_pandaset_readers_and_infos_match_jax(tmp_path):
    """On the JAX tests' raw tree (gzip'd DataFrames, poses): the path
    infos of `get_infos` and `create_pandaset_infos`, each frame's points
    and cuboids from the raw readers, every raw sample and the Lyft mAP of
    the raw GT, equal to the JAX package's."""
    pytest.importorskip('pandas')
    seq = _make_pandaset_tree(tmp_path, np.random.RandomState(0))
    t_infos, j_infos = t_pu.get_infos(tmp_path, [seq]), j_pu.get_infos(tmp_path, [seq])
    assert_deep_equal(t_infos, j_infos)
    cfg = raw_pandaset_cfg(tmp_path)
    for side, mod, node in (('port', t_pu, CfgNode), ('jax', j_pu, JCfgNode)):
        (tmp_path / side).mkdir()
        mod.create_pandaset_infos(node(cfg), ['Car'], tmp_path, tmp_path / side)
    assert_deep_equal(pickle.loads((tmp_path / 'port' / 'pandaset_infos_train.pkl').read_bytes()),
                      pickle.loads((tmp_path / 'jax' / 'pandaset_infos_train.pkl').read_bytes()))
    (tmp_path / 'pandaset_infos_train.pkl').write_bytes(pickle.dumps(t_infos))
    poses = t_pu.load_poses(tmp_path / 'dataset' / seq)
    for info in t_infos:
        pose = poses[info['frame_idx']]
        np.testing.assert_array_equal(t_pu.load_lidar_frame(tmp_path / info['lidar_path'], pose),
                                      j_pu.load_lidar_frame(tmp_path / info['lidar_path'], pose))
        for got, want in zip(t_pu.load_cuboids(tmp_path / info['cuboids_path'], pose,
                                               training_categories={'Car': 'Car'}),
                             j_pu.load_cuboids(tmp_path / info['cuboids_path'], pose,
                                               training_categories={'Car': 'Car'})):
            np.testing.assert_array_equal(got, want)
    t_set = t_pandaset.PandasetDataset(CfgNode(cfg), ['Car'], training=False, root_path=tmp_path)
    j_set = j_pandaset.PandasetDataset(JCfgNode(cfg), ['Car'], training=False, root_path=tmp_path)
    for i in range(len(t_set)):
        assert_deep_equal(t_set[i], j_set[i], f'sample {i}')
    dets = [{'name': np.array(['Car']), 'boxes_3d': t_set[i]['gt_boxes'][:, :7] + 0.05,
             'score': np.array([0.9])} for i in range(len(t_set))]
    _, t_dict = t_set.evaluation(copy.deepcopy(dets), ['Car'])
    _, j_dict = j_set.evaluation(copy.deepcopy(dets), ['Car'])
    assert t_dict == j_dict and t_dict['Car_AP'] > 0.3


def test_raw_readers_raise_without_pandas(sets, tmp_path, monkeypatch):
    """Without pandas the raw Pandaset readers raise an ImportError that
    names the format and the `.npy` / `.bin` sweeps to read instead; the
    `.npy` path of the same dataset reads on."""
    pytest.importorskip('pandas')
    seq = _make_pandaset_tree(tmp_path, np.random.RandomState(0))
    info = t_pu.get_infos(tmp_path, [seq])[0]
    pose = t_pu.load_poses(tmp_path / 'dataset' / seq)[0]
    monkeypatch.setitem(sys.modules, 'pandas', None)
    with pytest.raises(ImportError, match=r'Pandaset frame \(\.pkl\.gz\).*\.npy or \.bin'):
        t_pu.load_lidar_frame(tmp_path / info['lidar_path'], pose)
    with pytest.raises(ImportError, match=r'Pandaset cuboids.*\.npy or \.bin'):
        t_pu.load_cuboids(tmp_path / info['cuboids_path'], pose)
    cfg = data_cfg('pandaset', sets['pandaset'])
    t_set, _, _ = t_build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=0,
                                     training=False)
    assert t_set[0]['points'].shape == (N_POINTS, 4)
