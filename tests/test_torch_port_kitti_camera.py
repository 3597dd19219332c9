"""The port's KITTI camera data path (CaDDN's) against the JAX package, on
the CPU: the mini set's decodable images, `get_image`, the depth-map steps,
the image flip, the GT sampler's image copy-paste and its shared-memory
database, every sample and batch of `caddn_kitti()`'s data path; and the
three places where the JAX package's CaDDN cannot run from its own data
path, pinned in both packages.

The mini set (3 frames, Car only) is generated once per module by the
port's generator and read by both packages. Every sample drawn under the
same `np.random` seed must be equal exactly.
"""
import pickle
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from pdm_ssd_torch.datasets import image_ops
from pdm_ssd_torch.datasets.augmentor import database_sampler as t_db
from pdm_ssd_torch.datasets.augmentor.data_augmentor import DataAugmentor as TAugmentor
from pdm_ssd_torch.datasets.kitti import kitti_dataset as t_kitti
from pdm_ssd_torch.datasets.kitti import synthetic as t_syn
from pdm_ssd_torch.datasets.processor.data_processor import DataProcessor as TProcessor
from pdm_ssd_torch.runtime.trainer import DEVICE_KEYS, INPUT_KEYS, to_device_batch
from pdm_ssd_torch.utils import synthetic
from pdm_ssd_torch.utils.config import CfgNode, cfg_from_yaml_file
from pdm_ssd_tpu.datasets.augmentor import database_sampler as j_db
from pdm_ssd_tpu.datasets.augmentor.data_augmentor import DataAugmentor as JAugmentor
from pdm_ssd_tpu.datasets.kitti import kitti_dataset as j_kitti
from pdm_ssd_tpu.datasets.kitti import synthetic as j_syn
from pdm_ssd_tpu.datasets.processor.data_processor import DataProcessor as JProcessor
from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode

from torch_port_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
CLASS_NAMES = ['Car', 'Pedestrian', 'Cyclist']
GT_SAMPLING = {'NAME': 'gt_sampling', 'USE_ROAD_PLANE': False,
               'DB_INFO_PATH': ['kitti_dbinfos_train.pkl'],
               'PREPARE': {'filter_by_min_points': ['Car:5']}, 'SAMPLE_GROUPS': ['Car:6'],
               'NUM_POINT_FEATURES': 4, 'LIMIT_WHOLE_SCENE': False, 'IMG_AUG_TYPE': 'kitti'}


def assert_deep_equal(got, want, path=''):
    if hasattr(want, 'P2'):         # a Calibration of either package
        assert type(got).__name__ == type(want).__name__ == 'Calibration', path
        for k in ('P2', 'R0', 'V2C'):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=path)
        return
    if isinstance(want, (bool, np.bool_)):
        assert bool(got) == bool(want), path
        return
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert got.keys() == want.keys(), (path, sorted(got), sorted(want))
        for k in want:
            assert_deep_equal(got[k], want[k], f'{path}.{k}')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_deep_equal(g, w, f'{path}[{i}]')
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, (path, got, want)


@pytest.fixture(scope='module')
def mini(tmp_path_factory):
    """The port's mini set with its infos and GT database."""
    root = tmp_path_factory.mktemp('mini_kitti_camera') / 'kitti'
    t_syn.make_mini_kitti(root)
    cwd = Path.cwd()
    try:
        import os
        os.chdir(REPO)
        ds = cfg_from_yaml_file('configs/dataset_configs/kitti_dataset.yaml')
    finally:
        os.chdir(cwd)
    t_kitti.create_kitti_infos(ds, CLASS_NAMES, root, root, workers=1)
    return root


def caddn_data_cfg(root, copy_paste: bool = False, map_shape: bool = True) -> CfgNode:
    """`caddn_kitti()`'s data path on the mini set; with `copy_paste` the GT
    sampler's image copy-paste first in its augmentations."""
    cfg = synthetic.caddn_kitti().DATA_CONFIG
    cfg.DATA_PATH = str(root)
    cfg.MAX_GT_BOXES = 32
    if copy_paste:
        cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST.insert(0, CfgNode(GT_SAMPLING))
    if not map_shape:
        del cfg.DATA_PROCESSOR[0]['MAP_SHAPE']
    return cfg


def both_datasets(cfg, root, training: bool):
    return (t_kitti.KittiDataset(cfg, CLASS_NAMES, training=training, root_path=root),
            j_kitti.KittiDataset(JCfgNode(cfg.to_dict()), CLASS_NAMES, training=training,
                                 root_path=root))


def frame(root, idx: str, images: bool = True) -> dict:
    """A frame of the mini set as the augmentors take it (the port's
    calibration object: both packages' have the same methods)."""
    from pdm_ssd_torch.datasets.kitti.calibration import Calibration
    from pdm_ssd_torch.datasets.kitti.kitti_utils import boxes3d_kitti_camera_to_lidar
    from pdm_ssd_torch.datasets.kitti.object3d import LabelTable
    calib = Calibration(str(root / 'training/calib' / f'{idx}.txt'))
    tab = LabelTable.from_file(root / 'training/label_2' / f'{idx}.txt')
    cam = np.concatenate([tab.loc, tab.dims, tab.ry[:, None]], -1)
    out = {'points': np.fromfile(str(root / 'training/velodyne' / f'{idx}.bin'),
                                 np.float32).reshape(-1, 4),
           'calib': calib,
           'gt_boxes': boxes3d_kitti_camera_to_lidar(cam, calib).astype(np.float32),
           'gt_names': np.asarray(tab.name)}
    if images:
        out['images'] = image_ops.read_png(root / 'training/image_2' / f'{idx}.png') \
            .astype(np.float32) / 255.0
        out['gt_boxes2d'] = tab.bbox.astype(np.float32)
    return out


def copy_of(dd: dict) -> dict:
    return {k: v.copy() if isinstance(v, np.ndarray) else v for k, v in dd.items()}


# ---- images ---------------------------------------------------------------------------

def test_generator_writes_the_jax_generators_pixels(mini, tmp_path):
    """The port's PNGs (written by `image_ops.write_png`) decode, by PIL and
    by `image_ops.read_png`, to the pixels of the JAX generator's PNGs
    (written by PIL) for the same frames; the files' bytes differ."""
    for fid in ('000000', '000002'):
        j_syn.write_png_header(tmp_path / f'{fid}.png', seed=int(fid))
        want = np.asarray(Image.open(tmp_path / f'{fid}.png').convert('RGB'))
        port = mini / 'training/image_2' / f'{fid}.png'
        np.testing.assert_array_equal(image_ops.read_png(port), want)
        np.testing.assert_array_equal(np.asarray(Image.open(port).convert('RGB')), want)
        assert want.shape == (t_syn.IMG_H, t_syn.IMG_W, 3)
        assert port.read_bytes() != (tmp_path / f'{fid}.png').read_bytes()


def test_get_image_matches_jax(mini):
    """`KittiDataset.get_image` without PIL: the JAX package's PIL read, the
    same (H, W, 3) float32 over 255, for every frame."""
    t_ds, j_ds = both_datasets(caddn_data_cfg(mini), mini, training=False)
    for idx in t_ds.sample_id_list:
        got, want = t_ds.get_image(idx), j_ds.get_image(idx)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# ---- steps ----------------------------------------------------------------------------

def test_depth_map_steps_match_jax(mini):
    """`generate_depth_map` at MAP_SHAPE (the nearest point a pixel) and
    `downsample_depth_map` (block means of the zero-padded map at 8 and at
    5) equal to the JAX package's, on every frame's cloud."""
    for f in (8, 5):
        procs = [{'NAME': 'generate_depth_map', 'MAP_SHAPE': [375, 1242]},
                 {'NAME': 'downsample_depth_map', 'DOWNSAMPLE_FACTOR': f}]
        t_proc = TProcessor([CfgNode(p) for p in procs], synthetic.CADDN_RANGE, True, 4)
        j_proc = JProcessor([JCfgNode(p) for p in procs], synthetic.CADDN_RANGE, True, 4)
        for idx in ('000000', '000001', '000002'):
            dd = frame(mini, idx, images=False)
            got, want = t_proc.forward(copy_of(dd)), j_proc.forward(copy_of(dd))
            assert got['depth_maps'].shape == (-(-375 // f), -(-1242 // f))
            np.testing.assert_array_equal(got['depth_maps'], want['depth_maps'])
            assert (got['depth_maps'] > 0).mean() > 0.01


def test_random_image_flip_matches_jax(mini):
    """`random_image_flip` under the same `np.random` seeds, flipped and not:
    the image, the depth map where the sample has one, the boxes mirrored
    through the calibration and the draw, equal to the JAX package's."""
    cfg = [CfgNode({'NAME': 'random_image_flip', 'ALONG_AXIS_LIST': ['horizontal']})]
    t_aug = TAugmentor(mini, cfg, CLASS_NAMES)
    j_aug = JAugmentor(mini, [JCfgNode(c.to_dict()) for c in cfg], CLASS_NAMES)
    flips = set()
    for seed in range(4):
        dd = frame(mini, f'{seed % 3:06d}')
        if seed % 2:
            dd['depth_maps'] = np.random.RandomState(seed).rand(375, 1242).astype(np.float32)
        np.random.seed(seed)
        got = t_aug.forward(copy_of(dd))
        np.random.seed(seed)
        want = j_aug.forward(copy_of(dd))
        assert_deep_equal(got, want, f'seed {seed}')
        flips.add(bool(got['image_flip']))
    assert flips == {False, True}


def test_image_copy_paste_matches_jax(mini):
    """The GT sampler with IMG_AUG_TYPE 'kitti' on a frame, the same seed:
    the pasted image (crops resized by `image_ops.resize` against PIL's
    bicubic), the points kept, the boxes moved into the target calibration
    and the 2D boxes, equal to the JAX package's."""
    cfg = dict(GT_SAMPLING, DB_INFO_PATH=['kitti_dbinfos_train.pkl'])
    t_s = t_db.DataBaseSampler(mini, CfgNode(cfg), ['Car'])
    j_s = j_db.DataBaseSampler(mini, JCfgNode(cfg), ['Car'])
    for seed, idx in ((0, '000001'), (1, '000002')):
        dd = frame(mini, idx)
        np.random.seed(seed)
        got = t_s(copy_of(dd))
        np.random.seed(seed)
        want = j_s(copy_of(dd))
        assert_deep_equal(got, want, idx)
        assert len(got['gt_boxes2d']) > len(dd['gt_boxes2d'])
        assert (got['images'] != dd['images']).any()


def test_shared_memory_database_matches_jax(mini, tmp_path, monkeypatch):
    """USE_SHARED_MEMORY: a stacked database of the mini set's GT crops
    (DB_DATA_PATH, infos with 'global_data_offset'), copied by each package
    into a shared-memory directory (a temporary one here, not /dev/shm) and
    read from the map: the same samples as the JAX package's, and the same
    as reading the crops' files."""
    infos = pickle.loads((mini / 'kitti_dbinfos_train.pkl').read_bytes())
    rows, at = [], 0
    for info in infos['Car']:
        pts = np.fromfile(str(mini / info['path']), np.float32).reshape(-1, 4)
        info['global_data_offset'] = (at, at + len(pts))
        rows.append(pts)
        at += len(pts)
    np.save(mini / 'gt_database_data_stacked.npy', np.concatenate(rows))
    (mini / 'kitti_dbinfos_stacked.pkl').write_bytes(pickle.dumps(infos))
    shm = tmp_path / 'shm'
    shm.mkdir()
    monkeypatch.setattr(t_db, 'SHARED_MEMORY_DIR', shm)
    real_path = j_db.Path
    monkeypatch.setattr(j_db, 'Path', lambda p: real_path(shm if str(p) == '/dev/shm' else p))
    cfg = dict(GT_SAMPLING, DB_INFO_PATH=['kitti_dbinfos_stacked.pkl'], IMG_AUG_TYPE=None,
               DB_DATA_PATH=['gt_database_data_stacked.npy'], USE_SHARED_MEMORY=True)
    t_s = t_db.DataBaseSampler(mini, CfgNode(cfg), ['Car'])
    j_s = j_db.DataBaseSampler(mini, JCfgNode(cfg), ['Car'])
    files = t_db.DataBaseSampler(mini, CfgNode(dict(cfg, USE_SHARED_MEMORY=False)), ['Car'])
    assert isinstance(t_s.db_data, np.memmap) and files.db_data is None
    assert [p.name for p in shm.iterdir()] == ['gt_database_data_stacked.npy']
    for seed, idx in ((0, '000000'), (1, '000002')):
        dd = frame(mini, idx, images=False)
        outs = []
        for s in (t_s, j_s, files):
            np.random.seed(seed)
            outs.append(s(copy_of(dd)))
        assert_deep_equal(outs[0], outs[1], idx)
        assert_deep_equal(outs[0], outs[2], idx)
        assert len(outs[0]['gt_boxes']) > len(dd['gt_boxes'])


# ---- the data path --------------------------------------------------------------------

@pytest.mark.parametrize('training', [False, True])
def test_camera_samples_and_batches_match_jax(mini, training):
    """Every sample of `caddn_kitti()`'s data path on the mini set (training:
    the image copy-paste and the image flip on), `np.random` seeded the same
    before each, equal to the JAX package's, and the collated batch: the
    images and depth maps stacked, the 2D boxes padded with their mask."""
    t_ds, j_ds = both_datasets(caddn_data_cfg(mini, copy_paste=training), mini, training)
    t_samples, j_samples = [], []
    for i in range(len(t_ds)):
        np.random.seed(30 + i)
        t_samples.append(t_ds[i])
        np.random.seed(30 + i)
        j_samples.append(j_ds[i])
        assert_deep_equal(t_samples[-1], j_samples[-1], f'sample {i}')
        assert t_samples[-1]['depth_maps'].shape == (47, 156)
    got, want = t_ds.collate_batch(t_samples), j_ds.collate_batch(j_samples)
    assert_deep_equal(got, want, 'batch')
    assert got['images'].shape == (3, 375, 1242, 3) and got['gt_boxes2d'].shape == (3, 32, 4)
    assert got['gt_boxes2d_mask'].sum() >= 3


# ---- the reference's faults (ROADMAP Queue 3) -----------------------------------------

def test_kitti_batch_lacks_caddns_inputs_in_either_package(mini):
    """CaDDN reads 'camera_imgs', 'trans_lidar_to_cam' and 'trans_cam_to_img';
    a KITTI camera batch of either package holds 'images', 'gt_boxes2d' and
    the calibration objects and none of the three, while the JAX trainer's
    batch filter keeps the three keys that nothing makes.
    `synthetic.caddn_camera_inputs` makes them, and the port's device batch
    then carries them."""
    from pdm_ssd_tpu.runtime.trainer import _filter_device_batch
    t_ds, j_ds = both_datasets(caddn_data_cfg(mini), mini, training=False)
    t_batch = t_ds.collate_batch([t_ds[i] for i in range(2)])
    j_batch = j_ds.collate_batch([j_ds[i] for i in range(2)])
    missing = {'camera_imgs', 'trans_lidar_to_cam', 'trans_cam_to_img'}
    for batch in (t_batch, j_batch):
        assert {'images', 'gt_boxes2d', 'calib'} <= set(batch) and not missing & set(batch)
    kept = set(_filter_device_batch({k: 0 for k in missing | {'images'}}))
    assert kept == missing
    bridged = synthetic.caddn_camera_inputs(t_batch)
    assert bridged['camera_imgs'].shape == (2, 1, 375, 1242, 3)
    l2c, c2i = bridged['trans_lidar_to_cam'][0], bridged['trans_cam_to_img'][0]
    calib = t_batch['calib'][0]
    pts = t_ds[0]['points'][:50, :3]
    uvw = np.concatenate([pts, np.ones((50, 1), np.float32)], 1) @ l2c.T @ c2i.T
    np.testing.assert_allclose(uvw[:, :2] / uvw[:, 2:], calib.lidar_to_img(pts)[0], rtol=1e-5)
    assert missing <= set(to_device_batch(bridged, 'cpu', INPUT_KEYS))
    assert {'depth_maps', 'gt_boxes2d', 'gt_boxes2d_mask'} <= set(
        to_device_batch(bridged, 'cpu', DEVICE_KEYS))


def test_depth_map_without_map_shape_raises_in_either_package(mini):
    """`generate_depth_map` without MAP_SHAPE reads the sample's
    'image_shape', which KITTI sets only after the data path has run: both
    packages raise `KeyError` there. With MAP_SHAPE both run."""
    for cfg in (caddn_data_cfg(mini, map_shape=False), caddn_data_cfg(mini)):
        for ds in both_datasets(cfg, mini, training=False):
            if 'MAP_SHAPE' in cfg.DATA_PROCESSOR[0]:
                assert ds[0]['depth_maps'].shape == (47, 156)
            else:
                with pytest.raises(KeyError, match='image_shape'):
                    ds[0]


def test_flipped_frames_depth_targets_are_the_unflipped_scenes_in_either_package(mini):
    """The image flip runs in the augmentor, before `generate_depth_map`
    projects the points, which it does not mirror: on a flipped frame the
    image is mirrored and the depth target is the unflipped scene's, the
    same map as on the same frame unflipped, in both packages."""
    for ds in both_datasets(caddn_data_cfg(mini), mini, training=True):
        by_flip = {}
        for seed in range(8):
            np.random.seed(seed)
            s = ds[0]
            by_flip.setdefault(bool(s['image_flip']), s)
        flipped, plain = by_flip[True], by_flip[False]
        np.testing.assert_array_equal(flipped['images'], plain['images'][:, ::-1])
        np.testing.assert_array_equal(flipped['depth_maps'], plain['depth_maps'])
        assert not np.array_equal(flipped['depth_maps'], flipped['depth_maps'][:, ::-1])
