"""The camera half of nuScenes in the port against the JAX package, on the
CPU: `datasets/image_ops` (PNG on zlib, PIL's bicubic resize, crop, flip
and nearest-pixel rotation without PIL) against PIL; the generator's
CAM_FRONT stream (the tables byte for byte, the images pixel for pixel);
the infos' camera blocks; and `bevfusion_mini.yaml`'s dataset (the camera
transforms, each image's resize and crop, `imgaug`, `image_normalize`,
`image_calibrate`, `generate_camera_depth`) sample for sample and batch
for batch in test and training mode.

Inputs come from numpy seeds. Each tolerance stands beside its reason.
"""
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from pdm_ssd_torch.datasets import image_ops
from pdm_ssd_torch.datasets.nuscenes import nuscenes_info as t_info
from pdm_ssd_torch.datasets.nuscenes.nuscenes_dataset import NuScenesDataset as TDataset
from pdm_ssd_torch.runtime.trainer import CAMERA_KEYS, INPUT_KEYS, to_device_batch
from pdm_ssd_torch.utils.config import CfgNode, cfg_from_yaml_file
from pdm_ssd_tpu.datasets.nuscenes import nuscenes_info as j_info
from pdm_ssd_tpu.datasets.nuscenes import synthetic as j_syn
from pdm_ssd_tpu.datasets.nuscenes.nuscenes_dataset import NuScenesDataset as JDataset
from pdm_ssd_tpu.datasets.processor.data_processor import DataProcessor as JProcessor
from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
from torch_port_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
# PIL's resampling in 22-bit fixed point; the port's computes the same sums
# (measured: every pixel equal); the bound is one grey level
RESIZE_LEVELS = 1
SAMPLES = 6


def _image(rng, h, w) -> np.ndarray:
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    img[h // 3:h // 2, w // 4:w // 2] = 255          # a flat patch and its edges
    return img


# ---- image_ops against PIL ----------------------------------------------------------

@pytest.mark.parametrize('kind', ['RGB', 'L', 'RGBA'])
def test_png_round_trip_against_pil(kind, tmp_path):
    """The port's PNG (filter type 0) decoded by PIL, and PIL's PNG (its own
    filter choice a row: Sub, Up, Average and Paeth appear) decoded by the
    port, pixel for pixel; grey repeated and alpha dropped as PIL's
    `convert('RGB')` does."""
    rng = np.random.RandomState(0)
    img = _image(rng, 37, 53)
    image_ops.write_png(tmp_path / 'port.png', img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / 'port.png')), img)
    pil = {'RGB': img, 'L': img[..., 0], 'RGBA': np.dstack([img, img[..., :1]])}[kind]
    Image.fromarray(pil).save(tmp_path / 'pil.png')
    want = np.asarray(Image.open(tmp_path / 'pil.png').convert('RGB'))
    np.testing.assert_array_equal(image_ops.read_png(tmp_path / 'pil.png'), want)
    np.testing.assert_array_equal(image_ops.read_image(tmp_path / 'pil.png'), want)


def test_read_image_refuses_jpeg(tmp_path):
    """A JPEG (the nuScenes release's camera files) raises: the port carries
    no JPEG decoder."""
    Image.fromarray(_image(np.random.RandomState(1), 16, 16)).save(tmp_path / 'a.jpg')
    with pytest.raises(NotImplementedError, match='JPEG'):
        image_ops.read_image(tmp_path / 'a.jpg')


@pytest.mark.parametrize('scale', [0.5, 0.48, 0.38, 0.55, 1.3])
def test_resize_matches_pil(scale):
    """PIL's default resize (bicubic, the support widened on shrinking, a
    horizontal then a vertical pass rounded to uint8 each) at the resize
    factors of the two BEVFusion configs and an enlargement, on a 128 x 192
    image (the generator's) and an odd 37 x 53 one: within RESIZE_LEVELS."""
    rng = np.random.RandomState(2)
    for h, w in ((128, 192), (37, 53)):
        img = _image(rng, h, w)
        size = (int(w * scale), int(h * scale))
        want = np.asarray(Image.fromarray(img).resize(size))
        got = image_ops.resize(img, size)
        assert got.shape == want.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want).max() <= RESIZE_LEVELS


def test_crop_flip_and_rotate_match_pil():
    """`crop` with boxes inside and across every edge (zeros outside),
    `flip_left_right`, and `rotate` at imgaug's angles (within +-5.4
    degrees), at PIL's fast paths (0, 90, 180, 270 on a square and an oblong
    image) and elsewhere: every pixel equal."""
    rng = np.random.RandomState(3)
    for h, w in ((64, 96), (48, 48)):
        img = _image(rng, h, w)
        pil = Image.fromarray(img)
        for box in [(0, 0, 10, 10), (-5, -3, 20, 30), (w - 5, h - 5, w + 10, h + 7),
                    (10, h - 20, 60, h + 4)]:
            np.testing.assert_array_equal(image_ops.crop(img, box), np.asarray(pil.crop(box)))
        np.testing.assert_array_equal(image_ops.flip_left_right(img),
                                      np.asarray(pil.transpose(Image.FLIP_LEFT_RIGHT)))
        for angle in [0, 5.4, -5.4, 3.3, -0.01, 90, 180, 270, 45, 359.9,
                      *rng.uniform(-5.4, 5.4, 6)]:
            np.testing.assert_array_equal(image_ops.rotate(img, float(angle)),
                                          np.asarray(pil.rotate(float(angle))),
                                          err_msg=str(angle))


# ---- the generator and the infos ----------------------------------------------------

def _files(root: Path) -> list:
    return sorted(p.relative_to(root) for p in root.rglob('*') if p.is_file())


@pytest.fixture(scope='module')
def mini(tmp_path_factory):
    """A mini set of SAMPLES frames with the CAM_FRONT stream, written by the
    port's tool and by the JAX package's generator, at one sweep."""
    from pdm_ssd_torch.tools import make_mini_nuscenes
    base = tmp_path_factory.mktemp('nuscenes_cams')
    make_mini_nuscenes.main(['--root', str(base / 'port'), '--samples', str(SAMPLES), '--cams'])
    j_syn.make_mini_nuscenes(base / 'jax', with_cams=True, n_samples=SAMPLES, max_sweeps=1)
    return base / 'port', base / 'jax'


def test_generator_writes_the_jax_generators_tables_and_pixels(mini):
    """The same files; the tables and sweeps byte for byte; each camera
    image the same pixels (the JAX package's is written by PIL, the port's
    by `image_ops.write_png`, so their bytes differ), with the car's dot."""
    t_root, j_root = mini
    assert _files(t_root) == _files(j_root)
    pngs = [rel for rel in _files(j_root) if rel.suffix == '.png']
    assert len(pngs) == SAMPLES
    for rel in _files(j_root):
        if rel.suffix == '.png':
            got = image_ops.read_png(t_root / rel)
            np.testing.assert_array_equal(got, np.asarray(Image.open(j_root / rel)))
            assert (got == 255).sum() == 7 * 7 * 3
        elif rel.suffix != '.pkl':
            assert (t_root / rel).read_bytes() == (j_root / rel).read_bytes(), rel


def test_infos_carry_the_jax_packages_camera_blocks(mini):
    """`create_nuscenes_infos` on the tables with cameras: each info's
    'cams' block (the image path, the intrinsics, the sensor-to-LiDAR and
    sensor-to-ego transforms) equal to the JAX package's on the same
    tables."""
    t_root, _ = mini
    got = pickle.loads((t_root / 'nuscenes_infos_1sweeps_train.pkl').read_bytes())
    j_info.create_nuscenes_infos(t_root, 'v1.0-mini', max_sweeps=1)
    want = pickle.loads((t_root / 'nuscenes_infos_1sweeps_train.pkl').read_bytes())
    t_info.create_nuscenes_infos(t_root, 'v1.0-mini', max_sweeps=1)
    assert len(got) == len(want) == SAMPLES
    for g, w in zip(got, want):
        assert set(g['cams']) == set(w['cams']) == {'CAM_FRONT'}
        gc, wc = g['cams']['CAM_FRONT'], w['cams']['CAM_FRONT']
        assert set(gc) == set(wc)
        for k, v in wc.items():
            if isinstance(v, str):
                assert gc[k] == v
            else:
                np.testing.assert_array_equal(np.asarray(gc[k]), np.asarray(v), err_msg=k)


# ---- the dataset --------------------------------------------------------------------

def mini_cfg(root):
    """`bevfusion_mini.yaml`'s data config reading the mini set at `root`."""
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        cfg = cfg_from_yaml_file('configs/nuscenes_models/bevfusion_mini.yaml', CfgNode())
    finally:
        os.chdir(cwd)
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    return cfg


def _assert_equal(got, want, where=''):
    assert set(got) == set(want), (where, set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        if k == 'voxel_coords':     # int64 from the JAX package's numpy voxelizer
            w = w.astype(np.int32)
        if isinstance(w, np.ndarray) and w.dtype != object:
            assert g.dtype == w.dtype and g.shape == w.shape, (where, k, g.shape, w.shape)
            np.testing.assert_array_equal(g, w, err_msg=f'{where} {k}')
        elif isinstance(w, (list, tuple, np.ndarray)) and len(w) and not isinstance(w[0], str):
            assert len(g) == len(w), (where, k)
            for gi, wi in zip(g, w):
                if isinstance(wi, np.ndarray):
                    np.testing.assert_array_equal(gi, wi, err_msg=f'{where} {k}')
                else:
                    assert gi == wi or list(gi) == list(wi), (where, k, gi, wi)
        else:
            assert g == w or list(g) == list(w), (where, k)


@pytest.mark.parametrize('training', [False, True])
def test_camera_samples_and_batches_match_jax(mini, training, monkeypatch):
    """`NuScenesDataset` of `bevfusion_mini.yaml` in both packages on the
    same infos under one `np.random` seed: every sample equal bit for bit
    (the camera transforms, the normalized 64 x 96 images after each one's
    resize and crop, and in training the world augmentations and `imgaug`'s
    flip and rotation, 'img_aug_matrix', the sparse 'camera_depth', the
    voxels), then `collate_batch` of them; the collated camera keys reach
    the device batch. The JAX package's C voxelizer orders cells by first
    appearance, so its numpy one (`_numpy_voxelize`, the contract the port
    keeps) runs here."""
    monkeypatch.setattr(JProcessor, '_native_voxelize', lambda self, *a: None)
    t_root, j_root = mini
    sets = []
    for root, Dataset, Node in ((t_root, TDataset, CfgNode), (j_root, JDataset, JCfgNode)):
        cfg = mini_cfg(root)
        np.random.seed(4)
        sets.append(Dataset(Node(cfg.DATA_CONFIG.to_dict()), cfg.CLASS_NAMES, training=training,
                            root_path=root))
    t_ds, j_ds = sets
    assert len(t_ds) == len(j_ds) > 0
    samples = {}
    for name, ds in (('port', t_ds), ('jax', j_ds)):
        np.random.seed(12)
        samples[name] = [ds[i] for i in range(len(ds))]
    for i, (g, w) in enumerate(zip(samples['port'], samples['jax'])):
        _assert_equal(g, w, f'sample {i}')
        assert g['camera_imgs'].shape == (1, 64, 96, 3) and g['camera_imgs'].dtype == np.float32
        assert (g['camera_depth'] > 0).sum() > 10
    if training:        # imgaug drew a flip and a rotation for some image
        infos = [s['img_process_infos'][0] for s in samples['port']]
        assert any(info[2] for info in infos) and all(info[3] != 0 for info in infos)
    got = t_ds.collate_batch(samples['port'][:3])
    want = j_ds.collate_batch(samples['jax'][:3])
    _assert_equal(got, want, 'batch')
    device = to_device_batch(got, 'cpu', INPUT_KEYS)
    assert set(CAMERA_KEYS) <= set(device)
    assert device['camera_imgs'].shape == (3, 1, 64, 96, 3)
