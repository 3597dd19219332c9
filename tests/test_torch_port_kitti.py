"""The port's KITTI data path, evaluator, eval loop, checkpoints and CLIs
against the JAX package, on the CPU.

The mini set (3 frames, Car only, as `tests/test_kitti_e2e.py` builds it) is
generated once per module by each package's own generator. Every sample of
both splits, drawn under the same `np.random` seed, must be equal exactly;
the evaluator must print the same result; the eval loop over the tiny
flagship, with the same weights in both packages and the score threshold at
0 so that every frame has detections, must keep the same detections and
score the same recall and AP R40.
"""
import copy
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from pdm_ssd_torch.datasets import build_dataloader as t_build_dataloader
from pdm_ssd_torch.datasets.kitti import eval as t_eval
from pdm_ssd_torch.datasets.kitti import kitti_dataset as t_kitti
from pdm_ssd_torch.datasets.kitti import synthetic as t_syn
from pdm_ssd_torch.utils.config import CfgNode, cfg_from_yaml_file
from pdm_ssd_tpu.datasets import build_dataloader as j_build_dataloader
from pdm_ssd_tpu.datasets.kitti import eval as j_eval
from pdm_ssd_tpu.datasets.kitti import kitti_dataset as j_kitti
from pdm_ssd_tpu.datasets.kitti import synthetic as j_syn
from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode

from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
CLASS_NAMES = ['Car', 'Pedestrian', 'Cyclist']
N_POINTS = 2048
# detections of the eval loop: boxes within this share of a frame's box
# scale, scores within this; the two forwards differ by float32 rounding
# (the port runs under `jax_bf16_extraction`)
DET_RTOL = 1e-3
SCORE_ATOL = 1e-3
METRIC_ATOL = 1e-4


def load_cfg(rel: str):
    """A config of the repo through the port's loader (its base config is
    named relative to the repo)."""
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        return cfg_from_yaml_file(str(REPO / rel))
    finally:
        os.chdir(cwd)


def dataset_cfg(root):
    cfg = load_cfg('configs/dataset_configs/kitti_dataset.yaml')
    cfg.DATA_PATH = str(root)
    cfg.DATA_PROCESSOR[2]['NUM_POINTS'] = {'train': N_POINTS, 'test': N_POINTS}
    cfg.MAX_GT_BOXES = 32
    return cfg


@pytest.fixture(scope='module')
def mini(tmp_path_factory):
    """(port root, JAX root): the same set from each package's generator and
    `create_kitti_infos`."""
    base = tmp_path_factory.mktemp('mini_kitti')
    roots = base / 'port', base / 'jax'
    t_syn.make_mini_kitti(roots[0])
    j_syn.make_mini_kitti(roots[1])
    t_kitti.create_kitti_infos(dataset_cfg(roots[0]), CLASS_NAMES, roots[0], roots[0], workers=1)
    j_kitti.create_kitti_infos(JCfgNode(dataset_cfg(roots[1]).to_dict()), CLASS_NAMES, roots[1],
                               roots[1], workers=1)
    return roots


def assert_deep_equal(got, want, path=''):
    if hasattr(want, 'P2'):         # a Calibration of either package
        assert type(got).__name__ == type(want).__name__ == 'Calibration', path
        for k in ('P2', 'R0', 'V2C'):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=path)
        return
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
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


def test_generator_and_infos_match_jax(mini):
    """Identical frame, label, calib and split files, the same image shapes
    (both generators write decodable PNGs of the same pixels, PIL's bytes
    and the port's differ: `tests/test_torch_port_kitti_camera.py`),
    deep-equal info and dbinfo pickles and GT database."""
    t_root, j_root = mini
    for sub in ('training/velodyne', 'training/label_2', 'training/calib', 'ImageSets',
                'gt_database'):
        t_files = sorted(p.name for p in (t_root / sub).iterdir())
        assert t_files == sorted(p.name for p in (j_root / sub).iterdir()) and t_files, sub
        for f in t_files:
            assert (t_root / sub / f).read_bytes() == (j_root / sub / f).read_bytes(), (sub, f)
    t_ds = t_kitti.KittiDataset(dataset_cfg(t_root), CLASS_NAMES, training=False,
                                root_path=t_root)
    j_ds = j_kitti.KittiDataset(JCfgNode(dataset_cfg(j_root).to_dict()), CLASS_NAMES,
                                training=False, root_path=j_root)
    for idx in t_ds.sample_id_list:
        np.testing.assert_array_equal(t_ds.get_image_shape(idx), j_ds.get_image_shape(idx))
    pickles = sorted(p.name for p in t_root.glob('*.pkl'))
    assert pickles == sorted(p.name for p in j_root.glob('*.pkl'))
    assert 'kitti_dbinfos_train.pkl' in pickles and 'kitti_infos_val.pkl' in pickles
    for name in pickles:
        assert_deep_equal(pickle.loads((t_root / name).read_bytes()),
                          pickle.loads((j_root / name).read_bytes()), name)


@pytest.mark.parametrize('split', ['train', 'val'])
def test_samples_and_batches_match_jax_exactly(mini, split):
    """Every index of the split, `np.random` seeded the same before each
    side's `__getitem__` (training: GT sampling, flip, rotation and scaling
    on): the same points, boxes and mask, and the same collated batch."""
    training = split == 'train'
    t_root, j_root = mini
    t_ds = t_kitti.KittiDataset(dataset_cfg(t_root), CLASS_NAMES, training=training,
                                root_path=t_root)
    j_ds = j_kitti.KittiDataset(JCfgNode(dataset_cfg(j_root).to_dict()), CLASS_NAMES,
                                training=training, root_path=j_root)
    assert len(t_ds) == len(j_ds) == 3
    t_samples, j_samples = [], []
    for i in range(len(t_ds)):
        for ds, out in ((t_ds, t_samples), (j_ds, j_samples)):
            np.random.seed(100 + i)
            out.append(ds[i])
    for t, j in zip(t_samples, j_samples):
        assert t['points'].shape == (N_POINTS, 4)
        assert_deep_equal(t, j)
    t_batch, j_batch = t_ds.collate_batch(t_samples), j_ds.collate_batch(j_samples)
    assert t_batch['gt_mask'].sum() >= 3
    assert_deep_equal(t_batch, j_batch)


@pytest.fixture(scope='module')
def rich_infos(tmp_path_factory):
    """GT annos of a small three-class set (every difficulty band)."""
    root = tmp_path_factory.mktemp('rich_kitti')
    t_syn.make_mini_kitti(root, n_frames=10, n_bg=300, classes=tuple(CLASS_NAMES))
    t_kitti.create_kitti_infos(dataset_cfg(root), CLASS_NAMES, root, root, workers=1)
    return pickle.loads((root / 'kitti_infos_val.pkl').read_bytes())


def jittered_detections(infos, seed: int) -> list:
    """Camera-frame detections from the GT: boxes jittered, a fifth dropped,
    a false positive per frame, random scores."""
    rng = np.random.RandomState(seed)
    dets = []
    for info in infos:
        gt = info['annos']
        care = gt['name'] != 'DontCare'
        keep = care & (rng.rand(len(care)) > 0.2)
        n = int(keep.sum())
        loc = gt['location'][keep] + rng.normal(0, 0.15, (n, 3))
        det = {
            'name': np.concatenate([gt['name'][keep], ['Car']]),
            'truncated': np.zeros(n + 1), 'occluded': np.zeros(n + 1),
            'alpha': np.concatenate([gt['alpha'][keep] + rng.normal(0, 0.1, n), [0.3]]),
            'bbox': np.concatenate([gt['bbox'][keep] + rng.normal(0, 2.0, (n, 4)),
                                    [[100., 150., 180., 210.]]]),
            'dimensions': np.concatenate([gt['dimensions'][keep]
                                          * (1 + rng.normal(0, 0.05, (n, 3))),
                                          [[3.9, 1.56, 1.6]]]),
            'location': np.concatenate([loc, [[-4.0, 1.6, 20.0]]]),
            'rotation_y': np.concatenate([gt['rotation_y'][keep] + rng.normal(0, 0.1, n),
                                          [0.2]]),
            'score': rng.rand(n + 1),
        }
        dets.append(det)
    return dets


def test_official_eval_matches_jax(rich_infos):
    """The same result string and every entry within 1e-6, for every class
    and difficulty, on jittered detections."""
    gt = [info['annos'] for info in rich_infos]
    names = set(np.concatenate([g['name'] for g in gt]))
    assert {'Car', 'Pedestrian', 'Cyclist'} <= names
    dets = jittered_detections(rich_infos, seed=3)
    t_str, t_dict = t_eval.get_official_eval_result(copy.deepcopy(gt), copy.deepcopy(dets),
                                                    CLASS_NAMES)
    j_str, j_dict = j_eval.get_official_eval_result(copy.deepcopy(gt), copy.deepcopy(dets),
                                                    CLASS_NAMES)
    assert t_str == j_str
    assert t_dict.keys() == j_dict.keys()
    assert any(v > 10 for k, v in t_dict.items() if 'R40' in k)
    for k, v in j_dict.items():
        assert abs(t_dict[k] - v) <= 1e-6, (k, t_dict[k], v)


def test_boxes_iou3d_matches_jax():
    """Random boxes, rotated copies, boxes touching on a face and disjoint
    ones: within 1e-5 of the JAX package's 3D IoU."""
    from pdm_ssd_torch.ops import iou3d as t_iou
    from pdm_ssd_tpu.ops import iou3d as j_iou
    rng = np.random.RandomState(4)
    a = np.concatenate([rng.uniform(-4, 4, (24, 3)), rng.uniform(0.5, 4, (24, 3)),
                        rng.uniform(-np.pi, np.pi, (24, 1))], 1).astype(np.float32)
    rotated = a.copy()
    rotated[:, 6] += rng.uniform(-0.6, 0.6, 24)
    touching = a.copy()
    touching[:, 0] += a[:, 3]
    touching[:, 6] = a[:, 6] = 0.0
    disjoint = a.copy()
    disjoint[:, :2] += 50.0
    b = np.concatenate([a[:8], rotated[:8], touching[:8], disjoint[:8]]).astype(np.float32)
    got = t_iou.boxes_iou3d(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(j_iou.boxes_iou3d(a, b))
    assert got.shape == (24, 32)
    assert (got[:, 24:] == 0).all() and (got[np.arange(8), np.arange(8)] > 0.999).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def tiny_flagship_cfg(root):
    """The tiny flagship on the mini set, score thresholds at 0."""
    from pdm_ssd_torch.utils import synthetic
    cfg = synthetic.tiny_flagship_cfg(load_cfg('configs/kitti_models/pdm_ssd_point.yaml'))
    cfg.DATA_CONFIG = dataset_cfg(root)
    cfg.MODEL.POST_PROCESSING.SCORE_THRESH = 0.0
    cfg.MODEL.DENSE_HEAD.POST_PROCESSING.SCORE_THRESH = 0.0
    return cfg


def match_frame(got: dict, want: dict, frame: str) -> None:
    """Every port detection paired with a distinct JAX detection of the same
    class, box within DET_RTOL of the frame's box scale, score within
    SCORE_ATOL. Matched by box, not by slot: near-tied scores may permute
    the kept slots, as chip_smoke.py phases 10 and 14 allow."""
    assert len(got['name']) == len(want['name']), frame
    scale = max(float(np.abs(want['boxes_lidar']).max()), 1e-6)
    free = np.ones(len(want['name']), bool)
    for i in range(len(got['name'])):
        d = np.abs(want['boxes_lidar'] - got['boxes_lidar'][i]).max(axis=1)
        d = np.where(free & (want['name'] == got['name'][i]), d, np.inf)
        j = int(np.argmin(d))
        assert d[j] <= DET_RTOL * scale, (frame, i, d[j])
        assert abs(got['score'][i] - want['score'][j]) <= SCORE_ATOL, (frame, i)
        free[j] = False


def test_eval_loop_matches_jax(mini, tmp_path):
    """`eval_one_epoch` of both packages over the val split at B=2 (the last
    batch partial), the same weights: the same number of detections in every
    frame (at least one), matched by box and class, recall and every AP R40
    entry within 1e-4, `result.pkl` written."""
    import jax
    from pdm_ssd_torch.runtime import eval_utils as t_eval_utils
    from pdm_ssd_tpu.runtime import eval_utils as j_eval_utils
    from torch_port_harness import ModelPair, jax_bf16_extraction
    t_root, j_root = mini
    cfg = tiny_flagship_cfg(t_root)
    pair = ModelPair(cfg, B=1, N=512, seed=2)
    t_set, t_loader, _ = t_build_dataloader(cfg.DATA_CONFIG, CLASS_NAMES, batch_size=2,
                                            root_path=t_root, workers=0, training=False)
    j_set, j_loader, _ = j_build_dataloader(JCfgNode(dataset_cfg(j_root).to_dict()),
                                            CLASS_NAMES, batch_size=2, root_path=j_root,
                                            workers=0, training=False)
    np.random.seed(7)       # `sample_points` draws the test-time points too
    with jax_bf16_extraction():
        got = t_eval_utils.eval_one_epoch(pair.net, t_loader, t_set, CLASS_NAMES, device='cpu',
                                          result_dir=tmp_path / 'port')
    variables = jax.tree_util.tree_map(jax.numpy.asarray, pair.variables)
    (tmp_path / 'jax' / 'final_result' / 'data').mkdir(parents=True)   # as tools/test.py does
    np.random.seed(7)
    want = j_eval_utils.eval_one_epoch(pair.jax_model, variables['params'],
                                       variables['batch_stats'], j_loader, j_set, CLASS_NAMES,
                                       result_dir=tmp_path / 'jax')
    t_annos = pickle.loads((tmp_path / 'port' / 'result.pkl').read_bytes())
    j_annos = pickle.loads((tmp_path / 'jax' / 'result.pkl').read_bytes())
    assert [a['frame_id'] for a in t_annos] == [a['frame_id'] for a in j_annos]
    assert len(t_annos) == 3 and all(len(a['name']) > 0 for a in t_annos)
    for t, j in zip(t_annos, j_annos):
        match_frame(t, j, t['frame_id'])
    metrics = [k for k in want if k.startswith('recall/') or 'R40' in k]
    assert len(metrics) >= 3 + 3 * 4 * 3
    for k in metrics:
        assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])
    assert got['infer_fps'] > 0 and got['loop_fps'] > 0


@pytest.fixture(scope='module')
def trained(mini, tmp_path_factory):
    """The tiny flagship trained 2 epochs on the mini train split (B=2, one
    step an epoch), a checkpoint an epoch."""
    from pdm_ssd_torch.models import build_network
    from pdm_ssd_torch.runtime import trainer
    root = mini[0]
    cfg = tiny_flagship_cfg(root)
    ckpt_dir = tmp_path_factory.mktemp('ckpt')
    _, loader, _ = t_build_dataloader(cfg.DATA_CONFIG, CLASS_NAMES, batch_size=2,
                                      root_path=root, workers=0, training=True, seed=0)
    net = build_network(cfg.MODEL, 3, cfg.DATA_CONFIG, device='cpu', seed=1)
    optimizer, sched = trainer.create_train_state(net, cfg.OPTIMIZATION, len(loader), 2)
    torch.manual_seed(0)
    np.random.seed(0)
    losses = trainer.train_model(net, optimizer, sched, loader, epochs=2, ckpt_dir=ckpt_dir,
                                 max_ckpt_save_num=5)
    return dict(cfg=cfg, net=net, optimizer=optimizer, losses=losses, ckpt_dir=ckpt_dir)


def test_train_loop_writes_a_checkpoint_an_epoch_and_rotates(trained, tmp_path):
    from pdm_ssd_torch.runtime import trainer
    assert len(trained['losses']) == 2 and all(np.isfinite(trained['losses']))
    ckpts = trainer.list_checkpoints(trained['ckpt_dir'])
    assert [p.name for p in ckpts] == ['checkpoint_epoch_1.pth', 'checkpoint_epoch_2.pth']
    for epoch in (1, 2, 3):
        trainer.save_checkpoint(tmp_path, trained['net'], trained['optimizer'], epoch,
                                max_ckpt_save_num=1)
        assert [p.name for p in trainer.list_checkpoints(tmp_path)] == [
            f'checkpoint_epoch_{epoch}.pth']


def test_resume_restores_epoch_iteration_and_moments(trained):
    from pdm_ssd_torch.models import build_network
    from pdm_ssd_torch.runtime import trainer
    cfg, net, opt = trained['cfg'], trained['net'], trained['optimizer']
    fresh = build_network(cfg.MODEL, 3, cfg.DATA_CONFIG, device='cpu', seed=5)
    fresh_opt, _ = trainer.create_train_state(fresh, cfg.OPTIMIZATION, 1, 2)
    assert trainer.resume(trained['ckpt_dir'], fresh, fresh_opt) == 2
    assert fresh_opt.count == opt.count == 2
    for (k, p), q in zip(net.named_parameters(), fresh.parameters()):
        assert torch.equal(p, q), k
        s, t = opt.optimizer.state[p], fresh_opt.optimizer.state[q]
        assert torch.equal(s['exp_avg'], t['exp_avg']) and torch.equal(
            s['exp_avg_sq'], t['exp_avg_sq']), k
    for (k, b), c in zip(net.named_buffers(), fresh.buffers()):
        assert torch.equal(b, c), k
    assert trainer.resume(trained['ckpt_dir'].parent / 'none', fresh, fresh_opt) == 0


def test_checkpoint_round_trip_predicts_bit_for_bit(trained):
    from pdm_ssd_torch.models import build_network
    from pdm_ssd_torch.runtime import trainer
    from pdm_ssd_torch.utils import synthetic
    cfg, net = trained['cfg'], trained['net']
    loaded = build_network(cfg.MODEL, 3, cfg.DATA_CONFIG, device='cpu', seed=9)
    epoch = trainer.load_checkpoint(trainer.list_checkpoints(trained['ckpt_dir'])[-1], loaded)
    assert epoch == 2
    points = torch.from_numpy(synthetic.kitti_points(2, 1024, seed=3))
    want = trainer.make_predict_step(net)({'points': points})
    got = trainer.make_predict_step(loaded)({'points': points})
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_train_and_test_clis_on_the_cpu(mini, tmp_path):
    """`tools/train.py --device cpu` one epoch, then `tools/test.py` on its
    checkpoint: the checkpoint, `result.pkl` and the AP lines."""
    cfg = tiny_flagship_cfg(mini[0]).to_dict()
    for k in ('TAG', 'EXP_GROUP_PATH'):
        cfg.pop(k)
    cfg_file = tmp_path / 'tiny_flagship.yaml'
    cfg_file.write_text(yaml.safe_dump(cfg))
    out = tmp_path / 'out'
    common = ['--cfg_file', str(cfg_file), '--batch_size', '2', '--workers', '0',
              '--device', 'cpu', '--output_dir', str(out)]
    # one intra-op thread, as the in-process tests run (`torch_port_threads`)
    env = {**os.environ, 'PYTHONPATH': str(REPO), 'OMP_NUM_THREADS': '1'}
    res = subprocess.run([sys.executable, '-m', 'pdm_ssd_torch.tools.train', *common,
                          '--epochs', '1'], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert (out / 'ckpt' / 'checkpoint_epoch_1.pth').exists()
    res = subprocess.run([sys.executable, '-m', 'pdm_ssd_torch.tools.test', *common,
                          '--ckpt', str(out / 'ckpt' / 'checkpoint_epoch_1.pth')], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert (out / 'eval' / 'result.pkl').exists()
    log = res.stdout + res.stderr
    assert 'Car AP_R40@0.70, 0.70, 0.70' in log and 'recall_rcnn_0.7' in log


@pytest.mark.parametrize('center', [True, False])
def test_box_range_filter_matches_jax(center):
    """The host box filter, center test and corner test (the port computes
    the corners in numpy where the JAX package calls its jax op)."""
    from pdm_ssd_torch.utils import box_utils_np
    from pdm_ssd_tpu.ops import box_ops
    rng = np.random.RandomState(6)
    boxes = np.concatenate([rng.uniform(-5, 75, (200, 1)), rng.uniform(-45, 45, (200, 1)),
                            rng.uniform(-4, 2, (200, 1)), rng.uniform(0.5, 5, (200, 3)),
                            rng.uniform(-np.pi, np.pi, (200, 1)), np.ones((200, 1))],
                           1).astype(np.float32)
    pc_range = [0, -40, -3, 70.4, 40, 1]
    got = box_utils_np.mask_boxes_outside_range_numpy(boxes, pc_range, min_num_corners=2,
                                                      use_center_to_filter=center)
    want = box_ops.mask_boxes_outside_range_numpy(boxes, pc_range, min_num_corners=2,
                                                  use_center_to_filter=center)
    assert 20 < got.sum() < 180
    np.testing.assert_array_equal(got, want)
    if not center:
        np.testing.assert_allclose(box_utils_np.boxes_to_corners_3d(boxes[:, :7]),
                                   np.asarray(box_ops.boxes_to_corners_3d(boxes[:, :7])),
                                   rtol=0, atol=1e-5)


def test_calculate_grid_size_matches_jax(mini):
    """`calculate_grid_size` (`centerpoint_pillar.yaml`'s processor list)
    sets the JAX package's grid and voxel size and changes no sample: every
    sample of the val split equal to the JAX package's under one seed."""
    import os
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        ds_cfg = cfg_from_yaml_file('configs/kitti_models/centerpoint_pillar.yaml').DATA_CONFIG
    finally:
        os.chdir(cwd)
    sets = []
    for root, build, node in ((mini[0], t_kitti.KittiDataset, CfgNode),
                              (mini[1], j_kitti.KittiDataset, JCfgNode)):
        cfg = node(ds_cfg.to_dict())
        cfg.DATA_PATH = str(root)
        cfg.DATA_PROCESSOR[2]['NUM_POINTS'] = {'train': N_POINTS, 'test': N_POINTS}
        sets.append(build(cfg, CLASS_NAMES, training=False, root_path=root))
    t_set, j_set = sets
    assert [g.tolist() for g in (t_set.grid_size, j_set.grid_size)] == [[352, 400, 1]] * 2
    np.testing.assert_array_equal(t_set.voxel_size, j_set.voxel_size)
    for i in range(len(t_set)):
        np.random.seed(50 + i)
        got = t_set[i]
        np.random.seed(50 + i)
        assert_deep_equal(got, j_set[i], f'sample {i}')


@pytest.mark.parametrize('what', ['depth map', 'imgaug', 'local rotation',
                                  'image copy-paste', 'ONCEDataset'])
def test_unported_parts_of_the_data_path_raise(what, mini, tmp_path):
    """Every step, augmentation and dataset of the JAX package's data path
    is in the port and builds into the loader's queues when the config names
    it: the per-object rotation (`random_local_rotation`, ported with the
    other five local augmentations) joins the KITTI set's augmentation
    queue; ONCE (ROADMAP Queue 1 item 13, ported) builds from the KITTI data
    config with ONCE's infos and splits over a generated mini ONCE set, its
    queue the config's world flip, rotation and scaling (KITTI's GT
    database is not in that set). CaDDN's steps build too: the depth maps (`generate_depth_map`,
    `downsample_depth_map`), the camera augmentations (`imgaug`,
    `random_image_flip`) and the GT sampler's image copy-paste (IMG_AUG_TYPE
    'kitti')."""
    cfg = dataset_cfg(mini[0])
    if what in ('local rotation', 'ONCEDataset'):
        root = mini[0]
        if what == 'local rotation':
            cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST.append(
                CfgNode({'NAME': 'random_local_rotation', 'LOCAL_ROT_ANGLE': [-0.15, 0.15]}))
        else:
            from pdm_ssd_torch.tools.make_mini_sets import make
            root = make('once', tmp_path / 'once', frames=2, n_bg=500)
            cfg.DATASET = 'ONCEDataset'
            cfg.DATA_SPLIT = {'train': 'train', 'test': 'val'}
            cfg.INFO_PATH = {'train': ['once_infos_train.pkl'], 'test': ['once_infos_val.pkl']}
            cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST = cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST[1:]
        ds, _, _ = t_build_dataloader(cfg, CLASS_NAMES, batch_size=2, root_path=root,
                                      workers=0, training=True)
        names = [f.func.__name__ if hasattr(f, 'func') else type(f).__name__
                 for f in ds.data_augmentor.data_augmentor_queue]
        if what == 'local rotation':
            assert type(ds).__name__ == 'KittiDataset' and names[-1] == 'random_local_rotation'
        else:
            assert type(ds).__name__ == 'ONCEDataset' and len(ds) == 2
            assert names == ['random_world_flip', 'random_world_rotation', 'random_world_scaling']
        np.random.seed(3)
        assert ds[0]['points'].shape == (N_POINTS, 4)
        return
    if what == 'depth map':
        cfg.DATA_PROCESSOR.append(CfgNode({'NAME': 'generate_depth_map', 'MAP_SHAPE': [375, 1242]}))
        cfg.DATA_PROCESSOR.append(CfgNode({'NAME': 'downsample_depth_map',
                                           'DOWNSAMPLE_FACTOR': 8}))
    elif what == 'imgaug':
        cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST.append(
            CfgNode({'NAME': 'imgaug', 'ROT_LIM': [-5.4, 5.4], 'RAND_FLIP': True}))
        cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST.append(
            CfgNode({'NAME': 'random_image_flip', 'ALONG_AXIS_LIST': ['horizontal']}))
    else:
        cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST[0]['IMG_AUG_TYPE'] = 'kitti'
    ds, _, _ = t_build_dataloader(cfg, CLASS_NAMES, batch_size=2, root_path=mini[0], workers=0,
                                  training=True)
    if what == 'depth map':
        assert ds.data_processor.depth_downsample_factor == 8
        assert len(ds.data_processor.steps) == len(cfg.DATA_PROCESSOR)
    elif what == 'imgaug':
        names = [f.func.__name__ for f in ds.data_augmentor.data_augmentor_queue[-2:]]
        assert names == ['imgaug', 'random_image_flip']
    else:
        assert ds.data_augmentor.data_augmentor_queue[0].img_aug_type == 'kitti'
