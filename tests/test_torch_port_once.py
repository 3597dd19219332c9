"""The port's ONCE data path, evaluator and eval loop against the JAX package,
on the CPU.

One mini ONCE set (`python -m pdm_ssd_torch.tools.make_mini_sets --set
once`, 4 frames a split) is generated once for the module; both packages
read the same files. The JAX package's ONCE evaluator is tested only
against the CUDA reference (`tests/test_once_eval.py`, through
`tests/ref_oracle.py`), which the CPU test run may not have, so the port's
is held to the JAX package's, the only anchor that always runs.
"""
import copy
import pickle

import numpy as np
import pytest

from pdm_ssd_torch.datasets import build_dataloader as t_build_dataloader
from pdm_ssd_torch.datasets.once import once_eval as t_once_eval
from pdm_ssd_torch.tools.make_mini_sets import make
from pdm_ssd_torch.utils import synthetic
from pdm_ssd_tpu.datasets import build_dataloader as j_build_dataloader
from pdm_ssd_tpu.datasets.once import once_eval as j_once_eval
from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode

from test_torch_port_kitti import assert_deep_equal, match_frame
from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)

ONCE_CLASSES = ['Car', 'Bus', 'Truck', 'Pedestrian', 'Cyclist']
N_POINTS = 2048
FRAMES = 4
# the ONCE AP of the eval loop: the two packages' detections differ by
# float32 rounding (DET_RTOL of `test_torch_port_kitti`), so an IoU may move
# across a threshold only if it lies within that of one
METRIC_ATOL = 1e-4


def data_cfg(root, n_points: int = N_POINTS):
    cfg = synthetic.flagship_on('once', root)
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == 'sample_points':
            proc.NUM_POINTS = {'train': n_points, 'test': n_points}
    return cfg


@pytest.fixture(scope='module')
def mini(tmp_path_factory):
    return make('once', tmp_path_factory.mktemp('once') / 'set', frames=FRAMES, n_bg=1500)


@pytest.mark.parametrize('training', [True, False], ids=['train', 'test'])
@pytest.mark.parametrize('seed', [0, 1])
def test_samples_and_batches_match_jax_exactly(mini, training, seed):
    """Every index of the split, `np.random` seeded the same before each
    side's `__getitem__` (training: the world flip, rotation and scaling
    on): the same points, boxes and mask, and the same collated batch."""
    cfg = data_cfg(mini)
    t_set, _, _ = t_build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=0,
                                     training=training)
    j_set, _, _ = j_build_dataloader(JCfgNode(cfg.DATA_CONFIG.to_dict()), cfg.CLASS_NAMES, 2,
                                     workers=0, training=training)
    assert type(t_set).__name__ == 'ONCEDataset' and len(t_set) == len(j_set) == FRAMES
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


def random_annos(rng, n_samples: int = 6, max_boxes: int = 12) -> tuple:
    """GT annos of the five ONCE classes over +-60 m (every distance
    bucket), and predictions: jittered copies with some names swapped, and
    false positives, scored at random."""
    gts, preds = [], []
    for _ in range(n_samples):
        n = rng.randint(2, max_boxes)
        boxes = np.concatenate([rng.uniform(-60, 60, (n, 2)), rng.uniform(-2, 1, (n, 1)),
                                rng.uniform(1.5, 5, (n, 2)), rng.uniform(1.2, 2.2, (n, 1)),
                                rng.uniform(-np.pi, np.pi, (n, 1))], 1)
        names = np.asarray(ONCE_CLASSES)[rng.randint(0, 5, n)]
        gts.append({'name': names, 'boxes_3d': boxes})
        m = n + rng.randint(0, 4)
        fp = np.concatenate([rng.uniform(-60, 60, (m - n, 2)), rng.uniform(-2, 1, (m - n, 1)),
                             rng.uniform(1.5, 5, (m - n, 2)), rng.uniform(1.2, 2.2, (m - n, 1)),
                             rng.uniform(-np.pi, np.pi, (m - n, 1))], 1)
        pnames = np.concatenate([names, np.asarray(ONCE_CLASSES)[rng.randint(0, 5, m - n)]])
        swap = rng.rand(n) < 0.15
        pnames[:n][swap] = np.asarray(ONCE_CLASSES)[rng.randint(0, 5, int(swap.sum()))]
        preds.append({'name': pnames,
                      'boxes_3d': np.concatenate([boxes + rng.normal(0, 0.15, boxes.shape), fp]),
                      'score': rng.rand(m)})
    return gts, preds


@pytest.mark.parametrize('mode', ['Overall&Distance', 'Overall', 'Distance'])
@pytest.mark.parametrize('use_superclass', [True, False])
def test_once_ap_matches_jax(use_superclass, mode):
    """The same result string and dict, every entry within 1e-9, at both
    superclass settings and the three difficulty modes, on seeded annos;
    the port's rotated overlap is the JAX package's numpy path, which the
    JAX side may run through its native library (the same clipping in
    float32): the entries agree to 1e-9 all the same."""
    gts, preds = random_annos(np.random.RandomState(0))
    t_str, t_dict = t_once_eval.get_evaluation_results(
        copy.deepcopy(gts), copy.deepcopy(preds), list(ONCE_CLASSES),
        use_superclass=use_superclass, difficulty_mode=mode)
    j_str, j_dict = j_once_eval.get_evaluation_results(
        copy.deepcopy(gts), copy.deepcopy(preds), list(ONCE_CLASSES),
        use_superclass=use_superclass, difficulty_mode=mode)
    assert t_dict.keys() == j_dict.keys() and t_str == j_str
    assert sum(v > 10 for v in t_dict.values()) >= 3
    for k, v in j_dict.items():
        assert abs(t_dict[k] - v) <= 1e-9, (k, t_dict[k], v)


def test_iou3d_with_heading_matches_jax():
    rng = np.random.RandomState(3)
    a = np.concatenate([rng.uniform(-5, 5, (20, 3)), rng.uniform(0.5, 4, (20, 3)),
                        rng.uniform(-np.pi, np.pi, (20, 1))], 1)
    b = a + rng.normal(0, 0.3, a.shape)
    b[::3, 6] += np.pi        # flipped headings: gated to 0
    got = t_once_eval.iou3d_with_heading(a, b)
    np.testing.assert_allclose(got, j_once_eval.iou3d_with_heading(a, b), rtol=0, atol=1e-6)
    assert (got[np.arange(0, 20, 3), np.arange(0, 20, 3)] == 0).all() and got.max() > 0.3


def test_eval_loop_matches_jax(mini, tmp_path):
    """`eval_one_epoch` of both packages over the val split at B=2 with the
    tiny flagship (`synthetic.tiny_flagship_cfg`), the same weights carried
    across by `utils/weights.py`, the score thresholds at 0: the same
    number of detections in every frame, matched by box and class, the
    ONCE AP dicts within METRIC_ATOL, `result.pkl` written. Seeded weights
    score AP 0, so both datasets' `evaluation` also scores the GT of the
    val infos, jittered, with some dropped and false positives added: the
    same dicts within 1e-9, and AP above 10 in some entries."""
    import jax
    from pdm_ssd_torch.runtime import eval_utils as t_eval_utils
    from pdm_ssd_tpu.runtime import eval_utils as j_eval_utils
    from torch_port_harness import ModelPair, jax_bf16_extraction
    cfg = synthetic.tiny_flagship_cfg(data_cfg(mini))
    cfg.MODEL.POST_PROCESSING.SCORE_THRESH = 0.0
    cfg.MODEL.DENSE_HEAD.POST_PROCESSING.SCORE_THRESH = 0.0
    pair = ModelPair(cfg, B=1, N=512, seed=2)
    t_set, t_loader, _ = t_build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=0,
                                            training=False)
    j_set, j_loader, _ = j_build_dataloader(JCfgNode(cfg.DATA_CONFIG.to_dict()), cfg.CLASS_NAMES,
                                            2, workers=0, training=False)
    np.random.seed(7)
    with jax_bf16_extraction():
        got = t_eval_utils.eval_one_epoch(pair.net, t_loader, t_set, cfg.CLASS_NAMES,
                                          device='cpu', result_dir=tmp_path / 'port')
    variables = jax.tree_util.tree_map(jax.numpy.asarray, pair.variables)
    (tmp_path / 'jax' / 'final_result' / 'data').mkdir(parents=True)
    np.random.seed(7)
    want = j_eval_utils.eval_one_epoch(pair.jax_model, variables['params'],
                                       variables['batch_stats'], j_loader, j_set, cfg.CLASS_NAMES,
                                       result_dir=tmp_path / 'jax')
    t_annos = pickle.loads((tmp_path / 'port' / 'result.pkl').read_bytes())
    j_annos = pickle.loads((tmp_path / 'jax' / 'result.pkl').read_bytes())
    assert [a['frame_id'] for a in t_annos] == [a['frame_id'] for a in j_annos]
    assert len(t_annos) == FRAMES and all(len(a['name']) > 0 for a in t_annos)
    for t, j in zip(t_annos, j_annos):
        match_frame({'name': t['name'], 'boxes_lidar': t['boxes_3d'], 'score': t['score']},
                    {'name': j['name'], 'boxes_lidar': j['boxes_3d'], 'score': j['score']},
                    t['frame_id'])
    metrics = [k for k in want if k.startswith('AP_') or k.startswith('recall/')]
    assert len(metrics) == 3 + 4 * 4 and set(metrics) <= set(got)
    for k in metrics:
        assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])
    rng = np.random.RandomState(5)
    dets = []
    for info in t_set.once_infos:
        gt = info['annos']
        keep = rng.rand(len(gt['name'])) > 0.2
        boxes = gt['boxes_3d'][keep] + rng.normal(0, 0.1, (int(keep.sum()), 7))
        dets.append({'name': np.concatenate([gt['name'][keep], ['Car']]),
                     'boxes_3d': np.concatenate([boxes, [[20.0, 0.0, -1.0, 4, 2, 1.6, 0]]]),
                     'score': rng.rand(int(keep.sum()) + 1)})
    _, t_dict = t_set.evaluation(copy.deepcopy(dets), cfg.CLASS_NAMES)
    _, j_dict = j_set.evaluation(copy.deepcopy(dets), cfg.CLASS_NAMES)
    assert t_dict.keys() == j_dict.keys() and sum(v > 10 for v in t_dict.values()) >= 3
    for k, v in j_dict.items():
        assert abs(t_dict[k] - v) <= 1e-9, (k, t_dict[k], v)
