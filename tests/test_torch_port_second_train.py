"""SECOND's training path in the port against the JAX package, on the CPU.

The voxel step of the data path and its collate, the transposed maps of the
ladder, the sparse conv's backward (`ops/sparse_conv.SparseConvFunction`,
here through its plain versions: the kernels are held on the card by
`chip_smoke.py` phase 27 and the `gpu` tests of `test_torch_port_guards.py`),
`nearest_bev_iou`, the anchor targets, the losses, the gradients of the tiny
SECOND, three Adam steps, and the train and eval loops with their CLIs.
Inputs come from numpy seeds. `TABLE_DTYPE: bf16` is removed on both sides
wherever a tolerance is tight (the JAX ladder would run in bf16, the port
stays in float32; `test_torch_port_sparse.py` pins the file as shipped).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pdm_ssd_torch.datasets.kitti import kitti_dataset as t_kitti
from pdm_ssd_torch.datasets.kitti import synthetic as t_syn
from pdm_ssd_torch.models import get_host_prepare
from pdm_ssd_torch.models.dense_heads import anchor_head as t_ah
from pdm_ssd_torch.ops import sparse_conv as t_sc
from pdm_ssd_torch.ops import sparse_maps as t_maps
from pdm_ssd_torch.utils import synthetic
from pdm_ssd_torch.utils.config import cfg_from_yaml_file
from pdm_ssd_torch.utils.weights import from_flax, to_flax
from pdm_ssd_tpu.datasets.kitti import kitti_dataset as j_kitti
from pdm_ssd_tpu.datasets.kitti import synthetic as j_syn
from pdm_ssd_tpu.models import get_host_prepare as j_get_host_prepare
from pdm_ssd_tpu.models.backbones_3d import sparse_backbone as j_sb
from pdm_ssd_tpu.models.dense_heads import anchor_head as j_ah
from pdm_ssd_tpu.ops import sparse_maps as j_maps
from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_harness import REPO, ModelPair, jax_train_steps, to_numpy

SECOND = 'configs/kitti_models/second_sparse.yaml'
CLASS_NAMES = ['Car', 'Pedestrian', 'Cyclist']
# losses of one forward, float32 on both sides: sums in another order
LOSS_RTOL = 1e-4
# box targets: the same float32 encode of the same boxes and anchors
BOX_TARGET_ATOL = 1e-5
# per-leaf gradients of the tiny SECOND, relative L2. Both sides are float32
# and run the same gather-transpose backward; what is left is the order of
# float32 sums, enlarged where BatchNorm on batch statistics divides by a
# channel's own deviation (the flagship's tests allow 4e-2, where the JAX
# side rounds its grouping gradient to bf16: no such rounding here).
# Measured on this batch: 2.1e-5, at a BatchNorm scale of the ladder
GRAD_REL_L2 = 2e-4
# parameters after three Adam steps, relative L2 per leaf, as
# `test_torch_port_grid.py` holds them (Adam divides each element's gradient
# by its own RMS)
STEP_PARAM_REL_L2 = 1e-3
N_BOXES = 8


def load_cfg(strip_table_dtype=True):
    cwd = os.getcwd()
    os.chdir(REPO)          # the config names its base config relative to the repo
    try:
        cfg = cfg_from_yaml_file(SECOND)
    finally:
        os.chdir(cwd)
    if strip_table_dtype:
        cfg.MODEL.BACKBONE_3D.pop('TABLE_DTYPE')
    return cfg


def tiny_cfg():
    return synthetic.tiny_second_cfg(load_cfg())


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64).ravel(), np.asarray(want, np.float64).ravel()
    nw = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / nw) if nw > 0 else float(np.linalg.norm(got))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield '/'.join(prefix + (k,)), np.asarray(v)


# ---- the voxel step of the data path ------------------------------------------------

def second_dataset_cfg(root):
    cfg = load_cfg().DATA_CONFIG
    cfg.DATA_PATH = str(root)
    return cfg


@pytest.fixture(scope='module')
def mini(tmp_path_factory):
    """(port root, JAX root): the 3-frame mini set of each package's
    generator and `create_kitti_infos`."""
    base = tmp_path_factory.mktemp('mini_kitti_second')
    roots = base / 'port', base / 'jax'
    t_syn.make_mini_kitti(roots[0])
    j_syn.make_mini_kitti(roots[1])
    t_kitti.create_kitti_infos(second_dataset_cfg(roots[0]), CLASS_NAMES, roots[0], roots[0],
                               workers=1)
    j_kitti.create_kitti_infos(JCfgNode(second_dataset_cfg(roots[1]).to_dict()), CLASS_NAMES,
                               roots[1], roots[1], workers=1)
    return roots


def _voxel_batches(mini, training, jax_native):
    """The collated batches of every frame of the split, port and JAX, under
    the same `np.random` seed per frame; the JAX package's C voxelizer or
    (`jax_native` False) its numpy one."""
    from pdm_ssd_tpu.datasets.processor.data_processor import DataProcessor as JProcessor
    t_root, j_root = mini
    t_ds = t_kitti.KittiDataset(second_dataset_cfg(t_root), CLASS_NAMES, training=training,
                                root_path=t_root)
    j_ds = j_kitti.KittiDataset(JCfgNode(second_dataset_cfg(j_root).to_dict()), CLASS_NAMES,
                                training=training, root_path=j_root)
    samples = {'port': [], 'jax': []}
    native = JProcessor._native_voxelize
    if not jax_native:
        JProcessor._native_voxelize = lambda *args: None
    try:
        for i in range(len(t_ds)):
            for key, ds in (('port', t_ds), ('jax', j_ds)):
                np.random.seed(200 + i)
                samples[key].append(ds[i])
    finally:
        JProcessor._native_voxelize = native
    return t_ds.collate_batch(samples['port']), j_ds.collate_batch(samples['jax'])


@pytest.mark.parametrize('split', ['train', 'val'])
def test_voxel_batches_of_the_mini_set_match_jax_exactly(mini, split):
    """`second_sparse.yaml`'s data path over every frame of the split, under
    the same `np.random` seed (training: GT sampling, flip, rotation,
    scaling and the shuffle on): the voxels, coords, point counts and the
    collate's `voxel_mask`, padded to the cap of the mode, equal exactly to
    the JAX package's with its numpy voxelizer (`_numpy_voxelize`: cells in
    key order, the contract `ops/voxelize` keeps). Its C voxelizer, which
    the JAX package takes where it builds, orders cells by first appearance
    in the cloud: below the cap it gives the same voxels in another order,
    which the ladder's `sp_perm1` sorts away."""
    training = split == 'train'
    t_batch, j_batch = _voxel_batches(mini, training, jax_native=False)
    cap = 16000 if training else 40000
    assert t_batch['voxels'].shape == (3, cap, 5, 4)
    for k in ('voxels', 'voxel_coords', 'voxel_num_points', 'voxel_mask', 'gt_boxes', 'gt_mask',
              'points', 'points_mask'):
        g, w = t_batch[k], np.asarray(j_batch[k])
        if k == 'voxel_coords':         # int64 from numpy, int32 from the C voxelizer
            w = w.astype(np.int32)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    n = t_batch['voxel_mask'].sum(1)
    assert (n > 1000).all() and (n < cap).all()
    assert t_batch['voxel_num_points'][t_batch['voxel_mask']].min() >= 1

    _, native = _voxel_batches(mini, training, jax_native=True)
    for b in range(3):
        c = native['voxel_coords'][b, :n[b]].astype(np.int64)
        order = np.argsort((c[:, 0] * 10 ** 4 + c[:, 1]) * 10 ** 4 + c[:, 2])
        np.testing.assert_array_equal(native['voxel_mask'][b], t_batch['voxel_mask'][b])
        for k in ('voxels', 'voxel_coords', 'voxel_num_points'):
            assert native[k].dtype == t_batch[k].dtype, k
            np.testing.assert_array_equal(native[k][b, :n[b]][order], t_batch[k][b, :n[b]],
                                          err_msg=k)


# ---- the transposed maps -------------------------------------------------------------

def _actives(kind, rng, grid, V, B=2, n=None):
    """(coords (B, V, 3) int32 zyx, mask (B, V)) of seeded active cells, in
    no order."""
    W, H, D = grid
    n = n or {'random': 200, 'clustered': 230, 'overflow': 250, 'empty cloud': 180}[kind]
    coords, mask = np.zeros((B, V, 3), np.int32), np.zeros((B, V), bool)
    for b in range(B):
        nb = 0 if (kind == 'empty cloud' and b == 0) else n - 9 * b
        if kind == 'clustered':
            base = rng.randint(0, [D + 1 - 3, H - 6, W - 6], (nb // 15 + 1, 3))
            c = (base[:, None] + rng.randint(0, [3, 6, 6], (1, 40, 3))).reshape(-1, 3)
            flat = np.unique((c[:, 0] * H + c[:, 1]) * W + c[:, 2])[:nb]
        else:
            flat = np.sort(rng.choice((D + 1) * H * W, nb, replace=False))
        c = np.stack([flat // (H * W), (flat // W) % H, flat % W], -1)
        c = c[rng.permutation(len(c))]
        coords[b, :len(c)], mask[b, :len(c)] = c, True
    return coords, mask


def _ladder(kind, seed=5, grid=(64, 64, 24), V=256, caps=None, n=None):
    """The ladder maps of seeded actives and their caps."""
    caps = caps or ([V, 100, 60, 128, 20] if kind == 'overflow' else [V, 1024, 512, 128, 128])
    coords, mask = _actives(kind, np.random.RandomState(seed), grid, V, n=n)
    maps = t_maps.batch_build_backbone8x(torch.from_numpy(coords), torch.from_numpy(mask), grid,
                                         caps)
    return maps, caps


@pytest.mark.parametrize('kind', ['random', 'clustered', 'overflow', 'empty cloud'])
def test_up_maps_equal_the_jax_package(kind):
    """The four transposed maps, integer for integer: the flipped tap, the
    `cap_out` padding, `conv_out`'s K=3 map against caps[3]."""
    maps, caps = _ladder(kind)
    got = t_maps.batch_invert_ladder(maps, caps)
    want = j_maps.batch_invert_ladder({k: v.numpy() for k, v in maps.items()}, caps)
    assert list(got) == list(t_maps.UPMAP_KEYS) == list(j_maps.UPMAP_KEYS)
    for k in t_maps.UPMAP_KEYS:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert got['sp_upmap_out'].shape == (2, caps[3], 3)
    assert (got['sp_upmap2'] < caps[1]).any()


def test_training_prepare_equals_the_jax_package():
    """`get_host_prepare(training=True)` on a voxel training batch: every key
    of the JAX package's prepared batch (the ladder maps, the four
    transposed maps, the voxels and the ground truth), exactly; the eval
    prepare ships no transposed map."""
    cfg = tiny_cfg()
    raw = synthetic.voxel_train_batch(2, 600, cfg, N_BOXES, seed=3)
    got = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG, training=True)(raw)
    jcfg = JCfgNode(cfg.to_dict())
    want = j_get_host_prepare(jcfg.MODEL, jcfg.DATA_CONFIG, training=True)(
        {k: v.numpy() for k, v in raw.items()})
    assert set(t_maps.UPMAP_KEYS) <= set(want) and set(want) <= set(got)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    evaled = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG)(raw)
    assert not set(t_maps.UPMAP_KEYS) & set(evaled)
    for k in t_maps.LADDER_KEYS:
        assert torch.equal(evaled[k], got[k]), k


@pytest.mark.parametrize('kind', ['random', 'clustered', 'overflow'])
def test_submanifold_maps_are_their_own_transpose(kind):
    """nbr[u, K-1-k] == v iff nbr[v, k] == u, for every submanifold map of
    the ladder: the property that lets a submanifold layer's backward read
    its forward map and plan."""
    maps, _ = _ladder(kind)
    for s in (1, 2, 3, 4):
        nbr = maps[f'sp_submap{s}'].long()
        B, V, K = nbr.shape
        present = nbr < V
        assert present.any()
        b, v, k = torch.nonzero(present, as_tuple=True)
        u = nbr[b, v, k]
        # every present entry maps back, so the converse holds too
        assert torch.equal(nbr[b, u, K - 1 - k], v), s


# ---- the sparse conv's backward ----------------------------------------------------------

def _layer(kind, Cin, Cout, seed=0, dtype=torch.float64, small=False):
    """(feats, nbr, weight, bwd_nbr) of one layer of a ladder: a
    submanifold conv of stage 2, the strided conv into stage 3, or
    `conv_out`. `small`: 30 clustered actives on a 12 x 12 x 24 grid."""
    if small:
        maps, caps = _ladder('clustered', grid=(12, 12, 24), V=40, caps=[40, 80, 60, 40, 40],
                             n=30)
    else:
        maps, caps = _ladder('random')
    up = t_maps.batch_invert_ladder(maps, caps)
    nbr, bwd = {'submanifold': (maps['sp_submap2'], maps['sp_submap2']),
                'strided': (maps['sp_downmap3'], up['sp_upmap3']),
                'conv_out': (maps['sp_outmap'], up['sp_upmap_out'])}[kind]
    Vin = bwd.shape[1]
    rng = np.random.RandomState(seed)
    feats = torch.from_numpy(rng.randn(2, Vin, Cin)).to(dtype)
    weight = torch.from_numpy(rng.randn(nbr.shape[2] * Cin, Cout) * 0.3).to(dtype)
    return feats, nbr, weight, bwd


@pytest.mark.parametrize('kind', ['submanifold', 'strided', 'conv_out'])
def test_sparse_conv_backward_passes_gradcheck(kind):
    """`SparseConvFunction` on the CPU (the plain data and weight gradients)
    against `torch.autograd.gradcheck`'s finite differences in float64, on a
    small ladder: a slip in the flipped tap, the per-tap transpose or the
    absent-entry sentinel of any map kind shows here. `fast_mode` compares
    the Jacobian along random directions of every input and output (one
    backward and one finite difference each) instead of entry by entry,
    which keeps the test cheap on a loaded machine and finds a wrong
    Jacobian with probability one."""
    feats, nbr, weight, bwd = _layer(kind, 2, 3, small=True)
    assert (nbr < feats.shape[1]).sum() >= 10
    feats.requires_grad_()
    weight.requires_grad_()
    fn = lambda f, w: t_sc.SparseConvFunction.apply(f, nbr, w, None, bwd, None)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (feats, weight), eps=1e-6, atol=1e-7, rtol=1e-5,
                                    fast_mode=True)


@pytest.mark.parametrize('kind', ['submanifold', 'strided', 'conv_out'])
def test_sparse_conv_backward_matches_jax_vjp(kind):
    """The plain data and weight gradients against `jax.vjp` of the JAX
    package's `sparse_conv_mm` (its gather-transpose custom VJP) on the same
    float32 inputs. Each side is within float32 rounding of a float64
    evaluation: at most n * 2^-24 of the sum of magnitudes, n the terms of a
    sum (K * Cout for the data gradient, the rows for the weight gradient),
    so they differ by at most twice that."""
    Cin, Cout = 8, 16
    feats, nbr, weight, bwd = _layer(kind, Cin, Cout, dtype=torch.float32)
    rng = np.random.RandomState(1)
    dy = torch.from_numpy(rng.randn(nbr.shape[0], nbr.shape[1], Cout).astype(np.float32))
    d_feats, d_w = t_sc.sparse_conv_grads(dy, feats, nbr, weight, None, bwd, None)
    _, vjp = jax.vjp(lambda f, w: j_sb.sparse_conv_mm(f, w, jnp.asarray(nbr.numpy()),
                                                      jnp.asarray(bwd.numpy())),
                     jnp.asarray(feats.numpy()), jnp.asarray(weight.numpy()))
    w_feats, w_w = (np.asarray(x, np.float64) for x in vjp(jnp.asarray(dy.numpy())))
    K = nbr.shape[2]
    mass_f = t_sc.sparse_conv_dgrad_plain(dy.double().abs(), bwd, weight.double().abs())
    mass_w = t_sc.sparse_conv_wgrad_plain(feats.double().abs(), nbr, dy.double().abs())
    bound_f = 2 * K * Cout * 2.0 ** -24 * mass_f.numpy() + 1e-30
    bound_w = 2 * nbr.shape[0] * nbr.shape[1] * 2.0 ** -24 * mass_w.numpy() + 1e-30
    assert (np.abs(d_feats.double().numpy() - w_feats) <= bound_f).all()
    assert (np.abs(d_w.double().numpy() - w_w) <= bound_w).all()
    assert np.abs(w_w).max() > 0 and np.abs(w_feats).max() > 0
    # the plain versions against float64
    exact_f = t_sc.sparse_conv_dgrad_plain(dy.double(), bwd, weight.double())
    assert ((d_feats.double() - exact_f).abs().numpy() <= bound_f / 2).all()


def test_sparse_conv_function_skips_the_data_gradient_where_not_needed():
    """A layer whose input needs no gradient (the ladder's first) computes
    the weight gradient alone; a data gradient without its transposed map
    raises and says how to get one; the forward is the plain version's."""
    feats, nbr, weight, bwd = _layer('strided', 4, 8, dtype=torch.float32)
    weight.requires_grad_()
    from pdm_ssd_torch.ops import dispatch
    out = dispatch.sparse_conv(feats, nbr, weight, None, None, None)
    assert torch.equal(out.detach(), t_sc.sparse_conv_plain(feats, nbr, weight.detach()))
    out.square().sum().backward()
    assert weight.grad is not None and weight.grad.abs().max() > 0
    feats.requires_grad_()
    out = dispatch.sparse_conv(feats, nbr, weight)
    with pytest.raises(ValueError, match='training=True'):
        out.sum().backward()


# ---- targets and losses -------------------------------------------------------------------

def _boxes(rng, n, spread=30.0):
    return np.concatenate([rng.uniform(0, spread, (n, 2)), rng.uniform(-2, 0, (n, 1)),
                           rng.uniform(0.5, 5, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1))],
                          1).astype(np.float32)


def test_nearest_bev_iou_matches_jax():
    """Exactly, on random boxes, on headings at the snap's edge (+-pi/4,
    pi/2) and on boxes that contain others."""
    rng = np.random.RandomState(4)
    a, b = _boxes(rng, 120), _boxes(rng, 40)
    a[:8, 6] = [np.pi / 4, -np.pi / 4, np.pi / 2, 3 * np.pi / 4, 0, np.pi, -np.pi / 2, 1.57]
    b[:4] = [[5, 5, -1, 20, 20, 2, 0], [5, 5, -1, 1, 1, 1, 0], [5, 5, -1, 1, 1, 1, 1.57],
             [6, 6, -1, 2, 4, 1, np.pi / 4]]
    got = t_ah.nearest_bev_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(j_ah.nearest_bev_iou(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > 50


def _heads(cfg, grid=(8, 8)):
    head_cfg, pc_range = cfg.MODEL.DENSE_HEAD, cfg.DATA_CONFIG.POINT_CLOUD_RANGE
    jm = j_ah.AnchorHeadSingle(model_cfg=JCfgNode(head_cfg.to_dict()), input_channels=8,
                               num_class=3, class_names=CLASS_NAMES, grid_size=grid,
                               point_cloud_range=pc_range)
    tm = t_ah.AnchorHeadSingle(head_cfg, 8, 3, CLASS_NAMES, grid, pc_range).eval()
    return jm, tm


def _gt_case(case, seed=6):
    """(gt_boxes (2, 6, 8), gt_mask): random boxes of the three classes, or
    ('ties') one large box over a block of small anchors, which tie its
    largest IoU, plus a padded slot in each cloud."""
    gt = synthetic.gt_boxes(2, 6, [0, -16, -3, 32, 16, 1], seed)
    mask = np.ones((2, 6), bool)
    mask[:, -1] = False
    if case == 'ties':
        # an 18 m x 18 m Pedestrian box over 3 x 3 anchor positions (4.57 m
        # apart): each pedestrian anchor inside it overlaps it by its own
        # area; and a Car box with its heading on the snap's edge
        gt[0, 0] = [9.14, -2.29, -0.865, 18.0, 18.0, 1.73, 0.0, 2]
        gt[1, 0] = [13.71, 2.29, -0.95, 3.9, 1.6, 1.56, np.pi / 4, 1]
    return gt, mask


@pytest.mark.parametrize('case', ['random', 'ties'])
def test_assign_targets_match_jax(case):
    """Labels and direction targets exactly, box targets within
    BOX_TARGET_ATOL, on the tiny SECOND's 384 anchors. In 'ties' every
    pedestrian anchor inside a large pedestrian box ties its largest IoU and
    is forced positive though below the matched threshold."""
    cfg = tiny_cfg()
    jm, tm = _heads(cfg)
    gt, mask = _gt_case(case)
    want = to_numpy(jm.apply({}, {'gt_boxes': jnp.asarray(gt), 'gt_mask': jnp.asarray(mask)},
                             method=jm.assign_targets))
    got = to_numpy(tm.assign_targets({'gt_boxes': torch.from_numpy(gt),
                                      'gt_mask': torch.from_numpy(mask)}))
    np.testing.assert_array_equal(got['anchor_cls_labels'], want['anchor_cls_labels'])
    np.testing.assert_array_equal(got['anchor_dir_targets'], want['anchor_dir_targets'])
    np.testing.assert_allclose(got['anchor_box_targets'], want['anchor_box_targets'], rtol=0,
                               atol=BOX_TARGET_ATOL)
    labels = got['anchor_cls_labels']
    assert (labels > 0).sum() >= 2 and (labels == 0).sum() > 100
    if case == 'ties':
        anchors = torch.from_numpy(tm.anchors_np)
        iou = t_ah.nearest_bev_iou(anchors, torch.from_numpy(gt[0, :1, :7]))[:, 0].numpy()
        s0, s1 = tm.class_slices[1]
        ped = iou[s0:s1]
        tied = np.flatnonzero(ped == ped.max()) + s0
        assert len(tied) >= 2 and ped.max() < 0.35
        assert (labels[0, tied] == 2).all()


def test_get_loss_matches_jax():
    """The three losses and their sum within LOSS_RTOL, on seeded head
    outputs against the targets of random boxes."""
    cfg = tiny_cfg()
    jm, tm = _heads(cfg)
    rng = np.random.RandomState(7)
    gt, mask = _gt_case('random')
    A = len(tm.anchors_np)
    preds = {'anchor_cls_preds': rng.randn(2, A, 3), 'anchor_box_preds': rng.randn(2, A, 7) * 0.5,
             'anchor_dir_preds': rng.randn(2, A, 2)}
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    targets = jm.apply({}, {'gt_boxes': jnp.asarray(gt), 'gt_mask': jnp.asarray(mask)},
                       method=jm.assign_targets)
    w_loss, w_tb = jm.apply({}, {k: jnp.asarray(v) for k, v in preds.items()}, targets,
                            method=jm.get_loss)
    t_targets = tm.assign_targets({'gt_boxes': torch.from_numpy(gt),
                                   'gt_mask': torch.from_numpy(mask)})
    g_loss, g_tb = tm.get_loss({k: torch.from_numpy(v) for k, v in preds.items()}, t_targets)
    assert set(g_tb) == set(w_tb) == {'anchor_cls_loss', 'anchor_loc_loss', 'anchor_dir_loss'}
    np.testing.assert_allclose(float(g_loss), float(w_loss), rtol=LOSS_RTOL)
    for k in g_tb:
        np.testing.assert_allclose(float(g_tb[k]), float(w_tb[k]), rtol=LOSS_RTOL, err_msg=k)
    assert min(float(v) for v in g_tb.values()) > 0


@pytest.mark.parametrize('case', ['random', 'ties'])
def test_atss_assign_targets_match_jax(case):
    """The ATSS assigner on the tiny SECOND's anchors: labels and direction
    targets exactly, box targets within BOX_TARGET_ATOL, every valid box with
    at least its forced anchor."""
    cfg = tiny_cfg()
    cfg.MODEL.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.NAME = 'ATSSTargetAssigner'
    jm, tm = _heads(cfg)
    gt, mask = _gt_case(case)
    want = to_numpy(jm.apply({}, {'gt_boxes': jnp.asarray(gt), 'gt_mask': jnp.asarray(mask)},
                             method=jm.assign_targets))
    got = to_numpy(tm.assign_targets({'gt_boxes': torch.from_numpy(gt),
                                      'gt_mask': torch.from_numpy(mask)}))
    np.testing.assert_array_equal(got['anchor_cls_labels'], want['anchor_cls_labels'])
    np.testing.assert_array_equal(got['anchor_dir_targets'], want['anchor_dir_targets'])
    np.testing.assert_allclose(got['anchor_box_targets'], want['anchor_box_targets'], rtol=0,
                               atol=BOX_TARGET_ATOL)
    assert (got['anchor_cls_labels'] > 0).sum(axis=1).min() >= mask.sum(axis=1).min()


# ---- the tiny SECOND in training -----------------------------------------------------------

@pytest.fixture(scope='module')
def pair():
    """The tiny SECOND in both packages, a training batch of 2 clouds with 8
    boxes each, prepared for training by each package."""
    return ModelPair(tiny_cfg(), B=2, N=600, seed=0, voxels=True, bias_scale=0.1,
                     train_boxes=N_BOXES)


def _port_grads(pair):
    net = pair.net
    net.load_state_dict(from_flax(pair.variables, net))
    net.train()
    net.zero_grad()
    try:
        loss, tb = net.forward_with_loss(pair.torch_inputs())
        loss.backward()
        grads = to_flax(net, {k: p.grad for k, p in net.named_parameters()})['params']
    finally:
        net.zero_grad()
        net.load_state_dict(from_flax(pair.variables, net))
        net.eval()
    return float(loss.detach()), {k: float(v.detach()) for k, v in tb.items()}, grads


def test_training_loss_and_gradients_match_jax(pair):
    """`forward_with_loss` in training mode and every parameter's gradient,
    against the JAX package's, whose ladder takes its gather-transpose
    backward too: the loss and each term within LOSS_RTOL, every leaf within
    GRAD_REL_L2 relative L2, the sparse layers' kernels included."""
    assert 'sp_upmap2' in pair.inputs and 'sp_upmap_out' in pair.torch_inputs()
    loss, tb, grads = _port_grads(pair)
    j_loss, j_tb, j_grads, _ = pair.jax_loss_and_grads()
    assert set(tb) == set(j_tb) == {'anchor_cls_loss', 'anchor_loc_loss', 'anchor_dir_loss',
                                    'loss'}
    np.testing.assert_allclose(loss, float(j_loss), rtol=LOSS_RTOL)
    for k, v in tb.items():
        np.testing.assert_allclose(v, float(j_tb[k]), rtol=LOSS_RTOL, err_msg=k)
    want, got = dict(_leaves(j_grads)), dict(_leaves(grads))
    assert set(got) == set(want)
    worst = max((rel_l2(got[k], want[k]), k) for k in want)
    assert worst[0] <= GRAD_REL_L2, f'{worst[1]}: relative L2 error {worst[0]:.3e}'
    kernels = [k for k in want if k.endswith('kernel') and want[k].ndim == 2]
    assert len(kernels) == 12 and all(np.abs(want[k]).max() > 0 for k in kernels)


def test_three_train_steps_track_jax(pair):
    """Three steps of each package's train step from the same state on one
    batch: the loss of each step within LOSS_RTOL and every leaf of
    parameters and BatchNorm statistics within STEP_PARAM_REL_L2."""
    from pdm_ssd_torch.runtime.trainer import create_train_state, make_train_step
    j_losses, j_params, j_stats = jax_train_steps(pair, 3)
    net = pair.net
    net.load_state_dict(from_flax(pair.variables, net))
    optimizer, _ = create_train_state(net, pair.cfg.OPTIMIZATION, 10, 2)
    t_step = make_train_step(net, optimizer)
    try:
        for j_loss in j_losses:
            t_metrics = t_step(pair.torch_inputs())
            np.testing.assert_allclose(float(t_metrics['loss']), j_loss, rtol=LOSS_RTOL)
        got = to_flax(net)
    finally:
        net.load_state_dict(from_flax(pair.variables, net))
        net.eval()
    for kind, tree in (('params', j_params), ('batch_stats', j_stats)):
        want = dict(_leaves(tree))
        for k, g in _leaves(got[kind]):
            rel = rel_l2(g, want[k])
            assert rel <= STEP_PARAM_REL_L2, f'{kind}/{k}: relative L2 {rel:.3e}'


def test_train_and_eval_loops_and_clis_on_a_small_set(mini, tmp_path):
    """The tiny SECOND through `train_model` for 2 epochs on the mini set
    (a checkpoint each, a resume into a fresh model after the first that
    restores weights, moments and the schedule's iteration exactly, and the
    second epoch from there equal bit for bit to an uninterrupted run), then
    `eval_one_epoch` with finite recall and AP; then `tools.train` and
    `tools.test` on a YAML of the same config."""
    from pdm_ssd_torch.datasets import build_dataloader
    from pdm_ssd_torch.models import build_network
    from pdm_ssd_torch.runtime import eval_utils, trainer
    from pdm_ssd_torch.tools import test as test_cli
    from pdm_ssd_torch.tools import train as train_cli
    root = mini[0]
    cfg = tiny_cfg()
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    train_prepare = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG, training=True)

    def fresh(seed):
        net = build_network(cfg.MODEL, 3, cfg.DATA_CONFIG, device='cpu', seed=seed)
        opt, sched = trainer.create_train_state(net, cfg.OPTIMIZATION, len(loader), 2)
        return net, opt, sched

    def run(net, opt, sched, epochs, ckpt_dir, start=0):
        np.random.seed(start)           # augmentation
        torch.manual_seed(start)        # the loader's shuffle
        return trainer.train_model(net, opt, sched, loader, epochs, ckpt_dir=ckpt_dir,
                                   start_epoch=start, host_prepare=train_prepare)

    _, loader, _ = build_dataloader(cfg.DATA_CONFIG, CLASS_NAMES, 2, root_path=root, workers=0,
                                    training=True, seed=0)
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
    vds, vloader, _ = build_dataloader(cfg.DATA_CONFIG, CLASS_NAMES, 2, root_path=root,
                                       workers=0, training=False)
    np.random.seed(0)
    ret = eval_utils.eval_one_epoch(resumed, vloader, vds, CLASS_NAMES, device='cpu',
                                    host_prepare=get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG))
    assert np.isfinite(ret['recall/rcnn_0.3']) and np.isfinite(ret['Car_3d/moderate_R40'])
    assert ret['infer_fps'] > 0

    yml = cfg.to_dict()
    for k in ('TAG', 'EXP_GROUP_PATH'):
        yml.pop(k, None)
    cfg_file = tmp_path / 'tiny_second.yaml'
    cfg_file.write_text(yaml.safe_dump(yml))
    common = ['--cfg_file', str(cfg_file), '--batch_size', '2', '--workers', '0', '--device',
              'cpu', '--output_dir', str(tmp_path / 'cli')]
    train_cli.main(common + ['--epochs', '1'])
    ckpt = tmp_path / 'cli' / 'ckpt' / 'checkpoint_epoch_1.pth'
    assert ckpt.exists()
    ret = test_cli.main(common + ['--ckpt', str(ckpt)])
    assert (tmp_path / 'cli' / 'eval' / 'result.pkl').exists()
    assert np.isfinite(ret['Car_3d/moderate_R40'])


def _non_finite(annos) -> int:
    return sum(int((~np.isfinite(np.asarray(a['boxes_lidar'], np.float64).reshape(-1, 7)))
                   .any(-1).sum()) for a in annos)


@pytest.fixture(scope='module')
def barely_trained(mini):
    """(cfg, net): the tiny SECOND trained 2 epochs by `train_model` on the
    port's mini set, its score threshold 0, so that every frame keeps its
    NMS_POST_MAXSIZE boxes (at 0.1 such a model keeps none)."""
    from pdm_ssd_torch.datasets import build_dataloader
    from pdm_ssd_torch.models import build_network
    from pdm_ssd_torch.runtime import trainer
    cfg = tiny_cfg()
    cfg.DATA_CONFIG.DATA_PATH = str(mini[0])
    cfg.MODEL.POST_PROCESSING.SCORE_THRESH = 0.0
    _, loader, _ = build_dataloader(cfg.DATA_CONFIG, CLASS_NAMES, 2, root_path=mini[0],
                                    workers=0, training=True, seed=0)
    net = build_network(cfg.MODEL, 3, cfg.DATA_CONFIG, device='cpu', seed=0)
    opt, sched = trainer.create_train_state(net, cfg.OPTIMIZATION, len(loader), 2)
    np.random.seed(0)
    torch.manual_seed(0)
    trainer.train_model(net, opt, sched, loader, 2,
                        host_prepare=get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG, training=True))
    return cfg, net


def _eval_both(cfg, net, mini, out) -> tuple:
    """`net` converted with `to_flax`, through both packages' `eval_one_epoch`
    over the val split (the JAX package's numpy voxelizer, which keeps the
    port's key order): (port annos, JAX annos)."""
    import pickle
    from pdm_ssd_torch.datasets import build_dataloader
    from pdm_ssd_torch.runtime import eval_utils
    from pdm_ssd_tpu.datasets import build_dataloader as j_build_dataloader
    from pdm_ssd_tpu.datasets.processor.data_processor import DataProcessor as JProcessor
    from pdm_ssd_tpu.models import build_network as j_build_network
    from pdm_ssd_tpu.runtime import eval_utils as j_eval_utils
    t_root, j_root = mini
    variables = jax.tree_util.tree_map(jnp.asarray, to_flax(net))
    vds, vloader, _ = build_dataloader(cfg.DATA_CONFIG, CLASS_NAMES, 2, root_path=t_root,
                                       workers=0, training=False)
    np.random.seed(0)
    eval_utils.eval_one_epoch(net, vloader, vds, CLASS_NAMES, device='cpu',
                              result_dir=out / 'port',
                              host_prepare=get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG))
    jcfg = JCfgNode(cfg.to_dict())
    jcfg.DATA_CONFIG.DATA_PATH = str(j_root)
    j_set, j_loader, _ = j_build_dataloader(jcfg.DATA_CONFIG, CLASS_NAMES, batch_size=2,
                                            root_path=j_root, workers=0, training=False)
    j_model = j_build_network(jcfg.MODEL, num_class=3, dataset_cfg=jcfg.DATA_CONFIG)
    (out / 'jax' / 'final_result' / 'data').mkdir(parents=True)
    native = JProcessor._native_voxelize
    JProcessor._native_voxelize = lambda *args: None
    try:
        np.random.seed(0)
        j_eval_utils.eval_one_epoch(j_model, variables['params'], variables['batch_stats'],
                                    j_loader, j_set, CLASS_NAMES, result_dir=out / 'jax',
                                    host_prepare=j_get_host_prepare(jcfg.MODEL, jcfg.DATA_CONFIG))
    finally:
        JProcessor._native_voxelize = native
    return tuple(pickle.loads((out / side / 'result.pkl').read_bytes())
                 for side in ('port', 'jax'))


def _hold_detections(t_annos, j_annos) -> None:
    """The same number of detections per frame and of boxes with a
    non-finite value; the finite boxes matched by box and class."""
    assert [len(a['name']) for a in t_annos] == [len(a['name']) for a in j_annos]
    assert sum(len(a['name']) for a in t_annos) > 0
    assert _non_finite(t_annos) == _non_finite(j_annos)
    for t, j in zip(t_annos, j_annos):
        tb, jb = (np.asarray(a['boxes_lidar'], np.float64).reshape(-1, 7) for a in (t, j))
        keep = np.isfinite(jb).all(-1)
        free = keep.copy()
        for i in np.flatnonzero(np.isfinite(tb).all(-1)):
            d = np.where(free & (j['name'] == t['name'][i]), np.abs(jb - tb[i]).max(-1), np.inf)
            k = int(np.argmin(d))
            assert d[k] <= 1e-3 * max(np.abs(jb[keep]).max(), 1.0), (t['frame_id'], i, d[k])
            free[k] = False


def test_barely_trained_second_gives_the_jax_package_non_finite_boxes(barely_trained, mini,
                                                                      tmp_path):
    """The tiny SECOND trained 2 epochs, through both packages' eval: the
    same detections and the same number of boxes with a non-finite value,
    so such boxes (a barely trained model's exp-coded sizes) are the
    reference's behaviour, not the port's."""
    _hold_detections(*_eval_both(*barely_trained, mini, tmp_path))


def test_overflowing_second_gives_the_jax_package_non_finite_boxes(barely_trained, mini,
                                                                   tmp_path):
    """The same checkpoint with one anchor's length code raised by 100 (its
    exp overflows float32 in both packages' decode): both packages keep the
    same detections, the same number of them with an infinite box, and the
    finite ones matched by box."""
    import copy
    cfg, net = barely_trained
    planted = copy.deepcopy(net)
    with torch.no_grad():
        planted.dense_head.conv_box.bias[3] += 100.0       # Car, rotation 0: dx
    t_annos, j_annos = _eval_both(cfg, planted, mini, tmp_path)
    _hold_detections(t_annos, j_annos)
    assert _non_finite(t_annos) > 0
    print('non-finite boxes:', _non_finite(t_annos), 'of', sum(len(a['name']) for a in t_annos))
