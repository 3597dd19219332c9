"""CaDDN in the port against the JAX package, on the CPU: `ops/depth`
(`bin_depths` in its three modes, `compute_fg_mask`, `ddn_loss` and its
gradient), the frustum's trilinear sample against a float64 numpy
recomputation, and the tiny CaDDN (`synthetic.tiny_caddn_cfg`): weights,
depth logits, the sampled BEV map, the head's maps, predict, the losses
with the DDN term and every gradient (in float32, and in float64), and
six training steps.

Inputs come from numpy seeds; both packages run float32; JAX runs jitted.
Each tolerance stands beside its reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_ssd_torch.models.detectors.caddn import (frustum_corners, lid_bin, sample_frustum,
                                                  voxel_centers)
from pdm_ssd_torch.ops import depth as t_depth
from pdm_ssd_torch.utils import synthetic
from pdm_ssd_torch.utils.weights import from_flax, to_flax
from pdm_ssd_tpu.ops import depth as j_depth
from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_harness import (ModelPair, assert_close_to_scale, check_weights_round_trip,
                                leaves, match_detections, open_score_gate_flax,
                                port_loss_and_grads, rel_l2, to_numpy, twin_steps)

# elementwise passes in float32 in the same order: bins and masks exact, the
# fractional bins within a few ulps (sqrt and log may round their last bit
# apart); SID's difference of two logs cancels near DEPTH_MIN, where an ulp
# of log (1.2e-7 at log 3) times 80 / (log 47.8 - log 3) is 3.5e-6 of a bin
BIN_RTOL = 1e-6
BIN_ATOL = 1e-5
# one loss of a few hundred cells, and its gradient
LOSS_RTOL = 1e-6
# a few layers of float32 sums in another order (the tiny model's maps)
MODEL_RTOL = 1e-4
# the losses of one batch
MODEL_LOSS_RTOL = 1e-5
# both packages in float64: the same sums, rounded at 2^-52 (measured within
# 1.4e-15 for the losses and 7e-14 relative L2 for the gradients)
F64_RTOL = 1e-9
# per-leaf gradients, relative L2: every leaf of the tiny model lies within
# 3.8e-5 of the JAX package's (its image backbone's BatchNorm scales, whose
# gradients gather the DDN loss's and the frustum's through a training-mode
# BatchNorm)
GRAD_REL_L2 = 1e-3
# detections matched by box: float32 rounding of the decode
BOX_ATOL = 1e-3
# the trilinear sample against float64 numpy of the same corners and weights
SAMPLE_RTOL = 1e-6
# each loss term of the first few training steps: float32 rounding of both
# packages, which Adam's first updates (the size of the rate, whatever the
# gradient's size) carry into the weights; measured within 2.7e-5 over the
# six steps of test_train_steps_track_jax
STEPS_RTOL = 1e-3
INPUT_KEYS = ('camera_imgs', 'trans_lidar_to_cam', 'trans_cam_to_img')


def _depths(rng, shape):
    """Depths over and past the LID range: negative, below DEPTH_MIN, inside,
    beyond DEPTH_MAX, and a NaN and an inf."""
    d = rng.uniform(-5.0, 60.0, shape).astype(np.float32)
    d.flat[0], d.flat[1], d.flat[2] = np.nan, np.inf, 2.0
    return d


@pytest.mark.parametrize('mode', ['UD', 'LID', 'SID'])
@pytest.mark.parametrize('target', [False, True])
def test_bin_depths_match_jax(mode, target):
    """Fractional bins within BIN_RTOL of the JAX package's (NaN where its
    are); with `target`, the integer bins equal, out-of-range and non-finite
    depths in the "beyond range" class 80."""
    d = _depths(np.random.RandomState(0), (3, 40, 50))
    want = np.asarray(j_depth.bin_depths(jnp.asarray(d), mode, 2.0, 46.8, 80, target=target))
    got = t_depth.bin_depths(torch.from_numpy(d), mode, 2.0, 46.8, 80, target=target).numpy()
    if target:
        np.testing.assert_array_equal(got, want)
        assert (got == 80).any() and ((got >= 0) & (got < 80)).any()
    else:
        np.testing.assert_allclose(got, want, rtol=BIN_RTOL, atol=BIN_ATOL, equal_nan=True)


@pytest.mark.parametrize('masked', [False, True])
def test_fg_mask_matches_jax(masked):
    """The foreground cells of 2D boxes at a downsampling of 4, boxes at
    fractional pixels and past the image; with a box mask that drops one
    real box, and without (all-zero boxes not counted)."""
    rng = np.random.RandomState(1)
    boxes = np.sort(rng.uniform(-10, 120, (2, 5, 2, 2)), axis=2).transpose(0, 1, 3, 2) \
        .reshape(2, 5, 4)[..., [0, 2, 1, 3]].astype(np.float32)
    boxes[1, 4] = 0
    mask = np.ones((2, 5), bool)
    mask[0, 2] = False
    bm = (torch.from_numpy(mask), jnp.asarray(mask)) if masked else (None, None)
    want = np.asarray(j_depth.compute_fg_mask(jnp.asarray(boxes), (2, 24, 30), 4, bm[1]))
    got = t_depth.compute_fg_mask(torch.from_numpy(boxes), (2, 24, 30), 4, bm[0]).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


def test_ddn_loss_and_its_gradient_match_jax():
    """The DDN loss and its fg / bg parts within LOSS_RTOL of the JAX
    package's, and the gradient in the logits within LOSS_RTOL relative L2,
    on random logits over 9 bins and depths in and out of range."""
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 8, 12, 9).astype(np.float32)
    dm = _depths(rng, (2, 8, 12))
    boxes = np.array([[[10., 8., 60., 40.], [0, 0, 0, 0]], [[30., 2., 90., 60.],
                                                            [5., 5., 20., 30.]]], np.float32)
    mask = np.array([[True, False], [True, True]])
    disc = {'mode': 'LID', 'depth_min': 2.0, 'depth_max': 40.0}

    def j_loss(lg):
        return j_depth.ddn_loss(lg, jnp.asarray(dm), jnp.asarray(boxes), jnp.asarray(mask),
                                downsample_factor=8, disc_cfg=disc)

    (want, j_tb), j_grad = jax.value_and_grad(j_loss, has_aux=True)(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    got, tb = t_depth.ddn_loss(lg, torch.from_numpy(dm), torch.from_numpy(boxes),
                               torch.from_numpy(mask), downsample_factor=8, disc_cfg=disc)
    got.backward()
    assert set(tb) == set(j_tb)
    for k in tb:
        np.testing.assert_allclose(float(tb[k].detach()), float(j_tb[k]), rtol=LOSS_RTOL, err_msg=k)
    assert rel_l2(lg.grad.numpy(), np.asarray(j_grad)) <= LOSS_RTOL


def test_frustum_sample_is_the_trilinear_interpolation():
    """`sample_frustum` of the corners of `frustum_corners` against the same
    weighted sum in float64 numpy, the invalid voxels 0, the 8 weights of
    each voxel summing to 1, the LID bin 0 at DEPTH_MIN: the tiny grid seen
    by the tiny camera, within SAMPLE_RTOL of the largest value."""
    cfg = synthetic.tiny_caddn_cfg(synthetic.caddn_kitti())
    batch = synthetic.caddn_batch(2, 512, cfg, seed=3)
    rng = np.random.RandomState(4)
    frustum = torch.from_numpy(rng.randn(2, 8, 12, 8, 8).astype(np.float32))
    centers = voxel_centers((32, 32, 4), (1.0, 1.0, 1.0), (2.0, -16.0, -3.0))
    rows, weights, valid = frustum_corners(centers, batch['trans_lidar_to_cam'],
                                           batch['trans_cam_to_img'], (64, 96), (8, 12, 8),
                                           (2.0, 40.0))
    flat = frustum.reshape(2, -1, 8)
    got = sample_frustum(flat, rows, weights, valid).numpy()
    f64 = flat.double().numpy()
    want = sum(np.take_along_axis(f64, r.long().numpy()[..., None], 1)
               * w.double().numpy()[..., None] for r, w in zip(rows, weights))
    want = np.where(valid.numpy()[..., None], want, 0.0)
    assert_close_to_scale(got, want, SAMPLE_RTOL, 'sample')
    assert 0.2 < valid.float().mean() < 0.9
    np.testing.assert_allclose(weights.sum(0).numpy(), 1.0, rtol=1e-6)
    assert float(lid_bin(torch.tensor(2.0), 2.0, 40.0, 8)) == 0.0


@pytest.fixture(scope='module')
def caddn():
    """The tiny CaDDN in both packages on a batch of two 64 x 96 images seen
    by the mini KITTI camera scaled to them, 4 boxes a frame with their 2D
    boxes and the depth maps of 2048 points a cloud, its weights started
    from the seeded port model's."""
    cfg = synthetic.tiny_caddn_cfg(synthetic.caddn_kitti())
    batch = {k: v.numpy() for k, v in synthetic.caddn_batch(2, 2048, cfg, seed=0, M=4).items()}
    start = to_flax(synthetic.random_model(cfg, 'cpu', seed=0))
    return ModelPair(cfg, B=2, seed=0, batch={**batch, 'points': np.zeros((2, 1, 4), np.float32)},
                     variables=start, input_keys=INPUT_KEYS)


def test_weights_have_the_jax_layout(caddn):
    """The port's tensors in the flax layout have the paths, shapes and
    dtypes of the JAX package's init (traced) and map back leaf for leaf."""
    check_weights_round_trip(caddn, ['depth_head', 'image_backbone.stem', 'backbone_2d.down0_conv0',
                                     'dense_head.conv_cls'])
    params = to_flax(caddn.net)['params']
    assert params['depth_head']['kernel'].shape == (1, 1, 16, 8 + 1 + 8)


def test_forward_and_predict_match_jax(caddn):
    """The eval forward: the depth logits, the sampled BEV map (32 x 32 cells
    of 4 x 8 channels) and the head's maps within MODEL_RTOL of scale; then,
    with the classification bias at 0 in both packages, `predict` against
    the JAX package's post-processing of its own forward: the same
    detections by box and label."""
    J = caddn.jax_out
    with torch.no_grad():
        T = to_numpy(caddn.net(caddn.torch_inputs()))
    assert T['spatial_features'].shape == (2, 32, 32, 32)
    assert (T['spatial_features'] != 0).mean() > 0.2
    for k in ('depth_logits', 'spatial_features', 'spatial_features_2d', 'anchor_cls_preds',
              'anchor_box_preds', 'anchor_dir_preds'):
        assert_close_to_scale(T[k], J[k], MODEL_RTOL, k)
    gate_open = open_score_gate_flax(caddn.variables)
    want = caddn.jax_method(caddn.jax_model.post_process, caddn.jax_eval_forward(gate_open))
    caddn.net.load_state_dict(from_flax(gate_open, caddn.net))
    try:
        got = caddn.net.predict(caddn.torch_inputs())
    finally:
        caddn.net.load_state_dict(from_flax(caddn.variables, caddn.net))
    assert match_detections(got, want, BOX_ATOL) >= 8


def test_training_loss_and_gradients_match_jax(caddn):
    """The training loss with its DDN terms within MODEL_LOSS_RTOL and every
    gradient within GRAD_REL_L2 relative L2 of the JAX package's (the depth
    head's from both the DDN loss and the frustum); the BatchNorm
    statistics after the step."""
    batch = caddn.torch_batch()
    del batch['points']
    _, tb, grads, stats = port_loss_and_grads(caddn, batch)
    _, j_tb, j_grads, j_stats = caddn.jax_loss_and_grads()
    assert {'ddn_loss', 'ddn_fg_loss', 'ddn_bg_loss', 'anchor_cls_loss'} <= set(tb)
    assert set(tb) == set(j_tb)
    assert tb['ddn_fg_loss'] > 0 and tb['ddn_bg_loss'] > 0
    for k in tb:
        np.testing.assert_allclose(tb[k], j_tb[k], rtol=MODEL_LOSS_RTOL, err_msg=k)
    got, want = dict(leaves(grads)), dict(leaves(j_grads))
    assert set(got) == set(want)
    for k in want:
        assert rel_l2(got[k], want[k]) <= GRAD_REL_L2, k
    assert np.linalg.norm(dict(leaves(grads))['depth_head/kernel']) > 0
    got, want = dict(leaves(stats)), dict(leaves(j_stats))
    for k in want:
        assert rel_l2(got[k], want[k]) <= MODEL_RTOL, k


def test_train_steps_track_jax(caddn):
    """Six steps of both packages' training from the same weights on the
    batch, with the optimizer and schedule of `caddn_kitti()` over 2 epochs
    of 10 steps (`torch_port_harness.twin_steps`): every loss term of every
    step within STEPS_RTOL of the JAX package's, so the steps after the
    first, whose gradients no other check holds, follow the reference; and
    the loss falls in both."""
    batch = caddn.torch_batch()
    del batch['points']
    j_terms, t_terms = twin_steps(caddn.jax_model, caddn.variables, caddn.net,
                                  caddn.cfg.OPTIMIZATION, [(caddn.batch, batch)] * 6, 10, 2,
                                  torch.zeros((2, 1)), caddn._jax_value_and_grad())
    for j, t in zip(j_terms, t_terms):
        assert set(j) == set(t) and j['ddn_loss'] > 0
        for k in j:
            assert abs(t[k] - j[k]) <= STEPS_RTOL * abs(j[k]), k
    assert t_terms[-1]['loss'] < t_terms[0]['loss'] and j_terms[-1]['loss'] < j_terms[0]['loss']


def test_float64_loss_and_gradients_match_jax(caddn):
    """The training loss and every gradient in float64, the port's model and
    batch cast (the voxel centres in the frustum's dtype, as the JAX
    package's follow its default float), within F64_RTOL of the JAX
    package's float64 run: the reference that tells float32 rounding from a
    difference of algorithm."""
    batch = caddn.torch_batch()
    del batch['points']
    _, tb, grads, _ = port_loss_and_grads(caddn, batch, torch.float64)
    j_tb, j_grads = caddn.jax_f64_loss_and_grads()
    assert set(tb) == set(j_tb) and tb['ddn_loss'] > 0
    for k in tb:
        np.testing.assert_allclose(tb[k], j_tb[k], rtol=F64_RTOL, err_msg=k)
    got, want = dict(leaves(grads)), dict(leaves(j_grads))
    assert set(got) == set(want)
    for k in want:
        assert rel_l2(got[k], want[k]) <= F64_RTOL, k
