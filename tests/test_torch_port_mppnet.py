"""MPPNet in the port against the JAX package, on the CPU: the tiny
`mppnet_mini.yaml` (`synthetic.tiny_mppnet_cfg`) on batches of the
generated mini-Waymo set, from the port's seeded weights. The weights'
layout, the trajectories' match table, the forward on the three feature
paths (the multi-frame stack on offline proposals, on NMS proposals, and
given trajectories), three streamed steps of the memory bank, the loss and
every gradient, two training steps, predict, and an ROI that holds no point.

Inputs come from numpy seeds; both packages run float32; JAX runs jitted,
each program compiled once. Each tolerance stands beside its reason.
"""
import functools
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pdm_ssd_torch.utils import synthetic
from pdm_ssd_torch.utils.config import CfgNode, cfg_from_yaml_file
from pdm_ssd_torch.utils.weights import from_flax
from pdm_ssd_tpu.utils.config import CfgNode as JCfgNode
from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_harness import (ModelPair, assert_close_to_scale, check_predict,
                                check_weights_round_trip, hold_to_jax, jax_target_draw, leaves,
                                match_detections, port_loss_and_grads, rel_l2, to_numpy,
                                to_torch, train_steps)

REPO = Path(__file__).resolve().parents[1]
MINI_CFG = 'configs/waymo_models/mppnet_mini.yaml'
FRAMES = 8
# the clouds of the pair's batch: frames 5 and 7 of the sequence
CLOUDS = (5, 7)
# the offline proposal slot given a box 20 m above every point, in every
# frame: a valid trajectory whose crops hold no point
EMPTY_SLOT = 15
# a forward fed the same inputs: float32 sums in another order (the split
# first layer of `sa_mlp`, the attention's products)
MODULE_RTOL = 1e-4
# the losses of one batch: float32 sums in another order
LOSS_RTOL = 1e-5
# per-leaf gradients, relative L2; measured 2.0e-4 at worst on the tiny
# model (the motion MLP's first layer)
GRAD_REL_L2 = 1e-3
# where a leaf strays past GRAD_REL_L2, the JAX package's float32 within
# this of its float64 run (`hold_to_jax`)
JAX_F32_GRAD_REL_L2 = 1e-2
# leaves whose gradient is 0 in exact arithmetic and float32 noise in both
# packages: an attention key's bias (the softmax cancels a shift shared by
# a query's scores) and a bias that feeds a BatchNorm in training through
# linear maps only (the batch mean cancels it: `up_geometry.out` into
# `sa_mlp`, `cross_group`'s value and output biases into `cls_trunk`); each
# held by its norm on each side against the largest gradient's
NULL_GRAD_RTOL = 1e-6
NULL_LEAVES = ('attn/key/bias', 'cross_group/key/bias', 'cross_group/value/bias',
               'cross_group/out/bias', 'up_geometry/out/bias')
# the BatchNorm running statistics after one training step
STATS_RTOL = 1e-5
# boxes decoded from the head's residuals
BOX_ATOL = 1e-4


def load_cfg(name=MINI_CFG):
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        return cfg_from_yaml_file(name, CfgNode())
    finally:
        os.chdir(cwd)


def tiny_cfg():
    return synthetic.tiny_mppnet_cfg(load_cfg())


def numpy_batch(ds, indices, drop=()) -> dict:
    """The collated samples as the model's numpy inputs and ground truth,
    with the empty proposal planted (when the batch holds proposals)."""
    from pdm_ssd_torch.runtime.trainer import DEVICE_KEYS
    raw = ds.collate_batch([ds[i] for i in indices])
    out = {k: np.ascontiguousarray(raw[k]) for k in DEVICE_KEYS if k in raw and k not in drop}
    if 'roi_boxes' in out:
        out['roi_boxes'][:, :, EMPTY_SLOT] = [10.0, 0.0, 20.0, 4.0, 2.0, 1.7, 0.0, 0.0, 0.0]
        out['roi_scores'][:, :, EMPTY_SLOT] = 0.5
        out['roi_labels'][:, :, EMPTY_SLOT] = 1
    return out


@pytest.fixture(scope='module')
def mini(tmp_path_factory):
    return tmp_path_factory.mktemp('mini_waymo')


@pytest.fixture(scope='module')
def pair(mini):
    """The tiny MPPNet in both packages from the port's seeded weights
    (BatchNorm statistics, scales and biases randomized), on the eval batch
    of clouds CLOUDS with their offline proposals and ground truth."""
    cfg = tiny_cfg()
    ds = synthetic.waymo_set(cfg, mini, FRAMES, n_bg=1200)
    np.random.seed(0)
    batch = numpy_batch(ds, CLOUDS)
    return ModelPair(cfg, batch=batch, bias_scale=0.1, input_keys=tuple(batch))


def jax_head(cfg):
    from pdm_ssd_tpu.models.roi_heads.mppnet_head import MPPNetHead
    return MPPNetHead(model_cfg=JCfgNode(cfg.MODEL.ROI_HEAD.to_dict()), num_class=1)


def test_weights_have_the_jax_layout(pair):
    """The port's tensors in the flax layout have the paths, shapes and dtypes
    of the JAX package's init (traced), the trajectory query, the encoder's
    attention and LayerNorms and the BatchNorm statistics of `sa_mlp` and
    `cls_trunk` among them, and map back unchanged."""
    check_weights_round_trip(pair, [
        'roi_head.enc_0.attn.query', 'roi_head.enc_0.attn.out', 'roi_head.enc_0.ln1',
        'roi_head.enc_0.ln2', 'roi_head.cross_group.value', 'roi_head.sa_mlp.BatchNorm_1',
        'roi_head.cls_trunk.BatchNorm_0', 'roi_head.jointembed.l2', 'roi_head.seqbox_reg'])
    head = pair.variables['params']['roi_head']
    assert head['traj_query'].shape == (1, 1, 32)
    assert set(pair.variables['batch_stats']['roi_head']) == {'sa_mlp', 'cls_trunk'}


def _trajectory_case(rng):
    """Two clouds of 6 ROIs with velocities and 8 proposals a frame: ROIs 0
    and 1 followed by proposals at their moved positions (ROI 1's twice, so
    its match is a tie that the first index takes), ROI 2 moving away from
    every proposal, ROI 3 masked, the rest near decoys."""
    B, R, P, T = 2, 6, 8, 4
    rois = np.zeros((B, R, 9), np.float32)
    rois[..., :2] = rng.uniform(5, 25, (B, R, 2))
    rois[..., 2] = -1.0
    rois[..., 3:6] = [4.0, 2.0, 1.5]
    rois[..., 6] = rng.uniform(-np.pi, np.pi, (B, R))
    rois[..., 7:9] = rng.uniform(-3, 3, (B, R, 2))
    props = np.zeros((B, T, P, 9), np.float32)
    props[..., :7] = [60, 30, -1, 4, 2, 1.5, 0]
    for t in range(T):
        pos = rois.copy()
        pos[..., :2] -= pos[..., 7:9] * 0.1 * t
        props[:, t, 0] = pos[:, 0]
        props[:, t, 2] = pos[:, 1]
        props[:, t, 5] = pos[:, 1]
        props[:, t, 3, :7] = pos[:, 4, :7] + [0.6, 0.3, 0, 0, 0, 0, 0.2]
        props[:, t, 6, :7] = pos[:, 5, :7] + [2.0, 1.0, 0, 0, 0, 0, 0.0]
    rois[:, 2, 7:9] = [30.0, 0.0]
    mask = np.ones((B, R), bool)
    mask[:, 3] = False
    return rois, mask, props


def test_generate_trajectory_match_table_equals_jax(pair):
    """`generate_trajectory` with the match table on the same ROIs and
    proposals: the match indices exactly equal (a tie to the first index),
    the validity equal, the trajectories within float32 rounding."""
    rois, mask, props = _trajectory_case(np.random.RandomState(4))
    head = jax_head(pair.cfg)
    traj = jax.jit(lambda r, m, p: head.generate_trajectory(r, m, p, with_match=True))
    want = to_numpy(traj(rois, mask, props))
    got = to_numpy(pair.net.roi_head.generate_trajectory(
        torch.from_numpy(rois), torch.from_numpy(mask), torch.from_numpy(props), with_match=True))
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    assert (got[2][:, 1:, 1] == 2).all() and got[1][:, 1:, 0].all()
    assert not got[1][:, 1:, 2].any() and not got[1][:, :, 3].any()


def _port_forward(pair, batch: dict) -> dict:
    with torch.no_grad():
        return to_numpy(pair.net(to_torch(batch)))


def _jax_forward(pair, batch: dict) -> dict:
    fwd = jax.jit(lambda v, b: pair.jax_model.apply(v, b, training=False))
    return to_numpy(fwd(pair.variables, batch))


def _assert_forward(got, want, exact=('rois', 'roi_mask', 'trajectory_valid')):
    for k in exact:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ('rois', 'trajectory_rois', 'rcnn_cls_preds', 'rcnn_reg_preds',
              'rcnn_reg_aux_preds'):
        assert_close_to_scale(got[k], want[k], MODULE_RTOL, k)
        assert np.isfinite(got[k]).all(), k


@pytest.mark.parametrize('path', ['offline_proposals', 'nms_proposals', 'given_trajectories'])
def test_forward_matches_jax_on_each_feature_path(pair, mini, path):
    """The eval forward on the three feature paths of the head: the
    multi-frame stack with the offline proposals (their trajectories matched
    through every frame, the empty ROI's crops holding no point, the padded
    slots all invalid); with the first stage's NMS proposals instead
    (static trajectories, copies of frame 0: the same boxes kept, decoded
    from the two packages' first stages within float32 rounding); and with
    the JAX package's trajectories of the first path given, against that
    path's JAX forward (which computes the same function of them; a
    program of its own would add a compile). The validity equal, the
    offline ROIs too, the rest within MODULE_RTOL of scale."""
    if path == 'offline_proposals':
        got, want = _port_forward(pair, pair.inputs), pair.jax_out
        valid = got['trajectory_valid']
        assert valid[:, :, EMPTY_SLOT].all() and valid[:, 1:].sum() > 4
        assert not valid[:, 0, ~got['roi_mask'][0]].any()
    elif path == 'nms_proposals':
        ds = synthetic.waymo_set(tiny_cfg(), mini, FRAMES)
        np.random.seed(1)
        batch = numpy_batch(ds, CLOUDS, drop=('roi_boxes', 'roi_scores', 'roi_labels'))
        got, want = _port_forward(pair, batch), _jax_forward(pair, batch)
        assert (got['trajectory_rois'] == got['trajectory_rois'][:, :1]).all()
        assert got['roi_mask'].all()
        _assert_forward(got, want, exact=('roi_mask', 'trajectory_valid'))
        return
    else:
        want = pair.jax_out
        batch = {**pair.inputs, 'trajectory_rois': want['trajectory_rois'],
                 'trajectory_valid': want['trajectory_valid']}
        got = _port_forward(pair, batch)
    _assert_forward(got, want)


def test_an_roi_with_no_point_pools_zeros_and_stays_finite(pair):
    """The empty ROI: every frame's crop of it holds no point, so its proxies
    pool zeros (the masked max over no point) and its predictions stay
    finite (its gradients too: `test_training_loss_and_gradients_match_jax`
    holds every gradient of the batch that holds it)."""
    net = pair.net
    batch = to_torch(pair.inputs)
    with torch.no_grad():
        out = net(dict(batch))
        head = net.roi_head
        diag = torch.linalg.norm(out['trajectory_rois'][..., 3:6], dim=-1)
        geo = head.frame_geometry(batch['points_multi_frame'][:, 0], out['trajectory_rois'][:, 0],
                                  diag[:, 0], out['trajectory_valid'][:, 0], out['roi_mask'], 0)
    assert (geo[:, EMPTY_SLOT] == 0).all() and (geo[:, 0] != 0).any()
    assert np.isfinite(to_numpy(out['rcnn_reg_preds'])).all()


def test_memory_bank_streams_three_steps_as_jax(pair, mini):
    """`predict_with_state` over three steps from an empty bank
    (`init_memory`), jitted in the JAX package. Each step reads the clouds
    CLOUDS with their points sampled anew and the offline proposals' slots
    permuted, so that each ROI matches the bank's box of the same object in
    another slot. After each step the same detections (matched by box) and
    the same bank (boxes and validity equal, features within MODULE_RTOL of
    scale); the bank rolls by one frame a step; the match table is not the
    identity; a blank bank at the third step changes the scores."""
    cfg = tiny_cfg()
    ds = synthetic.waymo_set(cfg, mini, FRAMES)
    net, model = pair.net, pair.jax_model
    R = cfg.DATA_CONFIG.SEQUENCE_CONFIG.MAX_PRED_BOXES
    step = jax.jit(lambda v, b, m: model.apply(v, {**b, 'mppnet_memory': m},
                                               method=model.predict_with_state))
    t_mem, j_mem = net.init_memory(2, R), to_numpy(model.init_memory(2, R))
    assert t_mem['feat'].shape == (2, 3, R, 8, 32)
    banks, rng = [], np.random.RandomState(3)
    for s in range(3):
        np.random.seed(10 + s)
        batch = numpy_batch(ds, CLOUDS, drop=('points_multi_frame',))
        perm = rng.permutation(R)
        for k in ('roi_boxes', 'roi_scores', 'roi_labels'):
            batch[k] = np.ascontiguousarray(batch[k][:, :, perm])
        want_det, j_mem = to_numpy(step(pair.variables, batch, j_mem))
        got_det, t_mem = net.predict_with_state({**to_torch(batch), 'mppnet_memory': t_mem})
        assert match_detections(got_det, want_det, BOX_ATOL) > 0
        got_mem = to_numpy(t_mem)
        for k in ('rois', 'valid'):
            np.testing.assert_array_equal(got_mem[k], j_mem[k], err_msg=(s, k))
        assert_close_to_scale(got_mem['feat'], j_mem['feat'], MODULE_RTOL, f'feat {s}')
        banks.append(got_mem)
    np.testing.assert_array_equal(banks[2]['feat'][:, 1], banks[1]['feat'][:, 0])
    np.testing.assert_array_equal(banks[2]['rois'][:, 2], banks[0]['rois'][:, 0])
    assert banks[1]['valid'][:, 0].any()
    with torch.no_grad():
        out = net({**to_torch(batch), 'mppnet_memory': to_torch(banks[1])})
    match = out['trajectory_valid'][:, 1] & out['roi_mask']
    assert match.sum() >= 4 and match.sum() == out['roi_mask'].sum()
    blank, _ = net.predict_with_state({**to_torch(batch), 'mppnet_memory': net.init_memory(2, R)})
    last, _ = net.predict_with_state({**to_torch(batch), 'mppnet_memory': to_torch(banks[1])})
    assert not torch.allclose(blank['pred_scores'], last['pred_scores'])


def test_training_loss_and_gradients_match_jax(pair):
    """The training forward on the JAX package's target draw: the losses
    (the anchor head's, the ROI head's with the corner and the trajectory
    branch's auxiliary term) within LOSS_RTOL, every gradient within
    GRAD_REL_L2 or held to the JAX package's float64 run (`hold_to_jax`),
    the leaves whose gradient is 0 in exact arithmetic by their norm, and
    the BatchNorm running statistics after the step (`sa_mlp`'s moved once a
    radius a frame) within STATS_RTOL."""
    batch = {**pair.torch_inputs(), 'roi_target_rand': jax_target_draw(pair)}
    _, tb, grads, stats = port_loss_and_grads(pair, batch)
    _, j_tb, j_grads, j_stats = pair.jax_loss_and_grads()
    assert set(tb) == set(j_tb) and 'rcnn_reg_aux_loss' in tb
    assert all(j_tb[k] > 0 for k in ('rcnn_reg_loss', 'rcnn_corner_loss', 'rcnn_reg_aux_loss'))
    exact = functools.lru_cache(pair.jax_f64_loss_and_grads)
    hold_to_jax(tb, j_tb, lambda: exact()[0], LOSS_RTOL, JAX_F32_GRAD_REL_L2, 0)
    got, want = dict(leaves(grads)), dict(leaves(j_grads))
    assert all(np.isfinite(g).all() for g in got.values())      # the empty ROI's among them
    null = [k for k in want if k.endswith(NULL_LEAVES)]
    assert len(null) == 5
    top = max(np.abs(w).max() for w in want.values())
    for k in null:
        assert np.linalg.norm(got[k]) <= NULL_GRAD_RTOL * top, k
        assert np.linalg.norm(want[k]) <= NULL_GRAD_RTOL * top, k
    rest = [k for k in want if k not in null]
    hold_to_jax({k: got[k] for k in rest}, {k: want[k] for k in rest}, lambda: exact()[1],
                GRAD_REL_L2, JAX_F32_GRAD_REL_L2, 4)
    got_s = dict(leaves(stats))
    for k, w in leaves(j_stats):
        assert rel_l2(got_s[k], w) <= STATS_RTOL, k


def test_two_training_steps_match_jax(pair):
    """Two steps of both packages' training from the pair's weights on its
    batch (the config's Adam one-cycle schedule, the same target draw): the
    loss of each step within LOSS_RTOL, and lower after the first step."""
    j_terms, t_terms = train_steps(pair, 2)
    for j, t in zip(j_terms, t_terms):
        np.testing.assert_allclose(t['loss'], j['loss'], rtol=LOSS_RTOL)
    assert t_terms[1]['loss'] < t_terms[0]['loss']


def test_predict_matches_jax(pair):
    """`predict` of the port against the JAX package's post-processing of its
    own eval forward: the same boxes kept per cloud, matched by box and
    label, every kept score above the tie level (no two equal)."""
    n = check_predict(pair, BOX_ATOL)
    assert n >= 4
    with torch.no_grad():
        det = to_numpy(pair.net.predict(pair.torch_inputs()))
    for b in range(2):
        kept = det['pred_scores'][b][det['pred_mask'][b]]
        assert len(np.unique(kept)) == len(kept)
    pair.net.load_state_dict(from_flax(pair.variables, pair.net))
