"""TransFusion in the port against the JAX package, on the CPU: the
position encoding, the exact LAP (`ops/lap.py`: `np_lap`, `np_lap_batch`,
`lap_host` and `auction_lap`) against scipy and the JAX package's solvers at
the JAX tests' shapes, and the tiny `transfusion.yaml`
(`synthetic.tiny_transfusion_cfg`: the JAX package's zoo widths,
HIDDEN_CHANNEL 16, NUM_PROPOSALS 16, NUM_HEADS 2): weights, forward, the
queries' assignment, the three losses, gradients and predict.

Inputs come from numpy seeds; both packages run float32; JAX runs jitted.
Each tolerance stands beside its reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from pdm_ssd_torch.models.dense_heads.transfusion_head import _pos_encoding as t_pos_encoding
from pdm_ssd_torch.ops import lap as t_lap
from pdm_ssd_torch.utils import synthetic
from pdm_ssd_torch.utils.weights import from_flax, to_flax
from pdm_ssd_tpu.models.dense_heads.transfusion_head import _pos_encoding as j_pos_encoding
from pdm_ssd_tpu.ops import lap as j_lap
from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_port_harness import (ModelPair, assert_close_to_scale, leaves, load_cfg,
                                match_detections, port_loss_and_grads, rel_l2, to_numpy)

# the tiny model's maps and query predictions: float32 sums in another order
# (measured 5e-7 of scale)
MODEL_RTOL = 1e-4
# the losses of one batch (measured 1e-7 apart)
LOSS_RTOL = 1e-5
# per-leaf gradients, relative L2 (measured at most 3e-6)
GRAD_REL_L2 = 1e-4
# an attention key's bias shifts all of a query's scores alike, which the
# softmax cancels: its gradient is 0 in exact arithmetic and float32 noise in
# both packages (about 2e-9 against a largest gradient of 9.5), held by its
# norm on each side against the largest gradient's
NULL_GRAD_RTOL = 1e-6
# decoded boxes matched between the two packages' detections
BOX_ATOL = 1e-3
# the JAX tests' LAP shapes (tests/test_lap.py)
LAP_SHAPES = [(5, 5), (8, 20), (16, 16), (32, 200)]
AUCTION_SHAPES = [(5, 5), (8, 20), (16, 16)]
# the JAX package's auction, compiled once a shape (masks always given)
j_auction = jax.jit(j_lap.auction_lap)


@pytest.mark.parametrize('hwc', [(3, 4, 16), (50, 44, 16), (7, 5, 6), (200, 176, 128)])
def test_pos_encoding_is_the_jax_packages_exactly(hwc):
    """The sines and cosines of y then x, C / 4 channels each, frequencies
    10000^(-k / (C / 4 - 1)) (the `c4 - 1` divisor; C = 6 leaves its last
    2 channels 0): equal bit for bit."""
    want = j_pos_encoding(*hwc)
    got = t_pos_encoding(*hwc)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _lap_cost(kind: str, shape, rng) -> np.ndarray:
    if kind == 'ties':      # integer costs of four values: many optimal matchings
        return rng.randint(0, 4, size=shape).astype(np.float64)
    return rng.randn(*shape) * 10


def _total(cost, assign) -> float:
    rows = np.where(assign >= 0)[0]
    assert len(set(assign[rows].tolist())) == len(rows), 'an item assigned twice'
    return float(cost[rows, assign[rows]].sum())


@pytest.mark.parametrize('kind', ['random', 'ties'])
@pytest.mark.parametrize('shape', LAP_SHAPES)
def test_np_lap_is_the_jax_packages_and_optimal(shape, kind):
    """`np_lap` on float64 costs, random and tie-heavy: the JAX package's
    `np_lap`'s assignment exactly (the same algorithm, the same float64
    steps), and scipy's optimal total cost."""
    rng = np.random.RandomState(7)
    for _ in range(8):
        cost = _lap_cost(kind, shape, rng)
        got = t_lap.np_lap(cost)
        np.testing.assert_array_equal(got, j_lap.np_lap(cost))
        r, c = linear_sum_assignment(cost)
        np.testing.assert_allclose(_total(cost, got), cost[r, c].sum(), rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize('shape', LAP_SHAPES)
def test_np_lap_batch_and_lap_host_mask_rows(shape):
    """Three clouds with masked rows (one cloud with none valid): -1 at the
    masked rows, the JAX package's `np_lap_batch` exactly, each cloud's
    valid rows at scipy's optimum; `lap_host` the same from tensors."""
    rng = np.random.RandomState(8)
    M, Q = shape
    cost = rng.randn(3, M, Q).astype(np.float32)
    cost[1, :, :2] = np.round(cost[1, :, :2])            # a few ties
    mask = rng.rand(3, M) > 0.3
    mask[2] = False
    got = t_lap.np_lap_batch(cost, mask)
    np.testing.assert_array_equal(got, j_lap.np_lap_batch(cost, mask))
    assert (got[~mask] == -1).all()
    for b in range(2):
        rows = np.where(mask[b])[0]
        r, c = linear_sum_assignment(cost[b][rows].astype(np.float64))
        np.testing.assert_allclose(_total(cost[b].astype(np.float64), got[b]),
                                   cost[b][rows][r, c].astype(np.float64).sum(), rtol=1e-9)
    host = t_lap.lap_host(torch.from_numpy(cost), torch.from_numpy(mask))
    assert host.dtype == torch.int32
    np.testing.assert_array_equal(host.numpy(), got)


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('shape', AUCTION_SHAPES)
def test_auction_lap_is_the_jax_packages(shape, masked):
    """`auction_lap` in torch, step for step the JAX package's (the same
    float32 benefits, prices and bids): its assignment equal to the JAX
    package's, -1 at masked bidders, no masked item taken, and the total
    cost optimal (scipy) on the valid rows and items within the rounding
    of the benefits to integers (1e-5 of the largest cost a row)."""
    rng = np.random.RandomState(9)
    M, Q = shape
    for _ in range(3):
        cost = (rng.randn(M, Q) * 10).astype(np.float32)
        bm = np.ones(M, bool)
        im = np.ones(Q, bool)
        if masked:          # about 30 % of the bidders, and 2 items no valid bidder needs
            bm[rng.rand(M) < 0.3] = False
            bm[0] = True
            im[rng.choice(Q, min(2, Q - int(bm.sum())), replace=False)] = False
        want = np.asarray(j_auction(jnp.asarray(cost), jnp.asarray(bm), jnp.asarray(im)))
        got = t_lap.auction_lap(torch.from_numpy(cost), torch.from_numpy(bm),
                                torch.from_numpy(im)).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[~bm] == -1).all() and (got[bm] >= 0).all()
        assert not np.isin(got[bm], np.flatnonzero(~im)).any()
        sub = cost[np.ix_(np.flatnonzero(bm), np.flatnonzero(im))].astype(np.float64)
        r, c = linear_sum_assignment(sub)
        opt = sub[r, c].sum()
        assert _total(cost.astype(np.float64), got) <= opt + 1e-5 * np.abs(cost).max() * M


# ---- the tiny model ---------------------------------------------------------------

@pytest.fixture(scope='module')
def tf():
    """The tiny `transfusion.yaml` in both packages on two KITTI-range
    clouds of 2048 points with 6 boxes each (one masked), its weights
    started from the seeded port model's (`to_flax`;
    `test_weights_have_the_jax_layout` holds them to the JAX package's
    init)."""
    cfg = synthetic.tiny_transfusion_cfg(load_cfg('transfusion'))
    batch = synthetic.kitti_batch(2, 2048, 6, seed=0)
    batch['gt_mask'][1, -1] = False
    start = to_flax(synthetic.random_model(cfg, 'cpu', seed=0))
    return ModelPair(cfg, B=2, N=2048, seed=0, batch=batch, variables=start)


def test_weights_have_the_jax_layout(tf):
    """The port's tensors in the flax layout have the paths, shapes and
    dtypes of the JAX package's init (traced, not compiled: the class
    embedding, the LayerNorms, the two attentions' kernels, the heatmap
    conv's bias) and map back onto the port unchanged."""
    init = jax.eval_shape(lambda b: tf.jax_model.init(
        {'params': jax.random.PRNGKey(0)}, b, training=False), tf.inputs)
    back = to_flax(tf.net)
    for kind in ('params', 'batch_stats'):
        want = {'/'.join(str(getattr(p, 'key', p)) for p in path): (a.shape, a.dtype)
                for path, a in jax.tree_util.tree_leaves_with_path(init[kind])}
        got = dict(leaves(back[kind]))
        assert {k: (v.shape, v.dtype) for k, v in got.items()} == want, kind
        for k, v in leaves(tf.variables[kind]):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    head = back['params']['dense_head']
    assert head['class_embed']['embedding'].shape == (3, 16)
    assert head['cross_attn']['out']['kernel'].shape == (2, 8, 16)
    np.testing.assert_array_equal(tf.net.dense_head.heatmap_conv.bias.detach().numpy(),
                                  np.full(3, -2.19, np.float32))


def test_forward_matches_jax(tf):
    """The eval forward: the queries' cells exact (`two_stage_topk` of the
    heatmap), their heatmap scores, the heatmap and the five branches
    within MODEL_RTOL of scale."""
    J = tf.jax_out
    with torch.no_grad():
        T = to_numpy(tf.net(tf.torch_inputs()))
    for k in ('qx', 'qy'):
        np.testing.assert_array_equal(T['transfusion_query'][k], J['transfusion_query'][k])
    for k in ('hm_score', 'heatmap'):
        assert_close_to_scale(T['transfusion_query'][k], J['transfusion_query'][k], MODEL_RTOL, k)
    assert set(T['transfusion_preds']) == set(J['transfusion_preds'])
    for k, want in J['transfusion_preds'].items():
        assert_close_to_scale(T['transfusion_preds'][k], want, MODEL_RTOL, k)


def test_assignment_matches_jax(tf):
    """`assign_targets` on each package's training forward (the boxes as
    bidders of the host LAP over the focal, center-L1 and IoU3D cost): the
    same query for every valid box and -1 at the masked one. Were a
    near-tied cost to let the two float32 costs pick different optima, the
    total cost on the JAX package's matrix would be held instead; on this
    batch the assignments are equal."""
    out = tf.jax_train_forward()
    want = tf.jax_method(lambda m, b: m.dense_head.assign_targets(b), out)['q_of_gt']
    net = tf.net
    net.train()
    try:
        with torch.no_grad():
            got = net.dense_head.assign_targets(net(tf.torch_batch()))['q_of_gt'].numpy()
    finally:
        net.eval()
        net.load_state_dict(from_flax(tf.variables, net))
    assert want[1, -1] == -1 and (want[tf.batch['gt_mask']] >= 0).all()
    np.testing.assert_array_equal(got, want)


def test_training_loss_and_gradients_match_jax(tf):
    """The three losses (matched L1 with the heading wrapped, the focal
    classification of the scattered and clipped targets, the auxiliary
    heatmap loss) and their sum within LOSS_RTOL, every gradient within
    GRAD_REL_L2 relative L2 of the JAX package's, the attention keys' biases
    (0 in exact arithmetic) held by their norm."""
    _, tb, grads, _ = port_loss_and_grads(tf, tf.torch_batch())
    _, j_tb, j_grads, _ = tf.jax_loss_and_grads()
    assert set(tb) == {'tf_cls_loss', 'tf_reg_loss', 'tf_hm_loss', 'loss'} == set(j_tb)
    for k, want in j_tb.items():
        assert float(want) > 0, k
        np.testing.assert_allclose(float(tb[k]), float(want), rtol=LOSS_RTOL, err_msg=k)
    got, want = dict(leaves(grads)), dict(leaves(j_grads))
    assert set(got) == set(want)
    largest = max(np.linalg.norm(v) for v in want.values())
    null = [k for k in want if k.endswith('attn/key/bias')]
    assert len(null) == 2
    for k in want:
        if k in null:
            assert max(np.linalg.norm(got[k]), np.linalg.norm(want[k])) \
                <= NULL_GRAD_RTOL * largest, k
        else:
            assert rel_l2(got[k], want[k]) <= GRAD_REL_L2, (k, rel_l2(got[k], want[k]))


def test_predict_matches_jax(tf):
    """`predict` (no NMS: the queries' boxes with the best class's
    probability times the root of the heatmap score, masked at
    SCORE_THRESH): the same detections by box and label."""
    want = tf.jax_method(tf.jax_model.predict, {'points': tf.points})
    got = tf.net.predict(tf.torch_inputs())
    assert got['pred_boxes'].shape == (2, 16, 7)
    assert match_detections(got, want, BOX_ATOL) >= 8
