"""The port's plain ops against the JAX package's, on the CPU.

Inputs are numpy-seeded and float32 on both sides. Index outputs (FPS picks,
ball-query indices, top-K, NMS keep sets) must agree exactly; stated
tolerances cover float outputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_ssd_tpu.ops import centernet as j_centernet
from pdm_ssd_tpu.ops import coders as j_coders
from pdm_ssd_tpu.ops import iou3d as j_iou3d
from pdm_ssd_tpu.ops import pointnet2 as j_p2
from pdm_ssd_tpu.ops import sa_fused as j_sa
from pdm_ssd_tpu.ops import selection as j_sel
from pdm_ssd_torch.ops import centernet as t_centernet
from pdm_ssd_torch.ops import coders as t_coders
from pdm_ssd_torch.ops import iou3d as t_iou3d
from pdm_ssd_torch.ops import pointnet2 as t_p2
from pdm_ssd_torch.ops import sa_fused as t_sa
from pdm_ssd_torch.ops import selection as t_sel

from torch_port_harness import one_torch_thread  # noqa: F401 (an autouse fixture)

# JAX extracts center-relative coordinates and narrow (table-carried)
# features in bf16 (pdm_ssd_tpu/ops/sa_fused.py:212): |err| <= 2^-9 |x|
BF16_RTOL = 2.0 ** -8


def _cloud(rng, B, N):
    return np.stack([rng.uniform(0, 70.4, (B, N)), rng.uniform(-40, 40, (B, N)),
                     rng.uniform(-3, 1, (B, N))], -1).astype(np.float32)


def _tie_heavy_cloud(rng, B, N):
    """Grid-rounded points, duplicates and a zero-row tail."""
    x = np.round(rng.uniform(0, 6, (B, N, 3))).astype(np.float32) * 2.0
    x[:, N // 2: N // 2 + N // 8] = x[:, :N // 8]
    x[:, -N // 8:] = 0.0
    return x


@pytest.mark.parametrize('kind', ['random', 'tie_heavy'])
def test_fps_matches_jax_exactly(kind):
    rng = np.random.RandomState(3)
    xyz = _cloud(rng, 2, 700) if kind == 'random' else _tie_heavy_cloud(rng, 2, 700)
    want = np.asarray(j_p2.farthest_point_sample(jnp.asarray(xyz), 300))
    got = t_p2.farthest_point_sample(torch.from_numpy(xyz), 300).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _jax_window_group(xyz, feats, new_xyz, radii, nsamples, pc_range, cap):
    """The JAX package's payload table and window grouping, jitted: one
    program instead of one an op."""
    cs = float(max(radii))
    gw = j_sa.grid_dims(pc_range, cs)
    pc_min = (float(pc_range[0]) - cs, float(pc_range[1]) - cs)

    @jax.jit
    def group(xyz, feats, new_xyz):
        table = j_sa.build_payload_table(xyz, feats, cs, gw, cap, pc_min)
        return j_sa.window_group(table, new_xyz, radii, nsamples, cs, gw, cap, pc_min)

    return [tuple(None if a is None else np.asarray(a) for a in o)
            for o in group(xyz, feats, new_xyz)]


@pytest.mark.parametrize('cap', [32, 4])
def test_window_group_matches_jax(cap):
    """Indices and hits exact; relative xyz and narrow features to bf16
    tolerance. cap=4 overflows cells, so the cap drops are compared too."""
    rng = np.random.RandomState(5)
    pc_range = (0.0, -8.0, 12.0, 8.0)
    B, N, M = 2, 1500, 200
    xyz = np.stack([rng.uniform(-1, 13, (B, N)), rng.uniform(-9, 9, (B, N)),
                    rng.uniform(-1, 1, (B, N))], -1).astype(np.float32)
    feats = rng.randn(B, N, 2).astype(np.float32)
    new_xyz = xyz[:, :M].copy()
    new_xyz[:, :5, 0] = 40.0                      # out-of-range centers: empty balls
    radii, nsamples = [0.5, 1.0], [8, 16]
    want = _jax_window_group(xyz, feats, new_xyz, radii, nsamples, pc_range, cap)
    got = t_sa.fused_query_group(radii, nsamples, torch.from_numpy(xyz),
                                 torch.from_numpy(feats), torch.from_numpy(new_xyz),
                                 pc_range, cap=cap)
    for (j_rel, j_feat, j_idx, j_hit), (t_rel, t_feat, t_idx, t_hit) in zip(want, got):
        np.testing.assert_array_equal(t_hit.numpy(), j_hit)
        np.testing.assert_array_equal(t_idx.numpy(), j_idx)
        assert (~t_hit.numpy()).sum() >= 10 and t_hit.numpy().sum() > 300
        np.testing.assert_allclose(t_rel.numpy(), j_rel, rtol=BF16_RTOL, atol=1e-6)
        np.testing.assert_allclose(t_feat.numpy(), j_feat, rtol=BF16_RTOL, atol=1e-6)


def test_fused_query_group_wide_payload_matches_jax():
    """Wide payloads are row-gathered after selection on both sides: exact."""
    rng = np.random.RandomState(6)
    pc_range = (0.0, -8.0, 12.0, 8.0)
    xyz = np.stack([rng.uniform(0, 12, (2, 800)), rng.uniform(-8, 8, (2, 800)),
                    rng.uniform(-1, 1, (2, 800))], -1).astype(np.float32)
    feats = rng.randn(2, 800, 24).astype(np.float32)
    new_xyz = xyz[:, :100].copy()
    radii, nsamples, slices = [0.8, 1.6], [16, 32], [(0, 10), (10, 24)]
    want = jax.jit(lambda x, f, n: j_sa.fused_query_group(   # one program, not one an op
        radii, nsamples, x, f, n, pc_range, feat_slices=slices))(xyz, feats, new_xyz)
    got = t_sa.fused_query_group(radii, nsamples, torch.from_numpy(xyz),
                                 torch.from_numpy(feats), torch.from_numpy(new_xyz),
                                 pc_range, feat_slices=slices)
    for (j_rel, j_feat, j_hit), (t_rel, t_feat, _t_idx, t_hit) in zip(want, got):
        np.testing.assert_array_equal(t_hit.numpy(), np.asarray(j_hit))
        np.testing.assert_array_equal(t_feat.numpy(), np.asarray(j_feat))
        np.testing.assert_allclose(t_rel.numpy(), np.asarray(j_rel), rtol=BF16_RTOL, atol=1e-6)


@pytest.mark.parametrize('kind', ['tie_free', 'tie_heavy'])
def test_two_stage_topk_matches_jax(kind):
    rng = np.random.RandomState(7)
    if kind == 'tie_free':
        x = rng.permutation(3 * 4000).reshape(3, 4000).astype(np.float32) / 7.0
    else:
        x = np.round(rng.rand(3, 4000) * 6).astype(np.float32)
    jv, ji = j_sel.two_stage_topk(jnp.asarray(x), 50)
    tv, ti = t_sel.two_stage_topk(torch.from_numpy(x), 50)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def _boxes(rng, B, N):
    b = np.zeros((B, N, 7), np.float32)
    b[..., 0] = rng.uniform(0, 20, (B, N))
    b[..., 1] = rng.uniform(-10, 10, (B, N))
    b[..., 2] = rng.uniform(-2, 0, (B, N))
    b[..., 3:6] = rng.uniform(0.5, 4.5, (B, N, 3))
    b[..., 6] = rng.uniform(-np.pi, np.pi, (B, N))
    return b


def test_boxes_iou_bev_matches_jax():
    rng = np.random.RandomState(8)
    a, b = _boxes(rng, 1, 60)[0], _boxes(rng, 1, 50)[0]
    want = np.asarray(j_iou3d.boxes_iou_bev(jnp.asarray(a), jnp.asarray(b)))
    got = t_iou3d.boxes_iou_bev(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert (want > 0.05).sum() > 20
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize('kind', ['tie_free', 'tie_heavy'])
def test_nms_bev_matches_jax(kind):
    """Same keep set in the same order, on the batch at once."""
    rng = np.random.RandomState(9)
    B, N = 3, 300
    boxes = _boxes(rng, B, N)
    if kind == 'tie_free':
        scores = rng.permutation(B * N).reshape(B, N).astype(np.float32) / (B * N)
    else:
        scores = np.round(rng.rand(B, N) * 4).astype(np.float32) / 4
    valid = rng.rand(B, N) > 0.2
    t_idx, t_keep = t_iou3d.nms_bev(torch.from_numpy(boxes), torch.from_numpy(scores), 0.1,
                                    pre_maxsize=128, post_maxsize=100,
                                    valid=torch.from_numpy(valid))
    for b in range(B):
        j_idx, j_keep = j_iou3d.nms_bev(jnp.asarray(boxes[b]), jnp.asarray(scores[b]), 0.1,
                                        128, 100, valid=jnp.asarray(valid[b]))
        np.testing.assert_array_equal(t_keep[b].numpy(), np.asarray(j_keep))
        np.testing.assert_array_equal(t_idx[b].numpy(), np.asarray(j_idx))
        assert 5 < int(t_keep[b].sum()) < 100


def test_heatmap_decode_matches_jax():
    rng = np.random.RandomState(10)
    B, C, H, W, K = 2, 3, 40, 36, 30
    hm = rng.rand(B, C, H, W).astype(np.float32)
    hm[:, :, :20] = 0.5                                 # a block of exact ties
    maps = {n: rng.randn(B, c, H, W).astype(np.float32)
            for n, c in [('rot_cos', 1), ('rot_sin', 1), ('center', 2), ('center_z', 1),
                         ('dim', 3)]}
    kw = dict(point_cloud_range=(0.0, -40.0, -3.0, 70.4, 40.0, 1.0), voxel_size=(0.4, 0.4),
              feature_map_stride=1, K=K, score_thresh=0.1,
              post_center_limit_range=[0, -40, -3, 12, 40, 1])
    want = j_centernet.decode_bbox_from_heatmap(
        jnp.asarray(hm), **{k: jnp.asarray(v) for k, v in maps.items()}, **kw)
    got = t_centernet.decode_bbox_from_heatmap(
        torch.from_numpy(hm), **{k: torch.from_numpy(v) for k, v in maps.items()}, **kw)
    for k in ('pred_scores', 'pred_labels', 'pred_mask'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose(got['pred_boxes'].numpy(), np.asarray(want['pred_boxes']),
                               rtol=1e-6, atol=1e-5)
    assert 0 < int(got['pred_mask'].sum()) < B * K


def test_point_residual_decode_matches_jax():
    rng = np.random.RandomState(11)
    mean_size = ((3.9, 1.6, 1.56), (0.8, 0.6, 1.73), (1.76, 0.6, 1.73))
    enc = rng.randn(2, 40, 8).astype(np.float32)
    pts = rng.randn(2, 40, 3).astype(np.float32) * 10
    cls = rng.randint(1, 4, (2, 40)).astype(np.int32)
    want = j_coders.PointResidualCoder(mean_size=mean_size).decode(
        jnp.asarray(enc), jnp.asarray(pts), jnp.asarray(cls))
    got = t_coders.PointResidualCoder(mean_size=mean_size).decode(
        torch.from_numpy(enc), torch.from_numpy(pts), torch.from_numpy(cls))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
