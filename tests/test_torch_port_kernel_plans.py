"""Launch plans of the port's kernels, and the kernel loader, on the CPU:
`ops/fps.fps_plan`, `ops/group.gather_plan` and `scatter_plan` are plain
Python, so the choices the card's launches
follow are tested here with the card's counts mocked;
`ops/sparse_conv.sparse_conv_plan`, the ball query's grid
(`ops/ball_query.build_grid`, `ball_query_plan`, and the plain emulation of
the grid walk) and the plain emulations of the compacted window walk and of
the run-merged scatter-add are torch ops that run here as on the card. The
kernels themselves run in the `gpu`-marked tests here and in
`test_torch_port_guards.py`, which skip without a card."""
import math
from itertools import product

import numpy as np
import pytest
import torch

from pdm_ssd_torch.ops import ball_query as bq
from pdm_ssd_torch.ops import dispatch, fps, group, kernels, sa_fused
from pdm_ssd_torch.ops import pointnet2 as plain
from pdm_ssd_torch.ops import sparse_conv as sc

from torch_port_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

SM = 132


def resident(counts):
    """A mocked `fps_max_active_clusters`: clusters of S blocks the card holds
    at once, by S, whatever the layout."""
    return lambda S, threads, ppt: counts.get(S, 0)


# the H100 80GB HBM3's counts at the flagship's layout (chip_smoke.py phase 3)
H100 = resident({16: 7, 8: 15, 4: 30, 2: 60})


def test_fps_plan_takes_a_cluster_per_cloud_at_the_flagship_shape():
    assert fps.fps_plan(8, 16384, 4096, SM, resident({16: 8, 8: 16})) == ('cluster', 16, 256, 4)
    # 7 clusters of 16 resident: the eighth cloud would wait a whole run
    assert fps.fps_plan(8, 16384, 4096, SM, H100) == ('cluster', 8, 256, 8)


def test_fps_plan_falls_to_smaller_clusters_then_to_a_block():
    assert fps.fps_plan(20, 16384, 4096, SM, H100) == ('cluster', 4, 256, 16)
    assert fps.fps_plan(40, 16384, 4096, SM, H100) == ('block', 1, 1024, 16)
    # B x S beyond the SMs even where the occupancy count would allow it
    assert fps.fps_plan(40, 16384, 4096, SM, resident({4: 99, 2: 99})) == ('block', 1, 1024, 16)


@pytest.mark.parametrize('B,N,npoint,want', [
    (400, 512, 128, ('block', 1, 512, 1)),          # PointRCNN's ROI stack, level 1
    (400, 128, 32, ('block', 1, 128, 1)),           # and level 2
    (4, 2047, 1024, ('block', 1, 1024, 2)),         # below CLUSTER_MIN_POINTS
    (2, 300, 500, ('block', 1, 320, 1)),            # npoint > N: the plan ignores npoint
    (3, 10007, 2000, ('cluster', 16, 256, 4)),      # odd N
    (1, 1, 1, ('block', 1, 32, 1)),
])
def test_fps_plan_by_shape(B, N, npoint, want):
    assert fps.fps_plan(B, N, npoint, SM, H100) == want


def test_fps_plan_forced_paths_and_limits():
    assert fps.fps_plan(8, 16384, 4096, SM, H100, path='block') == ('block', 1, 1024, 16)
    assert fps.fps_plan(8, 512, 128, SM, H100, path='cluster') == ('cluster', 8, 64, 1)
    with pytest.raises(ValueError, match='no cluster'):
        fps.fps_plan(400, 512, 128, SM, H100, path='cluster')
    with pytest.raises(ValueError, match='one FPS block takes at most'):
        fps.fps_plan(2, fps.BLOCK_MAX_POINTS + 1, 10, SM, H100, path='block')
    with pytest.raises(ValueError, match='N <='):
        fps.fps_plan(1, fps.MAX_POINTS + 1, 10, SM, H100)
    with pytest.raises(ValueError, match='unknown FPS path'):
        fps.fps_plan(1, 100, 10, SM, H100, path='warp')
    with pytest.raises(ValueError):
        fps.fps_plan(1, 100, 0, SM, H100)


def test_fps_plan_runs_large_clouds_in_waves_where_no_cluster_fits():
    """A cloud above one block's points, with too many clouds for all their
    clusters at once: the fewest blocks per cloud that hold it."""
    assert fps.fps_plan(200, 20000, 4096, SM, H100) == ('cluster', 8, 256, 16)
    assert fps.fps_plan(200, fps.MAX_POINTS, 4096, SM, H100) == ('cluster', 16, 256, 16)


@pytest.mark.parametrize('N', [1, 31, 32, 33, 255, 1000, 1024, 1025, 2047, 2048, 4096, 8191,
                               10007, 16384, 16385, 40000, fps.MAX_POINTS])
def test_fps_layouts_are_ones_the_library_holds(N):
    """Every layout the plan can give covers the cloud and is one that
    `csrc/fps.cu` instantiates and accepts."""
    for S in fps.CLUSTER_SIZES:
        layout = fps.cluster_layout(N, S)
        if layout is None:
            continue
        threads, ppt = layout
        assert ppt in fps.CLUSTER_PPT and 32 <= threads <= fps.CLUSTER_MAX_THREADS
        assert threads & (threads - 1) == 0 and S * threads * ppt >= N
        assert ppt == 1 or threads == fps.CLUSTER_MAX_THREADS
    layout = fps.block_layout(N)
    assert (layout is None) == (N > fps.BLOCK_MAX_POINTS)
    if layout is not None:
        threads, ppt = layout
        assert ppt in fps.BLOCK_PPT and threads % 32 == 0 and threads * ppt >= N
        assert ppt == 1 or threads == fps.BLOCK_MAX_THREADS   # the kernel's compile-time size
    plan = fps.fps_plan(8, N, 64, SM, H100)
    assert plan.S * plan.threads * plan.ppt >= N


# ---- row gather --------------------------------------------------------------

@pytest.mark.parametrize('C,elem,ld,start,want', [
    (1, 4, 1, 0, (0, 1, 16, 4)),           # SA level 1: four rows a thread, one 16-byte store
    (1, 4, 4, 12, (0, 1, 16, 4)),          # intensity, the 4th channel of the cloud
    (3, 4, 4, 0, (0, 1, 16, 4)),           # xyz of the (B, N, 4) cloud: 48 bytes, three stores
    (3, 4, 5, 0, (0, 1, 16, 4)),           # xyz of the pooled 5-channel block
    (2, 4, 5, 12, (0, 1, 16, 2)),
    (4, 4, 4, 0, (1, 1, 16, 1)),           # one 16-byte unit: the row path, a lane a row
    (4, 4, 8, 4, (0, 1, 16, 1)),           # 16 bytes off a boundary: the narrow path
    (19, 4, 37, 12, (32, 32, 4, 1)),       # the ragged slice off a 16-byte boundary
    (37, 4, 37, 0, (32, 32, 4, 1)),
    (64, 4, 128, 0, (16, 16, 16, 1)),      # SA level 2's branches, 16-byte units
    (64, 4, 128, 256, (16, 16, 16, 1)),    # the second branch, at channel 64
    (96, 4, 96, 0, (32, 32, 16, 1)),
    (256, 4, 256, 0, (32, 32, 16, 1)),
    (1, 2, 1, 0, (0, 1, 16, 8)),           # bf16
    (3, 2, 8, 0, (0, 1, 16, 8)),
    (8, 2, 16, 0, (1, 1, 16, 1)),
    (96, 2, 96, 0, (16, 16, 16, 1)),       # the bf16 (52000, 96) table
    (37, 2, 37, 2, (32, 32, 2, 1)),
])
def test_gather_plan_unit_and_group(C, elem, ld, start, want):
    """(lanes, longest tile's passes, unit bytes, rows a thread) by row width,
    row stride and slice start, with rows enough that no tile is shortened."""
    plan = group.gather_plan(8, 16384, 1 << 20, C, elem, ld, start, SM)
    lanes, passes, unit, rows = want
    assert (plan.lanes, plan.passes, plan.unit, plan.rows_per_thread) == want
    if lanes:       # what csrc/group.cu checks before it launches the row path
        assert unit % elem == 0 and (C * elem) % unit == 0 and (ld * elem) % unit == 0
        assert start % unit == 0 and lanes & (lanes - 1) == 0 and 1 <= passes <= lanes
        assert lanes >= min(32, (C * elem) // unit) > lanes // 2
    else:
        assert C * elem <= 16 and (rows * C * elem) % 16 == 0


def test_gather_plan_index_width():
    small = group.gather_plan(8, 16384, 65536, 64, 4, 128, 0, SM)
    assert not small.wide_index
    # 2^31 bytes of features: the offsets need 64 bits
    big = group.gather_plan(2, 1 << 22, 1024, 64, 4, 64 * 2, 0, SM)
    assert big.wide_index
    out_big = group.gather_plan(1, 10, 1 << 23, 64, 4, 64, 0, SM)
    assert out_big.wide_index


def test_gather_plan_shortens_tiles_for_few_rows():
    assert group.gather_plan(3, 3001, 1665, 19, 4, 37, 12, SM).passes == 1
    assert group.gather_plan(1, 52000, 52000, 96, 2, 96, 0, SM).passes == 4
    assert group.gather_plan(8, 1024, 8192, 128, 4, 256, 0, SM).passes == 8


def _row_path_visits(B, R, plan):
    """Rows the row path's grid visits, as csrc/group.cu walks them."""
    warps_per_block = group.ROW_THREADS // 32
    tile_rows = 32 // plan.lanes * plan.passes
    gy = min(B, 65535)
    seen = []
    for by in range(gy):
        for bx in range(plan.blocks):
            for w in range(warps_per_block):
                for b in range(by, B, gy):
                    tile = (bx * warps_per_block + w) * tile_rows
                    while tile < R:
                        seen += [(b, r) for r in range(tile, min(tile + tile_rows, R))]
                        tile += plan.blocks * warps_per_block * tile_rows
    return seen


def _narrow_path_visits(B, R, plan):
    total, k = B * R, plan.rows_per_thread
    threads = plan.blocks * group.ROW_THREADS
    seen = []
    for t in range(threads):
        for c in range(t, total // k, threads):
            seen += range(c * k, c * k + k)
        seen += range(total // k * k + t, total, threads)
    return [divmod(f, R) for f in seen]


@pytest.mark.parametrize('B,R,C,ld', [(3, 1665, 19, 37), (2, 70, 96, 96), (5, 33, 64, 128),
                                      (4, 1000, 1, 1), (3, 999, 3, 4), (2, 7, 2, 5)])
def test_gather_grid_visits_every_row_once(B, R, C, ld):
    plan = group.gather_plan(B, 50, R, C, 4, ld, 0, 4)
    visit = _narrow_path_visits if plan.lanes == 0 else _row_path_visits
    seen = visit(B, R, plan)
    assert sorted(seen) == [(b, r) for b in range(B) for r in range(R)]


def test_gather_plan_blocks_fill_the_card_once():
    plan = group.gather_plan(8, 16384, 65536, 1, 4, 1, 0, SM)
    assert plan.blocks == math.ceil(8 * 65536 / 4 / group.ROW_THREADS)
    plan = group.gather_plan(8, 4096, 1 << 20, 64, 4, 64, 0, SM)
    assert plan.blocks * 8 == SM * group.BLOCKS_PER_SM        # grid-stride beyond that


# ---- row scatter-add ----------------------------------------------------------

@pytest.mark.parametrize('C,start,want', [
    (1, 0, (4, 1, 8, 256)),            # a float a row: 32 groups of one lane, 8 rows each
    (19, 0, (4, 32, 32, 32)),          # the ragged case's slice: 76 bytes, 4-byte units
    (37, 0, (4, 32, 32, 32)),          # 37 units: two a lane for the first 5 lanes
    (64, 0, (16, 16, 32, 64)),         # SA level 2: 16 float4 a row, two groups a warp
    (128, 0, (16, 32, 32, 32)),        # SA level 3: 32 float4 a row
    (64, 8, (8, 32, 32, 32)),          # rows 8 bytes off a 16-byte boundary
    (6, 0, (8, 4, 32, 256)),
])
def test_scatter_plan_by_shape(C, start, want):
    """(unit bytes, lanes per row, rows a group walks, tile rows) by row width
    and alignment, with rows enough that no walk is shortened."""
    plan = group.scatter_plan(8, 32768, C, 4096, SM, start)
    assert (plan.unit, plan.lanes, plan.span, plan.tile_rows) == want
    # what csrc/group.cu checks before it launches
    assert (4 * C) % plan.unit == 0 and start % plan.unit == 0
    assert plan.lanes & (plan.lanes - 1) == 0 and plan.tile_rows <= group.SCATTER_MAX_TILE
    assert plan.tile_rows == plan.span * 32 // plan.lanes
    assert plan.lanes >= min(32, 4 * C // plan.unit) > plan.lanes // 2
    assert not plan.wide_index


def test_scatter_plan_shortens_walks_for_few_rows_and_widens_offsets():
    assert group.scatter_plan(1, 100, 64, 50, SM).span == 4
    assert group.scatter_plan(1, 8192, 128, 4096, SM).span == 8        # 1024 walks
    assert group.scatter_plan(2, 16384, 128, 4096, SM).span == 32
    assert group.scatter_plan(2, 1 << 21, 128, 8, SM).wide_index
    assert not group.scatter_plan(1, 1 << 20, 128, 8, SM).wide_index
    assert group.scatter_plan(2, 1 << 21, 1, 1 << 22, SM).blocks * 2 == SM * group.BLOCKS_PER_SM


@pytest.mark.parametrize('B,R,C', [(3, 23310, 37), (2, 777, 64), (5, 33, 1), (8, 4096, 128)])
def test_scatter_grid_visits_every_row_once(B, R, C):
    """Rows the kernel's grid gives to lane groups, as csrc/group.cu walks
    them: every row of every cloud once, each group's rows consecutive."""
    plan = group.scatter_plan(B, R, C, 100, 4)
    warps_per_block = group.SCATTER_THREADS // 32
    gy = min(B, 65535)
    seen = []
    for by, bx, w in product(range(gy), range(plan.blocks), range(warps_per_block)):
        for b in range(by, B, gy):
            tile = (bx * warps_per_block + w) * plan.tile_rows
            while tile < R:
                for g in range(32 // plan.lanes):
                    r0 = tile + g * plan.span
                    seen += [(b, r) for r in range(r0, min(r0 + plan.span, R))]
                tile += plan.blocks * warps_per_block * plan.tile_rows
    assert sorted(seen) == [(b, r) for b in range(B) for r in range(R)]


def _selection_rows(rng, B, M, K, N):
    """Indices laid out as the selection's: a center's K slots hold its hits,
    then repeat the first hit; an empty ball reads -1."""
    hits = rng.randint(0, 5, (B, M))
    idx = rng.randint(0, N, (B, M, K))
    first = np.repeat(idx[..., :1], K, -1)
    idx = np.where(np.arange(K) < hits[..., None], idx, first)
    idx[hits == 0] = -1
    return idx.reshape(B, M * K).astype(np.int32)


def _scatter_case(kind: str):
    """(vals, idx, n_rows, span) of one kind of edge case, as torch tensors."""
    rng = np.random.RandomState(40)
    B, R, C, N, span = 3, 1000, 5, 60, 32
    if kind == 'selection':
        idx = _selection_rows(rng, B, 40, 25, N)
        R = idx.shape[1]
    elif kind == 'out_of_range':
        idx = rng.randint(-3, N + 3, (B, R))
        idx[:, 100:180] = -1
        idx[:, 200:290] = N
        idx[:, 300:310] = N + 7
    elif kind == 'runs_cross_tiles':
        # runs of 50 and 70 equal indices, cut by every group's end
        idx = np.repeat(rng.randint(0, N, (B, 20)), 50, -1)
        idx[:, 500:570] = 7
    elif kind == 'all_equal':
        idx = np.full((B, R), 11)
    elif kind == 'all_distinct':
        N = R + 10
        idx = np.stack([rng.permutation(R) for _ in range(B)])
    elif kind == 'short_spans':
        idx, span = np.repeat(rng.randint(-1, N, (B, R // 3 + 1)), 3, -1)[:, :R], 4
    else:
        raise ValueError(kind)
    vals = rng.randn(B, idx.shape[1], C) * np.exp(rng.randn(B, idx.shape[1], 1))
    vals, idx = torch.from_numpy(vals.astype(np.float32)), torch.from_numpy(idx.astype(np.int32))
    return vals, idx, N, span


SCATTER_CASES = ['selection', 'out_of_range', 'runs_cross_tiles', 'all_equal', 'all_distinct',
                 'short_spans']


def _scatter_bound(vals, idx, n_rows):
    """The float64 sum and the rounding bound phase 6 of chip_smoke.py holds
    the kernel to: 2^-23 * count * sum |v| per output value."""
    exact = group.scatter_add_rows_plain(vals.double(), idx, n_rows)
    mass = group.scatter_add_rows_plain(vals.double().abs(), idx, n_rows)
    count = group.scatter_add_rows_plain(torch.ones(idx.shape + (1,), dtype=torch.float64),
                                         idx, n_rows)
    return exact, 2.0 ** -23 * count * mass + 1e-30


@pytest.mark.parametrize('kind', SCATTER_CASES)
def test_run_merged_scatter_emulation_is_within_the_float64_bound(kind):
    """Runs summed in row order in float32 within each group's rows, then
    added to the output: within the float64 bound; with one sum sent per
    output row, equal to that sum bit for bit whatever the order of the
    atomics; indices outside [0, n_rows) dropped."""
    vals, idx, n_rows, span = _scatter_case(kind)
    got = group.scatter_add_runs_plain(vals, idx, n_rows, span)
    exact, tol = _scatter_bound(vals, idx, n_rows)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(exact.shape)
    assert bool(((got.double() - exact).abs() <= tol).all()), kind
    rows, runs, sent = group.scatter_runs(idx, n_rows, span)
    ok = (idx >= 0) & (idx < n_rows)
    assert rows == int(ok.sum()) and runs <= sent <= rows
    if kind == 'all_equal':
        B, R = idx.shape
        assert runs == B and sent == B * -(-R // span)
    if kind == 'all_distinct':
        assert runs == sent == rows
        assert torch.equal(got, group.scatter_add_rows_plain(vals, idx, n_rows))


def test_scatter_runs_counts_the_selection_layout():
    """K = 16 slots that all repeat one hit: one run and one sum a center;
    a run of 48 equal rows over groups of 32: two sums."""
    idx = torch.arange(8, dtype=torch.int32).repeat_interleave(16)[None]
    assert group.scatter_runs(idx, 8, 32) == (128, 8, 8)
    idx = torch.tensor([[5] * 48 + [2] * 16 + [-1] * 8 + [9] * 8], dtype=torch.int32)
    assert group.scatter_runs(idx, 8, 32) == (64, 2, 3)


# ---- in-ball selection -------------------------------------------------------

def _window_case(kind: str):
    """(table, center_cells, grid_w, xyz, new_xyz, radii, nsamples, cap) as
    CPU tensors: a small input of one kind."""
    rng = np.random.RandomState(41)
    B, N, M, cap = 2, 3001, 300, 32
    radii, nsamples = (0.8, 1.6), (16, 32)
    pc_range = (0.0, -10.0, 20.0, 10.0)
    xyz = np.stack([rng.uniform(-1, 21, (B, N)), rng.uniform(-11, 11, (B, N)),
                    rng.uniform(-2, 1, (B, N))], -1).astype(np.float32)
    if kind == 'cap_20':
        cap, radii, nsamples = 20, (0.5, 1.3, 0.9), (5, 70, 3)
    elif kind == 'full_cells':
        # a dense patch inside one cell: that cell full to the cap, both balls
        # full within the first step
        xyz[:, :1500] = xyz[:, :1500] * 0.01 + np.float32([6.1, 0.1, 0.0])
        radii, nsamples = (0.4, 0.8), (4, 8)
    elif kind == 'k_above_32':
        xyz[:, :2000, :2] = xyz[:, :2000, :2] * 0.1 + 5.0
        cap, radii, nsamples = 64, (0.5, 1.0), (40, 64)
    elif kind == 'cap_40':     # parts of 32 and 8 slots a cell, two passes
        xyz[:, :2000, :2] = xyz[:, :2000, :2] * 0.1 + 5.0
        cap, radii, nsamples = 40, (0.5, 1.0), (16, 48)
    elif kind == 'cap_100':    # four parts a cell, four passes
        xyz[:, :2000, :2] = xyz[:, :2000, :2] * 0.1 + 5.0
        cap, nsamples = 100, (16, 48)
    elif kind == 'large_k':
        # four radii whose stages pass a block's default 48 KB of shared memory
        xyz[:, :2000, :2] = xyz[:, :2000, :2] * 0.1 + 5.0
        radii, nsamples = (0.5, 1.0, 0.7, 1.6), (200, 200, 200, 204)
    elif kind == 'small_cap':
        cap, nsamples = 4, (8, 16)
    elif kind != 'cap_32':
        raise ValueError(kind)
    new_xyz = xyz[:, :M].copy()
    new_xyz[:, :6, 0] = 90.0                   # out of range: the dump cell
    new_xyz[:, 6:12, 2] = 40.0                 # in range, empty balls
    xyz, new_xyz = torch.from_numpy(xyz), torch.from_numpy(new_xyz)
    cs = float(max(radii))
    gw = sa_fused.grid_dims(pc_range, cs)
    pc_min = (pc_range[0] - cs, pc_range[1] - cs)
    table = sa_fused.build_slot_table(xyz, cs, gw, cap, pc_min)
    cells = sa_fused.cell_ids(new_xyz, cs, gw, pc_min)
    return table, cells, gw[0], xyz, new_xyz, radii, nsamples, cap


WINDOW_CASES = ['cap_32', 'cap_20', 'full_cells', 'k_above_32', 'cap_40', 'cap_100', 'large_k',
                'small_cap']


def _passes(cap: int) -> list:
    """[start, end) in window slots of each pass of the kernel's parts, a
    part being 32 slots of one cell (fewer at a cell's end)."""
    starts = [w * cap + c for w in range(9) for c in range(0, cap, 32)]
    edges = starts[::group.SELECT_PASS_PARTS] + [9 * cap]
    return list(zip(edges[:-1], edges[1:]))


@pytest.mark.parametrize('kind', WINDOW_CASES)
def test_compacted_window_walk_equals_plain_selection(kind):
    """The walk over each pass's occupied slots, compacted in candidate
    order and stopped once every radius is full, selects exactly what
    `window_select_plain` selects; out-of-range centers walk nothing, and
    no center walks more steps than its occupied slots need."""
    table, cells, gw, xyz, new_xyz, radii, nsamples, cap = _window_case(kind)
    args = (table, cells, gw, xyz, new_xyz, radii, nsamples)
    got, occupied, steps = group.window_select_walk_plain(*args)
    want = group.window_select_plain(*args)
    for (g_rel, g_idx, g_hit), (w_rel, w_idx, w_hit) in zip(got, want):
        assert torch.equal(g_hit, w_hit) and torch.equal(g_idx, w_idx)
        assert torch.equal(g_rel, w_rel)
        assert not w_hit[:, :12].any() and w_hit.any()
    assert not occupied[:, :6].any() and not steps[:, :6].any()
    passes = _passes(cap)
    assert len(passes) == -(-cap // 32)
    most = sum(-(-(hi - lo) // 32) for lo, hi in passes)
    assert bool((steps <= most).all()) and bool((steps * 32 >= occupied.clamp(max=32)).all())
    # empty balls walk every occupied slot of every pass: nothing fills them
    cand = group.window_candidates(table, cells, gw)[:, 6:12]
    assert torch.equal(steps[:, 6:12], sum(-(-(cand[..., lo:hi] >= 0).sum(-1) // 32)
                                           for lo, hi in passes))
    if kind == 'full_cells':  # more than a step of slots, both balls full in the first
        assert bool((occupied[:, 12:] > 32).all()) and bool((steps[:, 12:] == 1).all())


def test_window_walk_stops_when_the_last_radius_fills():
    """At cap 64 the window takes two passes of 288 slots. The first
    compacts 17 + 32 occupied slots into two steps, and its first step fills
    the small ball; the second pass starts at point 32, and its first step
    fills the large ball with points 40 to 42: three steps, where the
    window's 145 occupied slots would take five."""
    table = torch.full((1, 10, 64), -1, dtype=torch.int32)
    xyz = torch.zeros((1, 200, 3))
    xyz[0, :, 0] = 5.0                                          # far: no hit
    table[0, 4, :64] = torch.arange(64, dtype=torch.int32)      # the center's cell
    table[0, 5, :64] = torch.arange(64, 128, dtype=torch.int32)
    table[0, 1, 3:20] = torch.arange(128, 145, dtype=torch.int32)   # a cell not full from 0
    xyz[0, :2, 0] = 0.1                                         # both balls, first step
    xyz[0, 40:43, 0] = 0.3                                      # the larger ball, second step
    center = torch.zeros((1, 1, 3))
    cells = torch.tensor([[4]])
    args = (table, cells, 3, xyz, center, (0.2, 0.5), (2, 4))
    got, occupied, steps = group.window_select_walk_plain(*args)
    assert occupied.tolist() == [[145]] and steps.tolist() == [[3]]
    want = group.window_select_plain(*args)
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))
    assert want[1][1].tolist() == [[[0, 1, 40, 41]]]


# ---- loader ------------------------------------------------------------------

def test_kernel_loader_returns_the_loaded_library_without_the_lock(monkeypatch):
    class NoLock:
        def __enter__(self):
            raise AssertionError('the lock was taken')

        def __exit__(self, *exc):
            return False

    lib = object()
    monkeypatch.setattr(kernels, '_lib', lib)
    monkeypatch.setattr(kernels, '_lock', NoLock())
    assert kernels.load() is lib


def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, '_lib', None)
    monkeypatch.setattr(kernels, '_BUILD_DIR', tmp_path / 'build')
    monkeypatch.setenv('CUDA_HOME', str(tmp_path / 'no_cuda'))
    monkeypatch.delenv('CUDA_PATH', raising=False)
    monkeypatch.setenv('PATH', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        kernels.load()
    assert kernels._lib is None
    with pytest.raises(RuntimeError, match='nvcc not found'):   # and again: nothing was cached
        kernels.load()


# ---- sparse conv plan ---------------------------------------------------------

@pytest.fixture(scope='module')
def tiny_second():
    """The tiny SECOND (`synthetic.tiny_second_cfg`) on the CPU with seeded
    weights, and a prepared batch of two LiDAR-like clouds: its ladder maps."""
    import os

    from pdm_ssd_torch.models import build_network, get_host_prepare
    from pdm_ssd_torch.utils import synthetic
    from pdm_ssd_torch.utils.config import CfgNode, cfg_from_yaml_file
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cwd = os.getcwd()
    os.chdir(repo)   # the config names its base config relative to the repo
    try:
        cfg = synthetic.tiny_second_cfg(
            cfg_from_yaml_file('configs/kitti_models/second_sparse.yaml', CfgNode()))
    finally:
        os.chdir(cwd)
    torch.manual_seed(0)
    net = build_network(cfg.MODEL, 3, cfg.DATA_CONFIG, device='cpu').eval()
    batch = get_host_prepare(cfg.MODEL, cfg.DATA_CONFIG)(synthetic.voxel_batch(2, 600, cfg, seed=3))
    return net, batch


# map -> the stage whose slot table it reads (its Vin)
LADDER_MAPS = {'sp_submap1': 'sp_mask1', 'sp_downmap2': 'sp_mask1', 'sp_submap2': 'sp_mask2',
               'sp_downmap3': 'sp_mask2', 'sp_submap3': 'sp_mask3', 'sp_downmap4': 'sp_mask3',
               'sp_submap4': 'sp_mask4', 'sp_outmap': 'sp_mask4'}


def _row_masks(nbr: np.ndarray, Vin: int) -> np.ndarray:
    present = (nbr >= 0) & (nbr < Vin)
    return (present * (1 << np.arange(nbr.shape[2]))).sum(-1)


@pytest.mark.parametrize('key', list(LADDER_MAPS))
def test_sparse_conv_plan_sorts_rows_and_ors_tile_masks(tiny_second, key):
    """Each cloud's order is a permutation of its rows in ascending tap-mask
    order (equal masks keep slot order), and each tile's mask is the OR of
    its rows' masks."""
    _, batch = tiny_second
    nbr = batch[key]
    Vin = batch[LADDER_MAPS[key]].shape[1]
    plan = sc.sparse_conv_plan(nbr, Vin)
    B, V, K = nbr.shape
    tiles = -(-V // sc.TILE_ROWS)
    assert plan.order.dtype == plan.tile_mask.dtype == torch.int32 and plan.vin == Vin
    assert tuple(plan.order.shape) == (B, V) and tuple(plan.tile_mask.shape) == (B, tiles)
    masks = _row_masks(nbr.numpy(), Vin)
    assert torch.equal(sc.tap_masks(nbr, Vin), torch.from_numpy(masks).to(torch.int32))
    order = plan.order.numpy()
    for b in range(B):
        assert sorted(order[b].tolist()) == list(range(V))
        ranked = masks[b][order[b]]
        assert (np.diff(ranked) >= 0).all()
        same = np.diff(ranked) == 0
        assert (np.diff(order[b])[same] > 0).all()               # a stable sort
        for t in range(tiles):
            want = np.bitwise_or.reduce(ranked[t * sc.TILE_ROWS:(t + 1) * sc.TILE_ROWS])
            assert int(plan.tile_mask[b, t]) == int(want)
    assert masks.any()


@pytest.mark.parametrize('key', list(LADDER_MAPS))
def test_sparse_conv_plan_work_is_what_its_tiles_compute(tiny_second, key):
    """`plan_work`: a tile computes TILE_ROWS rows of every tap in its mask,
    never fewer taps than are present."""
    _, batch = tiny_second
    nbr = batch[key]
    Vin = batch[LADDER_MAPS[key]].shape[1]
    plan = sc.sparse_conv_plan(nbr, Vin)
    computed, present = sc.plan_work(plan, nbr)
    masks = _row_masks(nbr.numpy(), Vin)
    popc = np.vectorize(lambda x: bin(int(x)).count('1'))
    assert int(present) == int(popc(masks).sum())
    assert int(computed) == int(popc(plan.tile_mask.numpy()).sum()) * sc.TILE_ROWS
    assert 0 < int(present) <= int(computed)


def test_sparse_conv_plan_of_a_hand_made_map():
    """Rows with no tap sort first and their tiles have mask 0; a ragged last
    tile ORs only the rows it has; entries on both sides of [0, Vin) are
    absent."""
    Vin, K = 10, 3
    nbr = torch.full((1, 70, K), Vin, dtype=torch.int32)
    nbr[0, 5, 2] = 4          # mask 0b100
    nbr[0, 69, 0] = 9         # mask 0b001
    nbr[0, 69, 1] = -1        # absent
    nbr[0, 30, 1] = 0         # mask 0b010
    plan = sc.sparse_conv_plan(nbr, Vin)
    assert plan.order[0, -3:].tolist() == [69, 30, 5]
    assert plan.order[0, :67].tolist() == [v for v in range(70) if v not in (5, 30, 69)]
    assert plan.tile_mask.tolist() == [[0, 0b111]]
    computed, present = sc.plan_work(plan, nbr)
    assert (int(computed), int(present)) == (3 * sc.TILE_ROWS, 3)


def test_layers_that_share_a_map_share_one_plan(tiny_second, monkeypatch):
    """A forward of the ladder builds one plan per map (8 maps, 12 layers)
    and hands each layer its map's plan; on the CPU the plain version runs
    and ignores it."""
    net, batch = tiny_second
    calls = []
    real = dispatch.sparse_conv

    def recording(feats, nbr, weight, plan=None, *bwd):
        calls.append((nbr, plan))
        return real(feats, nbr, weight, plan, *bwd)

    monkeypatch.setattr(dispatch, 'sparse_conv', recording)
    with torch.inference_mode():
        net.backbone_3d(net.vfe(dict(batch)))
    assert len(calls) == 12
    maps = {id(batch[k]): k for k in LADDER_MAPS}
    by_map = {}
    for nbr, plan in calls:
        assert isinstance(plan, sc.SparseConvPlan)
        by_map.setdefault(maps[id(nbr)], set()).add(id(plan))
    assert {k: len(v) for k, v in by_map.items()} == {k: 1 for k in LADDER_MAPS}
    assert sorted(sum(1 for n, _ in calls if maps[id(n)] == k) for k in LADDER_MAPS) == \
        [1, 1, 1, 1, 2, 2, 2, 2]
    for nbr, plan in calls:
        key = maps[id(nbr)]
        want = sc.sparse_conv_plan(nbr, batch[LADDER_MAPS[key]].shape[1])
        assert torch.equal(plan.order, want.order) and torch.equal(plan.tile_mask, want.tile_mask)


# the map each layer of a training forward reads its backward through: its own
# for a submanifold layer, the transposed map of the strided ones
BACKWARD_MAPS = {'sp_submap1': 'sp_submap1', 'sp_downmap2': 'sp_upmap2',
                 'sp_submap2': 'sp_submap2', 'sp_downmap3': 'sp_upmap3',
                 'sp_submap3': 'sp_submap3', 'sp_downmap4': 'sp_upmap4',
                 'sp_submap4': 'sp_submap4', 'sp_outmap': 'sp_upmap_out'}


def test_a_training_forward_hands_each_layer_its_backward_map_and_plan(tiny_second,
                                                                       monkeypatch):
    """With the transposed maps of `get_host_prepare(training=True)`, every
    layer gets its backward map and that map's plan (over the layer's output
    rows): a submanifold layer its forward map and plan object, a strided one
    the transposed map and one plan built for it."""
    from pdm_ssd_torch.ops import sparse_maps
    net, batch = tiny_second
    caps = [batch[k].shape[1] for k in ('sp_mask1', 'sp_mask2', 'sp_mask3', 'sp_mask4',
                                        'sp_mask_out')]
    batch = {**batch, **sparse_maps.batch_invert_ladder(batch, caps)}
    calls = []
    real = dispatch.sparse_conv

    def recording(feats, nbr, weight, plan=None, bwd_nbr=None, bwd_plan=None):
        calls.append((nbr, plan, bwd_nbr, bwd_plan))
        return real(feats, nbr, weight, plan, bwd_nbr, bwd_plan)

    monkeypatch.setattr(dispatch, 'sparse_conv', recording)
    with torch.inference_mode():
        net.backbone_3d(net.vfe(dict(batch)))
    assert len(calls) == 12
    maps = {id(batch[k]): k for k in LADDER_MAPS}
    for nbr, plan, bwd, bplan in calls:
        key = maps[id(nbr)]
        assert bwd is batch[BACKWARD_MAPS[key]], key
        if key.startswith('sp_submap'):
            assert bplan is plan
        else:
            want = sc.sparse_conv_plan(bwd, nbr.shape[1])
            assert bplan.vin == nbr.shape[1] and torch.equal(bplan.order, want.order)
            assert torch.equal(bplan.tile_mask, want.tile_mask)


# ---- ball query: path and grid -------------------------------------------------------

@pytest.mark.parametrize('N,radii,want', [
    (16384, (0.1, 0.5), 'grid'), (4096, (0.5, 1.0), 'grid'), (1024, (1.0, 2.0), 'grid'),
    (512, (0.2,), 'walk'), (128, (0.4,), 'walk'),                # PointRCNN's ROI stack
    (16384, (0.0,), 'walk'), (16384, (float('inf'),), 'walk')])
def test_ball_query_plan_by_shape(N, radii, want):
    """PointRCNN's backbone levels take the grid, its ROI stack the walk; a
    radius that is no positive finite number leaves no grid."""
    plan = bq.ball_query_plan(N, radii)
    assert plan.path == want
    if want == 'grid':
        assert plan.cell > max(radii) and plan.cell == max(radii) * (1 + bq.CELL_MARGIN)


def test_ball_query_plan_forced_paths():
    assert bq.ball_query_plan(128, (0.4,), path='grid').path == 'grid'
    assert bq.ball_query_plan(16384, (0.4,), path='walk') == ('walk', 0.0)
    with pytest.raises(ValueError, match='no grid'):
        bq.ball_query_plan(16384, (0.0,), path='grid')
    with pytest.raises(ValueError, match='unknown ball-query path'):
        bq.ball_query_plan(16384, (0.4,), path='hash')


def test_build_grid_keeps_point_order_in_each_cell():
    """Keys sorted; within one key the points in ascending index; a masked
    point last with the sentinel key; the packed index and xyz are the
    point's own."""
    rng = np.random.RandomState(30)
    xyz = torch.from_numpy(rng.uniform(-3, 3, (2, 400, 3)).astype(np.float32))
    xyz[:, 200:260] = xyz[:, :60]                                    # duplicates
    mask = torch.from_numpy(rng.rand(2, 400) < 0.8)
    grid = bq.build_grid(xyz, 1.0, mask)
    idx = grid.points[..., 3].contiguous().view(torch.int32).long()
    for b in range(2):
        keys = grid.keys[b]
        assert bool((keys[1:] >= keys[:-1]).all())
        same = keys[1:] == keys[:-1]
        assert bool((idx[b, 1:] > idx[b, :-1])[same].all())
        assert sorted(idx[b].tolist()) == list(range(400))
        assert torch.equal(grid.points[b, :, :3], xyz[b, idx[b]])
        n_in = int(mask[b].sum())
        assert bool((keys[n_in:] == bq.KEY_SENTINEL).all())
        assert bool((keys[:n_in] < bq.KEY_SENTINEL).all())
    assert torch.equal(grid.keys[0, :5], bq.cell_keys(bq.cell_coords(xyz[0, idx[0, :5]], 1.0)))


def test_cell_coords_keep_every_hit_in_the_window():
    """A pair that passes the float32 test d2 < r*r lies within one cell per
    axis, with cells of edge r (1 + CELL_MARGIN): points on and just inside
    the sphere, at cell edges, far from the origin (float32 spacing near
    1e4), and beyond the clamp at 2^20 cells."""
    rng = np.random.RandomState(31)
    r = 0.1
    cell = r * (1 + bq.CELL_MARGIN)
    cases = []
    for base in (0.0, 1e4, -3.3e4, 2.0 ** 21 * cell, -(2.0 ** 21) * cell):
        c = (base + rng.randint(-50, 50, (4000, 3)) * cell).astype(np.float32)
        d = rng.normal(size=(4000, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        p = (c + d * r * rng.uniform(0.999, 1.0, (4000, 1))).astype(np.float32)
        cases.append((c, p))
    c = np.concatenate([x for x, _ in cases])
    p = np.concatenate([y for _, y in cases])
    diff = c - p
    d2 = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) + diff[:, 2] * diff[:, 2]
    hit = d2 < np.float32(r * r)
    assert hit.sum() > 5000
    cc = bq.cell_coords(torch.from_numpy(c), cell)
    pc = bq.cell_coords(torch.from_numpy(p), cell)
    assert int((cc - pc).abs()[torch.from_numpy(hit)].max()) <= 1


def _grid_case(kind: str):
    """(xyz, new_xyz, mask, radii, nsamples) as numpy: a small input of one
    kind of edge case."""
    rng = np.random.RandomState(32)
    if kind == 'radius_and_cell_edges':
        # centers on a grid of cell corners; points exactly r away along each
        # axis and at r in float32 on a diagonal, and points on cell edges
        r = 0.5
        cell = r * (1 + bq.CELL_MARGIN)
        centers = (np.stack(np.meshgrid(*[np.arange(-2, 3)] * 3), -1).reshape(-1, 3) * cell)
        offs = np.concatenate([np.eye(3) * r, -np.eye(3) * r, np.eye(3) * np.float32(r) * 0.999,
                               np.full((1, 3), r / np.sqrt(3)), np.eye(3) * cell])
        pts = (centers[:, None] + offs[None]).reshape(-1, 3)
        pts = np.concatenate([pts, centers]).astype(np.float32)[None]
        return pts, centers.astype(np.float32)[None], None, (r, r / 2), (16, 4)
    if kind == 'duplicates':
        pts = rng.uniform(0, 2, (2, 300, 3)).astype(np.float32)
        pts[:, 100:250] = pts[:, :150]
        pts[:, 250:] = pts[:, 7:8]
        return pts, pts[:, ::5].copy(), None, (0.3,), (40,)
    if kind == 'masked':
        pts = rng.uniform(0, 3, (3, 500, 3)).astype(np.float32)
        return pts, pts[:, :50].copy(), rng.rand(3, 500) < 0.5, (0.4, 0.8), (8, 24)
    if kind == 'empty_balls':
        pts = rng.uniform(0, 3, (2, 200, 3)).astype(np.float32)
        centers = pts[:, :30].copy()
        centers[:, :10] += 100.0
        centers[:, 10:20] -= 1e6
        return pts, centers, None, (0.2,), (5,)
    if kind == 'several_radii':
        pts = rng.uniform(-4, 4, (2, 800, 3)).astype(np.float32)
        return pts, pts[:, :64].copy(), None, (0.3, 0.9, 1.5, 2.5), (4, 16, 32, 64)
    if kind == 'far_from_origin':
        pts = (rng.uniform(0, 4, (2, 400, 3)) + np.array([3e4, -5e3, 1e3])).astype(np.float32)
        return pts, pts[:, :40].copy(), None, (0.5, 1.0), (8, 16)
    if kind == 'beyond_the_clamp':
        # points and centers far past 2^20 cells on every axis share the
        # largest cell with masked points, whose key lies past every cell's
        pts = rng.uniform(0, 1, (1, 60, 3)).astype(np.float32)
        pts[:, 30:] = 3e30
        mask = np.ones((1, 60), bool)
        mask[:, 40:] = False
        return pts, pts[:, 25:35].copy(), mask, (0.5,), (8,)
    if kind == 'all_masked':
        pts = rng.uniform(0, 1, (1, 50, 3)).astype(np.float32)
        return pts, pts[:, :5].copy(), np.zeros((1, 50), bool), (0.5,), (3,)
    raise ValueError(kind)


GRID_CASES = ['radius_and_cell_edges', 'duplicates', 'masked', 'empty_balls', 'several_radii',
              'far_from_origin', 'beyond_the_clamp', 'all_masked']


@pytest.mark.parametrize('kind', GRID_CASES)
def test_grid_walk_emulation_equals_the_plain_ball_query(kind):
    """The grid path's walk, emulated with torch ops on the grid the kernel
    reads (window runs by search, merged in point order), equals
    `ops/pointnet2.ball_query` exactly, and tests at most the window's points."""
    xyz, new_xyz, mask, radii, nsamples = _grid_case(kind)
    xyz, new_xyz = torch.from_numpy(xyz), torch.from_numpy(new_xyz)
    mask = None if mask is None else torch.from_numpy(mask)
    got, tests = bq.ball_query_grid_plain(radii, nsamples, xyz, new_xyz, mask, count_tests=True)
    for r, k, g in zip(radii, nsamples, got):
        want = plain.ball_query(r, k, xyz, new_xyz, mask=mask)
        assert g.dtype == torch.int32 and torch.equal(g, want), (kind, r)
    assert tuple(tests.shape) == tuple(new_xyz.shape[:2])
    assert int(tests.max()) <= xyz.shape[1]


def test_grid_walk_stops_at_the_last_radius_to_fill():
    """The tests the grid kernel makes: merging the window in point order, up
    to the K-th hit of the radius that fills last, or to the window's end
    where a ball stays underfull; where the window holds more than
    N // DENSE_SHARE points, walking the cloud in point order up to the same
    hit, or to the cloud's end."""
    near = torch.tensor([[[0.0, 0, 0], [0.1, 0, 0], [5.0, 0, 0], [0.2, 0, 0], [0.3, 0, 0],
                          [0.05, 0, 0]]])
    far = torch.arange(94, dtype=torch.float32)[None, :, None] * torch.tensor([0.0, 0, 9.0]) + 20
    for xyz, window_walk in ((torch.cat([near, far], 1), False), (near, True)):
        N = xyz.shape[1]
        assert (5 > N // bq.DENSE_SHARE) == window_walk
        _, tests = bq.ball_query_grid_plain([0.25, 0.35], [2, 3], xyz, xyz[:, :1],
                                            count_tests=True)
        # r=0.35 fills last, with points 0, 1, 3: the 3rd candidate of the
        # window, the 4th point of the cloud
        assert tests.tolist() == [[4 if window_walk else 3]]
        _, tests = bq.ball_query_grid_plain([0.25], [9], xyz, xyz[:, :1], count_tests=True)
        assert tests.tolist() == [[N if window_walk else 5]]


# ---- the kernels on the card ---------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize('kind', GRID_CASES + ['level_1'])
def test_ball_query_grid_and_walk_paths_match_plain_on_the_card(kind):
    """Both kernel paths, forced, equal the plain version bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    if kind == 'level_1':
        rng = np.random.RandomState(33)
        xyz = rng.uniform(0, 40, (2, 16384, 3)).astype(np.float32)
        xyz[..., 2] *= 0.05
        xyz, new_xyz, mask, radii, nsamples = xyz, xyz[:, :4096].copy(), None, (0.1, 0.5), (16, 32)
    else:
        xyz, new_xyz, mask, radii, nsamples = _grid_case(kind)
    xyz, new_xyz = torch.from_numpy(xyz).cuda(), torch.from_numpy(new_xyz).cuda()
    mask = None if mask is None else torch.from_numpy(mask).cuda()
    want = [plain.ball_query(r, k, xyz, new_xyz, mask=mask) for r, k in zip(radii, nsamples)]
    for path in ('grid', 'walk'):
        plan = bq.ball_query_plan(xyz.shape[1], radii, path=path)
        got = bq.ball_query_cuda(radii, nsamples, xyz, new_xyz, mask, plan=plan)
        torch.cuda.synchronize()
        for r, g, w in zip(radii, got, want):
            assert torch.equal(g, w), (kind, path, r)


@pytest.mark.gpu
@pytest.mark.parametrize('B,Vin,Vout,K,Cin,Cout', [
    (2, 3000, 2900, 27, 64, 64), (3, 1000, 1001, 27, 4, 16), (2, 900, 700, 3, 64, 128),
    (2, 640, 640, 27, 7, 100), (2, 500, 520, 27, 32, 32)])
def test_sparse_conv_kernel_result_does_not_depend_on_the_plan(B, Vin, Vout, K, Cin, Cout):
    """The kernel through its sorted plan, through rows in slot order with
    their tiles' OR-masks, and through a plan whose tiles claim every tap,
    gives the same bits: a row's result is one chain of multiply-adds over
    its own present taps in order."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    rng = np.random.RandomState(34)
    feats = torch.from_numpy(rng.randn(B, Vin, Cin).astype(np.float32)).cuda()
    nbr = rng.randint(0, Vin, (B, Vout, K)).astype(np.int32)
    nbr[rng.rand(B, Vout, K) < 0.7] = Vin
    nbr[:, ::7] = Vin
    nbr = torch.from_numpy(nbr).cuda()
    w = torch.from_numpy((rng.randn(K * Cin, Cout) * 0.1).astype(np.float32)).cuda()
    sorted_plan = sc.sparse_conv_plan(nbr, Vin)
    tiles = sorted_plan.tile_mask.shape[1]
    ident = torch.arange(Vout, dtype=torch.int32, device='cuda').expand(B, -1).contiguous()
    masks = sc.tap_masks(nbr, Vin)
    pad = torch.nn.functional.pad(masks, (0, tiles * sc.TILE_ROWS - Vout))
    bits = (pad.view(B, tiles, sc.TILE_ROWS, 1) >> torch.arange(K, device='cuda',
                                                                dtype=torch.int32)) & 1
    slot_plan = sc.SparseConvPlan(ident, (bits.amax(2) << torch.arange(
        K, device='cuda', dtype=torch.int32)).sum(-1, dtype=torch.int32), Vin)
    full_plan = sc.SparseConvPlan(ident, torch.full((B, tiles), (1 << K) - 1, dtype=torch.int32,
                                                    device='cuda'), Vin)
    with torch.no_grad():
        outs = [sc.sparse_conv_cuda(feats, nbr, w, p) for p in (sorted_plan, slot_plan, full_plan)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    assert not outs[0][:, ::7].any()
    exact = sc.sparse_conv_plain(feats.double(), nbr, w.double())
    mass = sc.sparse_conv_plain(feats.double().abs(), nbr, w.double().abs())
    assert bool(((outs[0].double() - exact).abs() <= K * Cin * 2.0 ** -24 * mass + 1e-30).all())


@pytest.mark.gpu
@pytest.mark.parametrize('kind,C', [(k, 5) for k in SCATTER_CASES]
                         + [('selection', c) for c in (1, 19, 37, 64, 128)])
def test_scatter_kernel_matches_the_run_merged_emulation_on_the_card(kind, C):
    """The kernel within the float64 bound; an output row that takes one sum
    equal bit for bit to the emulation's (the order of atomics cannot
    matter there)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    vals, idx, n_rows, _ = _scatter_case(kind)
    if C != vals.shape[2]:
        vals = torch.from_numpy(np.random.RandomState(42).randn(*idx.shape, C).astype(np.float32))
    B, R, _ = vals.shape
    plan = group.scatter_plan(B, R, C, n_rows, torch.cuda.get_device_properties(0)
                              .multi_processor_count)
    got = group.scatter_add_rows_cuda(vals.cuda(), idx.cuda(), n_rows).cpu()
    torch.cuda.synchronize()
    exact, tol = _scatter_bound(vals, idx, n_rows)
    assert bool(((got.double() - exact).abs() <= tol).all()), (kind, C)
    want = group.scatter_add_runs_plain(vals, idx, n_rows, plan.span)
    ok = (idx >= 0) & (idx < n_rows)
    end = torch.ones_like(ok)
    end[:, :-1] = idx[:, 1:] != idx[:, :-1]
    end |= torch.arange(R) % plan.span == plan.span - 1
    sums = group.scatter_add_rows_plain(torch.ones((B, R, 1)), torch.where(end & ok, idx, -1),
                                        n_rows)[..., 0]
    once = sums == 1
    assert torch.equal(got[once], want[once]), (kind, C)


@pytest.mark.gpu
@pytest.mark.parametrize('kind', WINDOW_CASES)
def test_window_select_kernel_matches_plain_at_the_walk_cases_on_the_card(kind):
    """The kernel equals the plain version bit for bit at every case of the
    walk emulation, stages past 48 KB of a block included."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    table, cells, gw, xyz, new_xyz, radii, nsamples, cap = _window_case(kind)
    want = group.window_select_plain(table, cells, gw, xyz, new_xyz, radii, nsamples)
    got = group.window_select_cuda(table.cuda().int(), cells.cuda().int(), gw, xyz.cuda(),
                                   new_xyz.cuda(), radii, nsamples)
    torch.cuda.synchronize()
    for (g_rel, g_idx, g_hit), (w_rel, w_idx, w_hit) in zip(got, want):
        assert torch.equal(g_hit.cpu(), w_hit), kind
        assert torch.equal(g_idx.cpu().long(), w_idx), kind
        assert torch.equal(g_rel.cpu(), w_rel), kind
