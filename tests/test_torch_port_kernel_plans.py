"""Launch plans of the FPS and row-gather kernels, and the kernel loader, on
the CPU: `ops/fps.fps_plan` and `ops/group.gather_plan` are plain Python,
so the choices the card's launches follow are tested here with the card's
counts mocked. The kernels themselves run in the `gpu`-marked tests of
`test_torch_port_guards.py`."""
import math

import pytest

from pdm_ssd_torch.ops import fps, group, kernels

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
