"""The sparse conv's weight gradient (`ops/sparse_conv.sparse_conv_wgrad_cuda`,
`csrc/sparse_conv_wgrad.cu`): its launch plan on the CPU, a function of the
shapes alone, at either count of blocks an SM (the library picks 1 or 2 by
the widths), and the launch's checks of a plan on the card (`gpu` marker:
skips where there is no CUDA). The kernel's results are held to
float64 in `test_torch_port_guards.py::test_sparse_conv_kernel_matches_plain_on_the_card`."""
from collections import Counter
from pathlib import Path

import pytest
import torch

from pdm_ssd_torch.models import build_network
from pdm_ssd_torch.models.backbones_3d.sparse_backbone import SparseConvBNReLU
from pdm_ssd_torch.models.backbones_3d.sparse_backbone_focal import SparseTapDense
from pdm_ssd_torch.ops import sparse_conv as sc
from pdm_ssd_torch.utils.config import cfg_from_yaml_file

from torch_port_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
# (config, B, the stages' slot counts a map of that config reads and writes)
SHIPPED = [('second_sparse', 4, (16000, 52000, 36000, 35000)),
           ('voxelnext', 4, (40000, 52000, 36000, 35000)),
           ('second_focal', 4, (16000, 64000, 120000)),
           ('parta2_sparse', 2, (16000, 52000, 36000, 35000))]
# the widest shipped layers (64 -> 128 at K=3, 128 -> 64 at K=9 and 27): at
# one block an SM at most 3 taps x 132 chunks of 8192 floats, 12.98 MB
SCRATCH_BYTES_SHIPPED = 3 * 132 * 64 * 128 * 4


def _blocks(plan: sc.WgradPlan):
    """The weight gradient's blocks, each with the (tap, tile) pairs it
    sums: its row's taps, each over its tiles in ascending order
    (csrc/sparse_conv_wgrad.cu)."""
    for y in range(plan.rows):
        for x in range(plan.chunks):
            yield (y, x), [(k, t) for k in plan.row_taps[3 * y:3 * y + 3] if k >= 0
                           for t in range(x, plan.tiles, plan.chunks)]


@pytest.mark.parametrize('per_sm', [1, 2])
@pytest.mark.parametrize('B,Vout,K,Cin,Cout', [
    (4, 16000, 27, 4, 16), (4, 52000, 27, 64, 64), (4, 35000, 3, 64, 128),
    (4, 35000, 9, 128, 64), (4, 64000, 27, 16, 27), (1, 1, 3, 5, 3), (3, 1000, 27, 7, 100),
    (2, 640, 9, 128, 128), (1, 64 * 264 + 1, 27, 32, 32), (8, 400000, 9, 64, 64),
    (2, 700, 5, 16, 16), (1, 100, 1, 8, 8)])
def test_wgrad_plan_covers_every_tap_and_tile_once(B, Vout, K, Cin, Cout, per_sm):
    """Every (tap, tile) pair of the batch is summed by exactly one block,
    each block walks its tiles in ascending order and at most
    WGRAD_MAX_TILES of them, and the blocks fill one wave of the card (never
    more chunks than tiles)."""
    plan = sc.wgrad_plan(B, Vout, K, Cin, Cout, per_sm)
    assert plan.rows == -(-K // 3) and len(plan.row_taps) == 3 * plan.rows
    assert plan.tiles == B * -(-Vout // sc.TILE_ROWS)
    assert 1 <= plan.chunks <= plan.tiles
    assert (plan.chunks == plan.tiles or plan.chunks * plan.rows <= sc.WGRAD_SMS * per_sm
            or plan.chunks == -(-plan.tiles // sc.WGRAD_MAX_TILES))
    seen = Counter()
    for _, pairs in _blocks(plan):
        for k in {k for k, _ in pairs}:
            mine = [t for kk, t in pairs if kk == k]
            assert mine == sorted(mine) and len(mine) <= sc.WGRAD_MAX_TILES
        seen.update(pairs)
    assert set(seen) == {(k, t) for k in range(K) for t in range(plan.tiles)}
    assert set(seen.values()) == {1}
    assert plan.scratch == K * plan.chunks * Cin * Cout


@pytest.mark.parametrize('K', [27, 9, 3, 5])
def test_wgrad_rows_spread_each_plane_of_taps(K):
    """The table of taps the kernel is handed partitions the taps into rows
    of 3 (-1 fills the last); at K=27 every row holds one tap of each plane
    dz, dy and dx = const of the 3 x 3 x 3 kernel, at K=9 one tap of each dy
    and each dx, so a thin layer of sites (most present taps in one plane)
    gives every row the same share."""
    table = sc.wgrad_row_taps(K)
    rows = [[k for k in table[i:i + 3] if k >= 0] for i in range(0, len(table), 3)]
    assert len(rows) == -(-K // 3) and all(rows)
    assert sorted(k for r in rows for k in r) == list(range(K))
    if K == 27:
        for r in rows:
            for axis in range(3):
                assert sorted(k // 3 ** (2 - axis) % 3 for k in r) == [0, 1, 2]
    if K == 9:
        for r in rows:
            assert sorted(k // 3 for k in r) == sorted(k % 3 for k in r) == [0, 1, 2]


def test_wgrad_plan_is_a_function_of_the_shapes():
    """The plan, and with it the order of every sum, takes nothing but the
    shapes, and gives the same answer on every call; the kernel's summation
    order over a block's rows (its row groups, then their fixed tree) and
    over the chunks follows from it."""
    shapes = [(4, 52000, 27, 64, 64, 2), (4, 16000, 27, 4, 16, 2), (2, 700, 3, 64, 128, 1)]
    first = [sc.wgrad_plan(*s) for s in shapes]
    assert [sc.wgrad_plan(*s) for s in reversed(shapes)][::-1] == first
    assert [list(_blocks(p)) for p in first] == [list(_blocks(sc.wgrad_plan(*s))) for s in shapes]


@pytest.mark.parametrize('per_sm', [1, 2])
@pytest.mark.parametrize('config,B,slots', SHIPPED)
def test_wgrad_scratch_is_within_its_bound_at_the_shipped_widths(config, B, slots, per_sm,
                                                                  monkeypatch):
    """At every sparse layer of the shipped sparse files (the model built on
    the meta device, no weights), at each stage's slot count, the partials
    hold at most 3 * WGRAD_SMS * per_sm * Cin * Cout floats, and at most
    per_sm x 12.98 MB (the widest layers: 64 -> 128 and 128 -> 64, which the
    library runs at one block an SM)."""
    monkeypatch.chdir(REPO)
    layers = set()
    for cls in (SparseConvBNReLU, SparseTapDense):
        def init(self, in_features, features, taps, *args, _init=cls.__init__, **kwargs):
            layers.add((taps, in_features, features))
            _init(self, in_features, features, taps, *args, **kwargs)
        monkeypatch.setattr(cls, '__init__', init)
    cfg = cfg_from_yaml_file(f'configs/kitti_models/{config}.yaml')
    build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device='meta')
    assert len(layers) >= 7
    most = 0
    for K, Cin, Cout in sorted(layers):
        for V in slots:
            plan = sc.wgrad_plan(B, V, K, Cin, Cout, per_sm)
            assert plan.scratch <= 3 * sc.WGRAD_SMS * per_sm * Cin * Cout
            most = max(most, plan.scratch * 4)
    assert most <= per_sm * SCRATCH_BYTES_SHIPPED


@pytest.mark.gpu
def test_wgrad_launch_refuses_a_plan_it_cannot_run_on_the_card():
    """The launch takes the plan's table of taps and chunks: a table that
    misses or repeats a tap, tiles of another height, or chunks that leave a
    block more than WGRAD_MAX_TILES tiles are refused with an invalid value
    (CUDA error 1); the plan as built runs, and the wrapper records its
    scratch."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    import ctypes

    from pdm_ssd_torch.ops import kernels
    lib = kernels.load()
    B, V, K, C = 1, 64 * 1025, 9, 16
    feats = torch.randn(B, V, C, device='cuda')
    dy = torch.randn(B, V, C, device='cuda')
    nbr = torch.randint(0, V, (B, V, K), dtype=torch.int32, device='cuda')
    plan = sc.wgrad_plan(B, V, K, C, C, lib.sparse_conv_wgrad_blocks_per_sm(C, C))
    tile_taps = torch.empty(plan.tiles, dtype=torch.int32, device='cuda')
    partial = torch.empty(K * 2 * C * C, device='cuda')
    dw = torch.empty(K * C, C, device='cuda')

    def launch(table, tile_rows=sc.TILE_ROWS, chunks=2):
        row_taps = (ctypes.c_int * len(table))(*table)
        return lib.sparse_conv_wgrad_launch(
            feats.data_ptr(), nbr.data_ptr(), dy.data_ptr(), row_taps, tile_taps.data_ptr(),
            partial.data_ptr(), dw.data_ptr(), B, V, V, K, C, C, tile_rows, chunks,
            kernels.stream(feats.device.index))

    good = list(plan.row_taps)
    assert launch(good) == 0
    assert launch(good[1:2] + good[1:]) == 1                 # a tap twice, tap 0 missing
    assert launch(good[:-1] + [-1]) == 1                     # a tap missing
    assert launch(good[:-1] + [K]) == 1                      # a tap past K
    assert launch(good, tile_rows=2 * sc.TILE_ROWS) == 1
    assert launch(good, chunks=1) == 1                       # 1025 tiles for one block
    torch.cuda.synchronize()
    sc.sparse_conv_wgrad_cuda(feats, nbr, dy)
    assert sc.sparse_conv_wgrad_cuda.last_scratch_bytes == plan.scratch * 4
