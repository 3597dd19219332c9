"""Guards of the port: no import of JAX or of the JAX package, device
dispatch, the kernel wrapper's contract, `chip_smoke.py` without a card, and
the kernel on the card (`gpu` marker: skips where there is no CUDA)."""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pdm_ssd_torch.ops import dispatch, fps, group, sa_fused
from pdm_ssd_torch.ops import pointnet2 as plain

REPO = Path(__file__).resolve().parents[1]

SLICE_MODULES = [
    'pdm_ssd_torch', 'pdm_ssd_torch.ops.kernels', 'pdm_ssd_torch.ops.fps',
    'pdm_ssd_torch.ops.pointnet2', 'pdm_ssd_torch.ops.dispatch', 'pdm_ssd_torch.ops.sa_fused',
    'pdm_ssd_torch.ops.coders', 'pdm_ssd_torch.ops.selection', 'pdm_ssd_torch.ops.centernet',
    'pdm_ssd_torch.ops.iou3d', 'pdm_ssd_torch.utils.config', 'pdm_ssd_torch.utils.weights',
    'pdm_ssd_torch.models', 'pdm_ssd_torch.models.layers', 'pdm_ssd_torch.models.model_nms',
    'pdm_ssd_torch.models.backbones_3d.pointnet2_backbone',
    'pdm_ssd_torch.models.backbones_2d.pdm_neck',
    'pdm_ssd_torch.models.backbones_2d.base_bev_backbone',
    'pdm_ssd_torch.models.dense_heads.point_head_box',
    'pdm_ssd_torch.models.dense_heads.center_head',
    'pdm_ssd_torch.models.detectors.pdm_ssd', 'pdm_ssd_torch.utils.synthetic',
    'pdm_ssd_torch.tools.profile_predict', 'pdm_ssd_torch.tools.profile_train',
    'pdm_ssd_torch.tools.dryrun', 'pdm_ssd_torch.ops.group', 'pdm_ssd_torch.ops.box_ops',
    'pdm_ssd_torch.ops.losses', 'pdm_ssd_torch.runtime.optimization',
    'pdm_ssd_torch.runtime.trainer',
]


def chip_smoke_imports() -> list:
    """Every absolute module `chip_smoke.py` imports, at top level or inside a
    function (its repo imports come after the device check)."""
    tree = ast.parse((REPO / 'chip_smoke.py').read_text())
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module)
            mods += [f'{node.module}.{a.name}' for a in node.names]
    return sorted(set(mods) - {'__future__'})


def test_port_and_chip_smoke_import_no_jax():
    mods = SLICE_MODULES + chip_smoke_imports()
    assert 'pdm_ssd_torch.utils.config' in mods and 'pdm_ssd_torch.ops.fps' in mods
    code = ('import importlib, sys\n'
            f'for m in {mods!r}:\n'
            '    try:\n'
            '        importlib.import_module(m)\n'
            '    except ModuleNotFoundError:\n'
            "        importlib.import_module(m.rpartition('.')[0])\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pdm_ssd_tpu')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == 'clean'


@pytest.mark.parametrize('cfg_file', sorted(str(p.relative_to(REPO))
                                            for p in (REPO / 'configs').rglob('*.yaml')))
def test_config_loader_matches_the_jax_package(cfg_file, monkeypatch):
    """The port's copy of the YAML loader builds the same tree as the JAX
    package's, `_BASE_CONFIG_` merges and dotted overrides included."""
    from pdm_ssd_torch.utils import config as t_config
    from pdm_ssd_tpu.utils import config as j_config
    monkeypatch.chdir(REPO)   # configs name their base config relative to the repo
    got = t_config.cfg_from_yaml_file(cfg_file)
    want = j_config.cfg_from_yaml_file(cfg_file)
    assert type(got) is t_config.CfgNode
    assert got.to_dict() == want.to_dict()
    override = ['TAG', "'renamed'"]
    assert (t_config.cfg_from_list(override, got).to_dict()
            == j_config.cfg_from_list(override, want).to_dict())
    assert got.TAG == 'renamed'


def test_cpu_dispatch_runs_plain_fps_and_kernel_wrapper_refuses_cpu():
    rng = np.random.RandomState(0)
    xyz = torch.from_numpy(rng.rand(2, 300, 3).astype(np.float32))
    fps.farthest_point_sample_cuda.launches = 0
    got = dispatch.farthest_point_sample(xyz, 64)
    assert torch.equal(got, plain.farthest_point_sample(xyz, 64))
    assert fps.farthest_point_sample_cuda.launches == 0
    with pytest.raises(ValueError, match='CUDA'):
        fps.farthest_point_sample_cuda(xyz, 64)
    assert fps.farthest_point_sample_cuda.launches == 0
    with pytest.raises(NotImplementedError):
        dispatch.farthest_point_sample(xyz.to('meta'), 64)


def test_grouping_dispatch_runs_plain_on_cpu_and_kernel_wrappers_refuse_cpu():
    """CPU tensors take the plain versions and launch nothing; the kernel
    wrappers take CUDA tensors only; any other device raises (a tensor that
    is not on the CPU never reaches a plain version)."""
    rng = np.random.RandomState(4)
    radii, nsamples = (0.5, 1.0), (4, 8)
    table, cells, gw, xyz, new_xyz = _select_inputs(rng, 2, 300, 40, 8, radii)
    feats = torch.from_numpy(rng.randn(2, 300, 6).astype(np.float32))
    idx = torch.from_numpy(rng.randint(-1, 301, (2, 50)))
    wrappers = (group.window_select_cuda, group.gather_rows_cuda, group.scatter_add_rows_cuda)
    for w in wrappers:
        w.launches = 0
    sel = dispatch.window_select(table, cells, gw, xyz, new_xyz, radii, nsamples)
    assert [tuple(o[1].shape) for o in sel] == [(2, 40, 4), (2, 40, 8)]
    rows = dispatch.gather_rows(feats, idx)
    assert torch.equal(rows, group.gather_rows_plain(feats, idx))
    back = dispatch.scatter_add_rows(rows, idx, 300)
    assert torch.equal(back, group.scatter_add_rows_plain(rows, idx, 300))
    with pytest.raises(ValueError, match='CUDA'):
        group.window_select_cuda(table, cells.to(torch.int32), gw, xyz, new_xyz, radii, nsamples)
    with pytest.raises(ValueError, match='CUDA'):
        group.gather_rows_cuda(feats, idx.to(torch.int32))
    with pytest.raises(ValueError, match='CUDA'):
        group.scatter_add_rows_cuda(rows, idx.to(torch.int32), 300)
    assert all(w.launches == 0 for w in wrappers)
    with pytest.raises(NotImplementedError):
        dispatch.window_select(table.to('meta'), cells.to('meta'), gw, xyz.to('meta'),
                               new_xyz.to('meta'), radii, nsamples)
    with pytest.raises(NotImplementedError):
        dispatch.gather_rows(feats.to('meta'), idx.to('meta'))
    with pytest.raises(NotImplementedError):
        dispatch.scatter_add_rows(rows.to('meta'), idx.to('meta'), 300)


def test_entry_points_default_to_the_card(monkeypatch):
    """`build_network` and the dry run with no device named need CUDA: where
    it is absent they raise instead of building on the CPU."""
    from pdm_ssd_torch.models import build_network
    from pdm_ssd_torch.tools import dryrun
    from pdm_ssd_torch.utils import config as t_config
    monkeypatch.chdir(REPO)
    cfg = t_config.cfg_from_yaml_file('configs/kitti_models/pdm_ssd_point.yaml')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_network(cfg.MODEL, 3, cfg.DATA_CONFIG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.dryrun()


@pytest.mark.parametrize('where', ['repo', 'alone'])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    """Without CUDA (and alone, without the repo) the smoke run exits
    non-zero and prints no result line."""
    if where == 'repo':
        cwd, script = REPO, REPO / 'chip_smoke.py'
    else:
        script = tmp_path / 'chip_smoke.py'
        shutil.copy(REPO / 'chip_smoke.py', script)
        cwd = tmp_path
    if torch.cuda.is_available() and where == 'repo':
        pytest.skip('a card is present: chip_smoke.py would run in full')
    res = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


@pytest.mark.gpu
def test_fps_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    rng = np.random.RandomState(1)
    for B, N, npoint in [(2, 1000, 300), (3, 10007, 2000), (8, 16384, 4096)]:
        x = torch.from_numpy(rng.rand(B, N, 3).astype(np.float32) * 50).cuda()
        got = fps.farthest_point_sample_cuda(x, npoint)
        torch.cuda.synchronize()
        assert torch.equal(got, plain.farthest_point_sample(x, npoint))


def _select_inputs(rng, B, N, M, cap, radii, pc_range=(0.0, -8.0, 12.0, 8.0)):
    """A cloud with points and centers outside the range, on the device-free
    side: returns CPU tensors (table, center_cells, grid_w, xyz, new_xyz)."""
    xyz = np.stack([rng.uniform(-1, 13, (B, N)), rng.uniform(-9, 9, (B, N)),
                    rng.uniform(-1, 1, (B, N))], -1).astype(np.float32)
    new_xyz = xyz[:, :M].copy()
    new_xyz[:, :5, 0] = 40.0                      # out-of-range centers
    new_xyz[:, 5:9, 2] = 30.0                     # in range, empty balls
    cs = float(max(radii))
    gw = sa_fused.grid_dims(pc_range, cs)
    pc_min = (pc_range[0] - cs, pc_range[1] - cs)
    xyz, new_xyz = torch.from_numpy(xyz), torch.from_numpy(new_xyz)
    table = sa_fused.build_slot_table(xyz, cs, gw, cap, pc_min)
    return table, sa_fused.cell_ids(new_xyz, cs, gw, pc_min), gw[0], xyz, new_xyz


@pytest.mark.gpu
@pytest.mark.parametrize('cap,nsamples', [(32, (16, 32)), (4, (8, 16)), (20, (5, 70, 3))])
def test_window_select_kernel_matches_plain_on_the_card(cap, nsamples):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    radii = (0.5, 1.0, 0.7)[:len(nsamples)]
    args = _select_inputs(np.random.RandomState(2), 3, 3001, 333, cap, radii)
    want = group.window_select_plain(*args, radii, nsamples)
    table, cells, gw, xyz, new_xyz = args
    got = dispatch.window_select(table.cuda(), cells.cuda(), gw, xyz.cuda(), new_xyz.cuda(),
                                 radii, nsamples)
    torch.cuda.synchronize()
    for (w_rel, w_idx, w_hit), (g_rel, g_idx, g_hit) in zip(want, got):
        assert (~w_hit).sum() >= 9
        assert torch.equal(g_hit.cpu(), w_hit)
        assert torch.equal(g_idx.cpu().long(), w_idx)
        assert torch.equal(g_rel.cpu(), w_rel)


@pytest.mark.gpu
@pytest.mark.parametrize('C,s0,s1', [(1, 0, 1), (64, 0, 64), (128, 64, 128), (37, 3, 22)])
def test_gather_and_scatter_kernels_match_plain_on_the_card(C, s0, s1):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    rng = np.random.RandomState(3)
    B, N, R = 3, 501, 2777
    feats = torch.from_numpy(rng.randn(B, N, C).astype(np.float32))
    idx = torch.from_numpy(rng.randint(-3, N + 3, (B, R)))
    view = feats.cuda()[..., s0:s1]
    got = dispatch.gather_rows(view, idx.cuda())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), group.gather_rows_plain(feats[..., s0:s1], idx))
    vals = torch.from_numpy(rng.randn(B, R, s1 - s0).astype(np.float32))
    back = dispatch.scatter_add_rows(vals.cuda(), idx.cuda(), N)
    torch.cuda.synchronize()
    want = group.scatter_add_rows_plain(vals.double(), idx, N)
    # float32 atomic sums of ~R/N = 6 terms of unit scale in any order, held
    # against a float64 sum: a few ulp of the largest partial sum
    torch.testing.assert_close(back.cpu().double(), want, rtol=0, atol=1e-5)
