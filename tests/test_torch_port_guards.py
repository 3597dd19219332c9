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

from pdm_ssd_torch.ops import dispatch, fps
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
    'pdm_ssd_torch.tools.profile_predict',
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
