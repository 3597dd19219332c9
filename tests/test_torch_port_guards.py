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

from pdm_ssd_torch.ops import ball_query as bq
from pdm_ssd_torch.ops import dispatch, fps, group, kernels, sa_fused
from pdm_ssd_torch.ops import pointnet2 as plain
from pdm_ssd_torch.ops import sparse_conv as sc

from torch_port_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]

SLICE_MODULES = [
    'pdm_ssd_torch.datasets.nuscenes.nuscenes_dataset',
    'pdm_ssd_torch.datasets.nuscenes.nuscenes_eval',
    'pdm_ssd_torch.datasets.nuscenes.nuscenes_info', 'pdm_ssd_torch.datasets.nuscenes.synthetic',
    'pdm_ssd_torch.tools.make_mini_nuscenes',
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
    'pdm_ssd_torch.tools.dryrun', 'pdm_ssd_torch.tools.time_kernels',
    'pdm_ssd_torch.ops.group', 'pdm_ssd_torch.ops.box_ops',
    'pdm_ssd_torch.ops.losses', 'pdm_ssd_torch.runtime.optimization',
    'pdm_ssd_torch.runtime.trainer', 'pdm_ssd_torch.ops.ball_query',
    'pdm_ssd_torch.models.roi_heads.roi_head_template',
    'pdm_ssd_torch.models.roi_heads.pointrcnn_head', 'pdm_ssd_torch.models.detectors.point_rcnn',
    'pdm_ssd_torch.ops.voxelize', 'pdm_ssd_torch.ops.sparse_maps', 'pdm_ssd_torch.ops.sparse_conv',
    'pdm_ssd_torch.models.backbones_3d.vfe', 'pdm_ssd_torch.models.backbones_3d.sparse_backbone',
    'pdm_ssd_torch.models.dense_heads.anchor_head', 'pdm_ssd_torch.models.detectors.detector3d',
    'pdm_ssd_torch.utils.np_iou', 'pdm_ssd_torch.utils.common_utils',
    'pdm_ssd_torch.utils.box_utils_np', 'pdm_ssd_torch.datasets',
    'pdm_ssd_torch.datasets.dataset', 'pdm_ssd_torch.datasets.processor.data_processor',
    'pdm_ssd_torch.datasets.processor.point_feature_encoder',
    'pdm_ssd_torch.datasets.augmentor.augmentor_utils',
    'pdm_ssd_torch.datasets.augmentor.database_sampler',
    'pdm_ssd_torch.datasets.augmentor.data_augmentor',
    'pdm_ssd_torch.datasets.kitti.calibration', 'pdm_ssd_torch.datasets.kitti.object3d',
    'pdm_ssd_torch.datasets.kitti.kitti_utils', 'pdm_ssd_torch.datasets.kitti.kitti_dataset',
    'pdm_ssd_torch.datasets.kitti.eval', 'pdm_ssd_torch.datasets.kitti.synthetic',
    'pdm_ssd_torch.runtime.eval_utils', 'pdm_ssd_torch.tools.make_mini_kitti',
    'pdm_ssd_torch.tools.cli_common', 'pdm_ssd_torch.tools.train', 'pdm_ssd_torch.tools.test',
    'pdm_ssd_torch.ops.pillarize', 'pdm_ssd_torch.models.backbones_3d.grid_point_backbone',
    'pdm_ssd_torch.models.backbones_2d.pdm_neck_conv',
    'pdm_ssd_torch.models.dense_heads.point_head_simple',
    'pdm_ssd_torch.models.backbones_2d.map_to_bev',
    'pdm_ssd_torch.models.backbones_3d.voxel_backbone',
    'pdm_ssd_torch.models.backbones_3d.sparse_backbone_focal',
    'pdm_ssd_torch.models.dense_heads.voxelnext_head',
    'pdm_ssd_torch.models.backbones_3d.pfe', 'pdm_ssd_torch.models.roi_heads.pvrcnn_head',
    'pdm_ssd_torch.models.roi_heads.voxelrcnn_head', 'pdm_ssd_torch.models.detectors.pv_rcnn',
    'pdm_ssd_torch.models.detectors.voxel_rcnn',
    'pdm_ssd_torch.models.roi_heads.second_head', 'pdm_ssd_torch.models.detectors.second_iou',
    'pdm_ssd_torch.models.dense_heads.point_intra_part_head', 'pdm_ssd_torch.ops.roiaware',
    'pdm_ssd_torch.models.roi_heads.parta2_head', 'pdm_ssd_torch.models.detectors.parta2',
    'pdm_ssd_torch.models.detectors.pv_rcnn_plusplus',
    'pdm_ssd_torch.models.backbones_2d.dsvt_backbone',
    'pdm_ssd_torch.models.dense_heads.transfusion_head', 'pdm_ssd_torch.ops.lap',
    'pdm_ssd_torch.datasets.waymo.synthetic', 'pdm_ssd_torch.datasets.waymo.waymo_dataset',
    'pdm_ssd_torch.datasets.waymo.waymo_utils', 'pdm_ssd_torch.datasets.waymo.waymo_eval',
    'pdm_ssd_torch.tools.make_mini_waymo', 'pdm_ssd_torch.models.roi_heads.mppnet_head',
    'pdm_ssd_torch.models.detectors.mppnet',
    'pdm_ssd_torch.ops.bev_pool', 'pdm_ssd_torch.datasets.image_ops',
    'pdm_ssd_torch.models.backbones_image.swin',
    'pdm_ssd_torch.models.backbones_image.generalized_lss',
    'pdm_ssd_torch.models.backbones_image.fuser',
    'pdm_ssd_torch.models.backbones_image.image_backbone',
    'pdm_ssd_torch.models.view_transforms.depth_lss',
    'pdm_ssd_torch.models.detectors.bev_fusion',
    'bench_torch',
]


def test_guard_list_names_every_module_of_the_port():
    found = {'.'.join(p.relative_to(REPO).with_suffix('').parts)
             for p in (REPO / 'pdm_ssd_torch').rglob('*.py') if p.name != '__init__.py'}
    assert found <= set(SLICE_MODULES), sorted(found - set(SLICE_MODULES))
    assert (REPO / 'bench_torch.py').exists() and 'bench_torch' in SLICE_MODULES


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
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pdm_ssd_tpu', 'PIL')]\n"
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
        group.gather_rows_cuda(feats.to(torch.bfloat16), idx.to(torch.int32))
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        group.gather_rows_cuda(feats.to(torch.float16), idx.to(torch.int32))
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


def test_ball_query_dispatch_runs_plain_on_cpu_and_kernel_wrapper_refuses_cpu():
    """CPU tensors take the plain ball query and the plain grouping and launch
    nothing; the kernel's wrapper takes CUDA tensors only; any other device
    raises. `pc_range` is taken and ignored."""
    rng = np.random.RandomState(5)
    xyz = torch.from_numpy(rng.uniform(0, 6, (2, 300, 3)).astype(np.float32))
    new_xyz = xyz[:, :40].contiguous()
    mask = torch.from_numpy(rng.rand(2, 300) < 0.7)
    feats = torch.from_numpy(rng.randn(2, 300, 5).astype(np.float32))
    bq.ball_query_cuda.launches = group.gather_rows_cuda.launches = 0
    got = dispatch.ball_query(1.0, 8, xyz, new_xyz, pc_range=(0.0, 0.0, 6.0, 6.0))
    assert torch.equal(got, plain.ball_query(1.0, 8, xyz, new_xyz))
    level = dispatch.ball_query_level([1.0, 2.0], [8, 4], xyz, new_xyz, mask=mask)
    assert [tuple(i.shape) for i in level] == [(2, 40, 8), (2, 40, 4)]
    assert torch.equal(level[1], plain.ball_query(2.0, 4, xyz, new_xyz, mask=mask))
    grouped = dispatch.grouping_operation(feats, got)
    assert torch.equal(grouped, plain.grouping_operation(feats, got))
    with pytest.raises(ValueError, match='CUDA'):
        bq.ball_query_cuda([1.0], [8], xyz, new_xyz)
    assert bq.ball_query_cuda.launches == 0 and group.gather_rows_cuda.launches == 0
    with pytest.raises(NotImplementedError):
        dispatch.ball_query(1.0, 8, xyz.to('meta'), new_xyz.to('meta'))
    with pytest.raises(NotImplementedError):
        dispatch.grouping_operation(feats.to('meta'), got.to('meta'))


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """`build_network`, the dry run, the eval loop, the train and test CLIs
    and `bench_torch.py` with no device named need CUDA: where it is absent
    they raise instead of running on the CPU, before they load anything."""
    import bench_torch
    from pdm_ssd_torch.models import build_network
    from pdm_ssd_torch.runtime import eval_utils
    from pdm_ssd_torch.tools import dryrun
    from pdm_ssd_torch.tools import test as test_cli
    from pdm_ssd_torch.tools import train as train_cli
    from pdm_ssd_torch.utils import config as t_config
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_torch.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_utils.eval_one_epoch(torch.nn.Linear(1, 1), [], None, ['Car'])
    cli_args = ['--cfg_file', 'configs/kitti_models/pdm_ssd_point.yaml',
                '--output_dir', str(tmp_path)]
    for cli in (train_cli, test_cli):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(cli_args)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(cli_args + ['--device', 'cuda'])
    assert not any(tmp_path.iterdir())
    for cfg_file in ('configs/kitti_models/pdm_ssd_point.yaml',
                     'configs/kitti_models/pointrcnn.yaml',
                     'configs/kitti_models/second_sparse.yaml',
                     'configs/kitti_models/pdm_ssd.yaml', 'configs/kitti_models/pdm_ssd_aux.yaml',
                     'configs/kitti_models/pdm_ssd_large.yaml',
                     'configs/kitti_models/pointpillar.yaml',
                     'configs/kitti_models/centerpoint_pillar.yaml',
                     'configs/kitti_models/pillarnet.yaml', 'configs/kitti_models/second.yaml',
                     'configs/kitti_models/voxelnext.yaml',
                     'configs/kitti_models/second_focal.yaml',
                     'configs/kitti_models/pv_rcnn.yaml',
                     'configs/kitti_models/pv_rcnn_sparse.yaml',
                     'configs/kitti_models/voxel_rcnn.yaml',
                     'configs/kitti_models/voxel_rcnn_sparse.yaml'):
        cfg = t_config.cfg_from_yaml_file(cfg_file)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_network(cfg.MODEL, 3, cfg.DATA_CONFIG)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dryrun.dryrun(cfg_file=cfg_file)


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


def _sparse_conv_inputs(rng, B=2, Vin=300, Vout=77, K=27, Cin=8, Cout=8):
    """CPU tensors (feats, nbr, weight): about 10% of the taps absent, one row
    with none present, and entries on both sides of [0, Vin)."""
    feats = torch.from_numpy(rng.randn(B, Vin, Cin).astype(np.float32))
    nbr = rng.randint(0, Vin, (B, Vout, K)).astype(np.int32)
    nbr[rng.rand(B, Vout, K) < 0.1] = Vin
    nbr[:, Vout // 2] = Vin
    nbr[:, 0, 0] = -1
    weight = torch.from_numpy((rng.randn(K * Cin, Cout) * 0.1).astype(np.float32))
    return feats, torch.from_numpy(nbr), weight


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: it takes `dispatch` down its
    CUDA branch where there is no card."""
    device = property(lambda self: torch.device('cuda', 0))


def test_sparse_conv_dispatch_has_no_quiet_plain_version(monkeypatch):
    """CPU tensors take the plain version and launch nothing, in the forward
    and in the backward. A tensor on the card whose kernel cannot be had
    raises, in the forward and in both products of the backward: the plain
    versions are not tried. The kernels' wrappers take CUDA tensors only;
    any other device raises."""
    feats, nbr, weight = _sparse_conv_inputs(np.random.RandomState(12))
    sc.sparse_conv_cuda.launches = sc.sparse_conv_wgrad_cuda.launches = 0
    got = dispatch.sparse_conv(feats, nbr, weight)
    assert torch.equal(got, sc.sparse_conv_plain(feats, nbr, weight))
    assert not got[:, 77 // 2].any()
    with pytest.raises(ValueError, match='CUDA'):
        sc.sparse_conv_cuda(feats, nbr, weight)
    dy = torch.ones_like(got)
    with pytest.raises(ValueError, match='CUDA'):
        sc.sparse_conv_wgrad_cuda(feats, nbr, dy)
    w = torch.nn.Parameter(weight.clone())
    dispatch.sparse_conv(feats, nbr, w).backward(dy)
    assert torch.equal(w.grad, sc.sparse_conv_wgrad_plain(feats, nbr, dy))
    with pytest.raises(NotImplementedError):
        dispatch.sparse_conv(feats.to('meta'), nbr.to('meta'), weight.to('meta'))

    def no_kernel():
        raise RuntimeError('nvcc not found')

    def no_plain(*args):
        raise AssertionError('the plain version ran for a tensor on the card')

    monkeypatch.setattr(kernels, 'load', no_kernel)
    for name in ('sparse_conv_plain', 'sparse_conv_wgrad_plain', 'sparse_conv_dgrad_plain'):
        monkeypatch.setattr(sc, name, no_plain)
    on_card = [t.as_subclass(_OnCard) for t in (feats, nbr, weight, dy)]
    assert on_card[0].device.type == 'cuda'
    with pytest.raises(RuntimeError, match='nvcc not found'):
        dispatch.sparse_conv(*on_card[:3])
    # the backward: the weight gradient, and the data gradient through the
    # transposed map (the map of a 27-tap layer onto itself stands in for it)
    o_feats, o_nbr, o_weight, o_dy = on_card
    for need_feats, need_weight in ((False, True), (True, False)):
        with pytest.raises(RuntimeError, match='nvcc not found'):
            sc.sparse_conv_grads(o_dy, o_feats, o_nbr, o_weight, None, o_nbr, None,
                                 need_feats, need_weight)
    assert sc.sparse_conv_cuda.launches == sc.sparse_conv_wgrad_cuda.launches == 0


@pytest.mark.parametrize('what', ['TABLE_DTYPE int8', 'SparseUNetV2 training maps', 'QWIN',
                                  'SparseUNetV2', 'multi_classes_nms'])
def test_unported_parts_of_the_voxel_family_raise(what, monkeypatch):
    """Every option and module name of the voxel family that the port does not
    have raises `NotImplementedError` naming its ROADMAP item, at build time
    or where it is first used. `SparseUNetV2` is ported: its cases hold the
    UNet to the options it still lacks, int8 tables and QWIN's correction
    lists in its training batches. NMS_TYPE `multi_classes_nms` is ported
    too: its case holds SECOND's anchor head to its per-class slots (3
    classes of NMS_POST_MAXSIZE each, each holding its class only)."""
    from pdm_ssd_torch.models import build_network, get_host_prepare
    from pdm_ssd_torch.utils import config as t_config
    from pdm_ssd_torch.utils import synthetic
    monkeypatch.chdir(REPO)
    cfg = synthetic.tiny_second_cfg(
        t_config.cfg_from_yaml_file('configs/kitti_models/second_sparse.yaml'))
    model, ds = cfg.MODEL, cfg.DATA_CONFIG

    def build():
        return build_network(model, 3, ds, device='cpu')

    def prepare(training=False):
        return get_host_prepare(model, ds, training=training)

    if what == 'multi_classes_nms':
        nms = model.POST_PROCESSING.NMS_CONFIG
        nms.NMS_TYPE = 'multi_classes_nms'
        net = synthetic.open_score_gate(build())
        det = net.predict(prepare()(synthetic.voxel_batch(1, 300, cfg, seed=1)))
        post = nms.NMS_POST_MAXSIZE
        assert det['pred_mask'].shape == (1, 3 * post) and bool(det['pred_mask'].any())
        for c in range(3):
            labels = det['pred_labels'][0, c * post:(c + 1) * post]
            assert set(labels[det['pred_mask'][0, c * post:(c + 1) * post]].tolist()) <= {c + 1}
        return
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        if what == 'TABLE_DTYPE int8':
            model.BACKBONE_3D.TABLE_DTYPE = 'int8'
            build()
        elif what == 'SparseUNetV2 training maps':
            model.BACKBONE_3D.NAME = 'SparseUNetV2'
            model.BACKBONE_3D.QWIN = True
            prepare(training=True)
        elif what == 'QWIN':
            model.BACKBONE_3D.QWIN = True
            prepare()
        else:
            model.BACKBONE_3D.NAME = 'SparseUNetV2'
            model.BACKBONE_3D.TABLE_DTYPE = 'int8'
            build()


# the weight gradient's widths and tap counts, each map with a tap that no
# row has (the center) and a tile of rows (64 to 127) without taps
_HOLED_CONV_CASES = [
    (2, 3000, 3000, 27, 16, 16), (2, 3000, 3000, 27, 16, 27), (2, 2000, 2000, 9, 128, 64),
    (1, 1500, 1500, 27, 128, 128), (2, 2000, 2600, 27, 32, 64), (2, 900, 700, 9, 64, 27)]


@pytest.mark.gpu
@pytest.mark.parametrize('B,Vin,Vout,K,Cin,Cout', [
    (2, 300, 77, 27, 8, 8), (1, 5000, 5000, 27, 64, 64), (3, 1000, 1001, 27, 4, 16),
    (2, 900, 700, 3, 64, 128), (2, 301, 1, 3, 5, 3), (2, 640, 640, 27, 7, 100)]
    + _HOLED_CONV_CASES)
def test_sparse_conv_kernel_matches_plain_on_the_card(B, Vin, Vout, K, Cin, Cout):
    """Kernel and plain version each within float32 rounding of a float64
    evaluation (at most K * Cin roundings of the sum of magnitudes), two runs
    of the kernel bit-equal, a row with no present tap exactly zero. The
    weight gradient (Cin 4 to 128, Cout 3 to 128, K 3, 9, 27) within its
    bound, two runs bit-equal, every tap that no row has exactly 0; in the
    holed cases the center tap is absent and rows 64 to 127 have no tap."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    feats, nbr, weight = _sparse_conv_inputs(np.random.RandomState(13), B, Vin, Vout, K, Cin, Cout)
    if (B, Vin, Vout, K, Cin, Cout) in _HOLED_CONV_CASES:
        nbr[:, :, K // 2] = Vin
        nbr[:, 64:128] = Vin
    sc.sparse_conv_cuda.launches = 0
    with torch.no_grad():
        got = dispatch.sparse_conv(feats.cuda(), nbr.cuda(), weight.cuda())
        again = dispatch.sparse_conv(feats.cuda(), nbr.cuda(), weight.cuda())
    torch.cuda.synchronize()
    assert sc.sparse_conv_cuda.launches == 2
    assert torch.equal(got, again)
    assert not got[:, Vout // 2].any()
    exact = sc.sparse_conv_plain(feats.double(), nbr, weight.double())
    mass = sc.sparse_conv_plain(feats.double().abs(), nbr, weight.double().abs())
    tol = K * Cin * 2.0 ** -24 * mass + 1e-30
    assert bool(((got.cpu().double() - exact).abs() <= tol).all())
    assert bool(((sc.sparse_conv_plain(feats, nbr, weight).double() - exact).abs() <= tol).all())
    # the backward: the kernels through the Function, within the rounding
    # bound of a float64 evaluation of each product (the data gradient runs
    # the forward kernel through the map read as its own transpose)
    sc.sparse_conv_wgrad_cuda.launches = 0
    f, w = feats.cuda().requires_grad_(), weight.cuda().requires_grad_()
    dy = torch.from_numpy(np.random.RandomState(15).randn(B, Vout, Cout).astype(np.float32))
    if Vin == Vout:
        dispatch.sparse_conv(f, nbr.cuda(), w, bwd_nbr=nbr.cuda()).backward(dy.cuda())
        want = sc.sparse_conv_dgrad_plain(dy.double(), nbr, weight.double())
        mass = sc.sparse_conv_dgrad_plain(dy.double().abs(), nbr, weight.double().abs())
        assert bool(((f.grad.cpu().double() - want).abs()
                     <= K * Cout * 2.0 ** -24 * mass + 1e-30).all())
    else:
        dispatch.sparse_conv(feats.cuda(), nbr.cuda(), w).backward(dy.cuda())
    torch.cuda.synchronize()
    assert sc.sparse_conv_wgrad_cuda.launches == 1
    want = sc.sparse_conv_wgrad_plain(feats.double(), nbr, dy.double())
    mass = sc.sparse_conv_wgrad_plain(feats.double().abs(), nbr, dy.double().abs())
    assert bool(((w.grad.cpu().double() - want).abs()
                 <= B * Vout * 2.0 ** -24 * mass + 1e-30).all())
    assert torch.equal(w.grad, sc.sparse_conv_wgrad_cuda(feats.cuda(), nbr.cuda(), dy.cuda()))
    absent = ~((nbr >= 0) & (nbr < Vin)).any(dim=(0, 1))
    assert not w.grad.view(K, Cin, Cout)[absent.cuda()].any()


@pytest.mark.gpu
@pytest.mark.parametrize('C,s0,s1', [(96, 0, 96), (37, 3, 22), (40, 8, 24), (37, 36, 37),
                                     (8, 0, 3), (16, 8, 16), (12, 1, 8)])
def test_gather_rows_bf16_kernel_matches_plain_on_the_card(C, s0, s1):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    rng = np.random.RandomState(14)
    feats = torch.from_numpy(rng.randn(3, 501, C).astype(np.float32)).to(torch.bfloat16)
    idx = torch.from_numpy(rng.randint(-3, 504, (3, 2777)))
    group.gather_rows_cuda.launches = group.gather_rows_cuda.launches_bf16 = 0
    got = dispatch.gather_rows(feats.cuda()[..., s0:s1], idx.cuda())
    torch.cuda.synchronize()
    # each entry point has its own count
    assert (group.gather_rows_cuda.launches, group.gather_rows_cuda.launches_bf16) == (0, 1)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.cpu(), group.gather_rows_plain(feats[..., s0:s1], idx))
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        dispatch.gather_rows(feats.cuda().to(torch.float16), idx.cuda())


@pytest.mark.gpu
def test_grouping_gathers_one_cloud_of_a_frame_stack_on_the_card():
    """`dispatch.grouping_operation` on one cloud's frame of a (1, T, N, C)
    stack, MPPNet's crop at B=1: torch calls that slice contiguous, but its
    batch stride is T * N * C; the row gather reads it in place, as the
    plain version does, and gathers the same rows. (It raised at B=1 before
    the gather's batch stride was left unchecked for one cloud.)"""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    rng = np.random.RandomState(6)
    frames = torch.from_numpy(rng.randn(1, 4, 512, 6).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 512, (1, 16, 8)).astype(np.int32))
    for t in range(4):
        got = dispatch.grouping_operation(frames.cuda()[:, t], idx.cuda())
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), dispatch.grouping_operation(frames[:, t], idx))


_STACK = torch.zeros((2, 4, 32, 6))
_SLICE = torch.zeros((2, 32, 10))[..., 2:8]


@pytest.mark.parametrize('features, in_place', [
    (torch.zeros((2, 32, 6)), True),
    (_SLICE, True),                    # a channel slice: rows at the payload's stride
    (_STACK[:1, 1], True),             # one cloud of a frame stack
    (_STACK[:, 1], False),             # two clouds of it: the batch stride is T * N * C
    (torch.zeros((2, 6, 32)).transpose(1, 2), False),
    (torch.zeros((2, 32, 3, 2))[..., 0], False),
])
def test_gather_rows_reads_in_place_only_dense_rows_at_one_stride(features, in_place):
    """The one rule of what the row gather reads as it lies, which
    `dispatch.grouping_operation` copies otherwise and `gather_rows_cuda`
    refuses."""
    assert group.gather_rows_reads_in_place(features) is in_place


@pytest.mark.gpu
def test_fps_kernel_matches_plain_on_the_card():
    """Both paths (a cluster of blocks per cloud and one block per cloud),
    and the plan's own choice, equal the plain version index for index: odd
    N, the flagship shape, picks beyond the cloud's size, a cloud of one
    repeated point and one with duplicated grid points."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    rng = np.random.RandomState(1)
    ties = np.round(rng.rand(2, 3000, 3) * 4).astype(np.float32)
    clouds = [rng.rand(B, N, 3).astype(np.float32) * 50
              for B, N in [(2, 1000), (3, 10007), (8, 16384), (2, 300), (2, 2500)]]
    cases = list(zip(clouds + [np.zeros((3, 512, 3), np.float32), ties],
                     [300, 2000, 4096, 500, 3000, 128, 1000]))
    wrapper = fps.farthest_point_sample_cuda
    launches, cluster, block = wrapper.launches, wrapper.launches_cluster, wrapper.launches_block
    for xyz, npoint in cases:
        x = torch.from_numpy(xyz).cuda()
        B, N, _ = x.shape
        want = plain.farthest_point_sample(x, npoint)
        plans = [None, fps.FpsPlan('block', 1, *fps.block_layout(N)),
                 fps.FpsPlan('cluster', 16, *fps.cluster_layout(N, 16)),
                 fps.FpsPlan('cluster', 4, *fps.cluster_layout(N, 4))]
        for plan in plans:
            got = fps.farthest_point_sample_cuda(x, npoint, plan)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (N, npoint, plan)
    assert wrapper.launches == launches + 4 * len(cases)
    # by path: the block plan once a case, the two cluster plans twice, the
    # plan's own choice on either
    assert wrapper.launches_cluster - cluster >= 2 * len(cases)
    assert wrapper.launches_block - block >= len(cases)
    assert wrapper.launches_cluster - cluster + wrapper.launches_block - block == 4 * len(cases)
    assert fps.plan_for(torch.cuda.current_device(), 8, 16384, 4096).path == 'cluster'


KITTI_PORTED = ['second_iou', 'parta2', 'parta2_sparse', 'pv_rcnn_plusplus',
                'pv_rcnn_plusplus_sparse']
# the files `Detector3D` assembles, by their parameter count (the JAX
# package's `jax.eval_shape` of its init counts the same)
DETECTOR3D_PORTED = {'dsvt': 605899, 'transfusion': 1583694}
# the MPPNet files, by their parameter count (the JAX package's
# `jax.eval_shape` of its init counts the same)
MPPNET_PORTED = {'waymo_models/mppnet_16frame': 7389143, 'waymo_models/mppnet_mini': 4936515}
# the BEVFusion files, by their parameter count (the JAX package's
# `jax.eval_shape` of its init: `bevfusion_mini.yaml` as shipped,
# `bevfusion.yaml` with `synthetic.bevfusion_grid`, which changes no width)
BEVFUSION_PORTED = {'nuscenes_models/bevfusion': 36755122,
                    'nuscenes_models/bevfusion_mini': 1440207}
# every config of the repo builds in the port
STILL_RAISING = []


@pytest.mark.parametrize('name', KITTI_PORTED + list(DETECTOR3D_PORTED) + list(MPPNET_PORTED)
                         + list(BEVFUSION_PORTED) + STILL_RAISING)
def test_configs_build_or_name_their_roadmap_item(name, monkeypatch):
    """The five KITTI files of the two-stage family's rest, DSVT and
    TransFusion (`Detector3D` with its window-attention backbone or its
    query head), the two MPPNet files and the two BEVFusion files, each of
    the last six at its parameter count, build through `build_detector` as
    shipped (on the meta device: the modules, no storage)."""
    from pdm_ssd_torch.models.detectors import build_detector
    from pdm_ssd_torch.utils import config as t_config
    monkeypatch.chdir(REPO)
    path = f'configs/{name}.yaml' if '/' in name else f'configs/kitti_models/{name}.yaml'
    cfg = t_config.cfg_from_yaml_file(path, t_config.CfgNode())
    if name in KITTI_PORTED:
        net = build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device='meta')
        assert type(net).__name__ == cfg.MODEL.NAME
        assert sum(p.numel() for p in net.parameters()) > 1e6
    elif name in DETECTOR3D_PORTED or name in MPPNET_PORTED or name in BEVFUSION_PORTED:
        net = build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG,
                             class_names=cfg.CLASS_NAMES, device='meta')
        want = {**DETECTOR3D_PORTED, **MPPNET_PORTED, **BEVFUSION_PORTED}[name]
        assert type(net).__name__ == ('MPPNet' if name in MPPNET_PORTED else 'BevFusion'
                                      if name in BEVFUSION_PORTED else 'Detector3D')
        assert sum(p.numel() for p in net.parameters()) == want
    else:
        with pytest.raises(NotImplementedError, match='ROADMAP Queue 1 item 12'):
            build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device='meta')


def test_detector3d_names_roadmap_queue_1_for_an_unported_slot(monkeypatch):
    """A `Detector3D` whose dense head or BEV backbone the port does not have
    (an unknown name on SECOND's ladder) raises `NotImplementedError`
    naming the slot, the name and ROADMAP Queue 1."""
    from pdm_ssd_torch.models.detectors import build_detector
    from pdm_ssd_torch.utils import config as t_config
    monkeypatch.chdir(REPO)
    cfg = t_config.cfg_from_yaml_file('configs/kitti_models/second_sparse.yaml',
                                      t_config.CfgNode())
    cfg.MODEL.DENSE_HEAD.NAME = 'NoSuchHead'
    with pytest.raises(NotImplementedError, match='DENSE_HEAD NoSuchHead .*ROADMAP Queue 1'):
        build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device='meta')
    cfg = t_config.cfg_from_yaml_file('configs/kitti_models/dsvt.yaml', t_config.CfgNode())
    cfg.MODEL.BACKBONE_2D.NAME = 'NoSuchBackbone'
    with pytest.raises(NotImplementedError, match='BACKBONE_2D NoSuchBackbone .*ROADMAP Queue 1'):
        build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device='meta')


def test_pdm_ssd_nuscenes_builds_and_its_dataset_reads_generated_infos(tmp_path, monkeypatch):
    """`pdm_ssd_nuscenes.yaml`'s model builds as shipped, and its dataset,
    pointed at a mini set generated by the port's tool, gives a batch of
    163840 points of 5 features (a key frame and its past sweeps sampled with
    replacement, each sweep's time lag in the fifth column) with its ground
    truth and each sample's token."""
    from pdm_ssd_torch.datasets import build_dataloader
    from pdm_ssd_torch.models.detectors import build_detector
    from pdm_ssd_torch.tools import make_mini_nuscenes
    from pdm_ssd_torch.utils import config as t_config
    monkeypatch.chdir(REPO)
    cfg = t_config.cfg_from_yaml_file('configs/nuscenes_models/pdm_ssd_nuscenes.yaml',
                                      t_config.CfgNode())
    net = build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG,
                         class_names=cfg.CLASS_NAMES, device='meta')
    assert sum(p.numel() for p in net.parameters()) > 1e6
    make_mini_nuscenes.main(['--root', str(tmp_path), '--samples', '3', '--max_sweeps', '10'])
    t_config.cfg_from_list(['DATA_CONFIG.DATA_PATH', str(tmp_path), 'DATA_CONFIG.VERSION', "''",
                            'DATA_CONFIG.INFO_PATH',
                            "{'test': ['nuscenes_infos_10sweeps_train.pkl']}"], cfg)
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=0,
                                     training=False)
    batch = next(iter(loader))
    assert len(ds) == 3 and batch['points'].shape == (2, 163840, 5)
    # the first frame has no past sweep, the second one, 0.5 s before it
    assert set(np.unique(batch['points'][0, :, 4])) == {0.0}
    assert set(np.unique(batch['points'][1, :, 4])) == {0.0, 0.5}
    assert batch['gt_mask'].sum(1).tolist() == [1, 1] and batch['gt_boxes'].shape[-1] == 8
    assert [m['token'] for m in batch['metadata']] == ['s0', 's1']


@pytest.mark.parametrize('name', ['mppnet_mini', 'mppnet_16frame'])
def test_waymo_configs_build_their_loader_on_a_generated_set(name, tmp_path, monkeypatch):
    """`build_dataloader` builds `WaymoDataset` for both MPPNet files, pointed
    at a mini-Waymo set generated by the port's tool (8 frames), and gives a
    batch of the files' frame stacks: 4 frames of 512 points and the offline
    proposals of `mppnet_mini.yaml`; 16 frames of 16384 points of
    `mppnet_16frame.yaml` (USE_PREDBOX off, as shipped), and no voxels
    (ROADMAP Queue 3)."""
    from pdm_ssd_torch.datasets import build_dataloader
    from pdm_ssd_torch.tools import make_mini_waymo
    from pdm_ssd_torch.utils import config as t_config
    monkeypatch.chdir(REPO)
    cfg = t_config.cfg_from_yaml_file(f'configs/waymo_models/{name}.yaml', t_config.CfgNode())
    make_mini_waymo.main(['--root', str(tmp_path), '--frames', '8', '--n_bg', '500'])
    t_config.cfg_from_list(['DATA_CONFIG.DATA_PATH', str(tmp_path)], cfg)
    if cfg.DATA_CONFIG.USE_PREDBOX:
        cfg.DATA_CONFIG.ROI_BOXES_PATH.test = str(tmp_path / 'pred_boxes.pkl')
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=0,
                                     training=False)
    batch = next(iter(loader))
    T, n = (4, 512) if name == 'mppnet_mini' else (16, 16384)
    assert len(ds) == 8 and batch['points_multi_frame'].shape == (2, T, n, 6)
    assert batch['poses'].shape == (2, T, 4, 4)
    assert ('roi_boxes' in batch) == (name == 'mppnet_mini')
    assert ('voxels' in batch) == (name == 'mppnet_mini')
    assert list(batch['frame_id']) == ['segment_000_000', 'segment_000_001']


UNPORTED_DATASETS = ['CustomDataset', 'ONCEDataset', 'LyftDataset', 'PandasetDataset',
                     'Argo2Dataset']


@pytest.mark.parametrize('what', UNPORTED_DATASETS + ['CAMERA_CONFIG', 'with_cams'])
def test_unported_datasets_and_the_nuscenes_camera_half_name_their_roadmap_item(what, tmp_path,
                                                                                 monkeypatch):
    """The other five datasets raise `NotImplementedError` naming ROADMAP
    Queue 1 item 13. nuScenes' camera half is ported: the generator writes
    the CAM_FRONT stream's PNGs, and `bevfusion_mini.yaml`'s dataset (with
    CAMERA_CONFIG) reads them into a batch of camera tensors."""
    from pdm_ssd_torch.datasets import build_dataloader
    from pdm_ssd_torch.datasets.nuscenes import synthetic as nus_synthetic
    from pdm_ssd_torch.utils import config as t_config
    monkeypatch.chdir(REPO)
    if what == 'with_cams':
        nus_synthetic.write_tables(tmp_path, with_cams=True)
        assert len(list((tmp_path / 'samples').glob('cam_front_*.png'))) == 3
        return
    if what == 'CAMERA_CONFIG':
        cfg = t_config.cfg_from_yaml_file('configs/nuscenes_models/bevfusion_mini.yaml',
                                          t_config.CfgNode())
        nus_synthetic.make_mini_nuscenes(tmp_path, with_cams=True)
        t_config.cfg_from_list(['DATA_CONFIG.DATA_PATH', str(tmp_path)], cfg)
        _, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=0,
                                        training=False)
        batch = next(iter(loader))
        assert batch['camera_imgs'].shape == (2, 1, 64, 96, 3)
        assert batch['camera_depth'].shape == (2, 1, 64, 96, 1)
        assert batch['img_aug_matrix'].shape == (2, 1, 4, 4)
        return
    cfg = t_config.cfg_from_yaml_file('configs/nuscenes_models/pdm_ssd_nuscenes.yaml',
                                      t_config.CfgNode())
    ds_cfg = cfg.DATA_CONFIG
    ds_cfg.DATASET = what
    with pytest.raises(NotImplementedError, match='ROADMAP Queue 1 item 13'):
        build_dataloader(ds_cfg, cfg.CLASS_NAMES, 1, root_path=tmp_path, workers=0)


def _masked_fps_cases(rng):
    """(xyz (B, N, 3), mask (B * G, N), npoint) cases of the masked FPS: G
    masks a cloud, rows with no valid point, with fewer valid points than
    picks (the tail picks the lowest valid index), with one valid point, and
    PV-RCNN++'s shape (6 sectors a cloud, 2048 picks of 16384 points)."""
    cases = []
    for B, N, G, npoint in [(2, 1000, 3, 300), (2, 10007, 2, 700), (1, 16384, 6, 2048),
                            (4, 300, 1, 400)]:
        xyz = rng.rand(B, N, 3).astype(np.float32) * 50
        mask = rng.rand(B * G, N) < rng.uniform(0.02, 0.6, (B * G, 1))
        mask[0] = False                     # no valid point
        mask[-1] = False
        mask[-1, [N // 3, N - 1]] = True    # two valid points, far fewer than the picks
        cases.append((xyz, mask, npoint))
    return cases


def test_cpu_masked_fps_dispatch_runs_the_plain_version_per_row():
    """On CPU tensors the masked FPS of G masks a cloud is the plain masked
    FPS of each mask over its cloud's coordinates, and launches nothing."""
    rng = np.random.RandomState(3)
    fps.farthest_point_sample_cuda.launches = 0
    cases = _masked_fps_cases(rng)
    for xyz, mask, npoint in cases[:2] + cases[3:]:      # the plain loop at (6, 16384) is slow
        x, m = torch.from_numpy(xyz), torch.from_numpy(mask)
        G = m.shape[0] // x.shape[0]
        got = dispatch.farthest_point_sample(x, npoint, mask=m)
        want = torch.cat([plain.farthest_point_sample(x[r // G:r // G + 1], npoint,
                                                      mask=m[r:r + 1])
                          for r in range(m.shape[0])])
        assert torch.equal(got, want)
        assert torch.equal(got[0], torch.zeros(npoint, dtype=torch.int32))
        tail = got[-1, 2:]
        assert torch.equal(tail, torch.full_like(tail, int(m[-1].nonzero()[0])))
    assert fps.farthest_point_sample_cuda.launches == 0


@pytest.mark.gpu
def test_masked_fps_kernel_matches_plain_on_the_card():
    """The masked kernel on both paths (and the plan's own choice) equal to
    the plain masked version index for index, with several masks a cloud in
    one launch; `sector_fps` on the card equal to the CPU's; the unmasked
    path unchanged beside it."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    rng = np.random.RandomState(4)
    wrapper = fps.farthest_point_sample_cuda
    launches, masked = wrapper.launches, wrapper.launches_masked
    n = 0
    cases = _masked_fps_cases(rng)
    for xyz, mask, npoint in cases:
        x, m = torch.from_numpy(xyz).cuda(), torch.from_numpy(mask).cuda()
        N = x.shape[1]
        G = m.shape[0] // x.shape[0]
        want = plain.farthest_point_sample(x.repeat_interleave(G, dim=0), npoint, mask=m)
        plans = [None, fps.FpsPlan('block', 1, *fps.block_layout(N)),
                 fps.FpsPlan('cluster', 4, *fps.cluster_layout(N, 4))]
        if fps.cluster_layout(N, 16) is not None and N >= 4096:
            plans.append(fps.FpsPlan('cluster', 16, *fps.cluster_layout(N, 16)))
        for plan in plans:
            got = wrapper(x, npoint, plan, mask=m)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (N, G, npoint, plan)
            n += 1
        unmasked = wrapper(x, npoint)
        assert torch.equal(unmasked, plain.farthest_point_sample(x, npoint))
    assert wrapper.launches - launches == n + len(cases)
    assert wrapper.launches_masked - masked == n
    xyz = torch.from_numpy(rng.uniform(-30, 30, (2, 4000, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.rand(2, 4000) < 0.4)
    valid[1, xyz[1, :, 1] < 0] = False      # empty sectors
    want = plain.sector_fps(xyz, valid, 512, 6, per_sector_cap=512)
    got = plain.sector_fps(xyz.cuda(), valid.cuda(), 512, 6, per_sector_cap=512)
    assert torch.equal(got.cpu(), want)


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
@pytest.mark.parametrize('cap,nsamples', [(32, (16, 32)), (4, (8, 16)), (20, (5, 70, 3)),
                                          (64, (40, 64)), (32, (128, 128, 1)),
                                          (32, (256, 320, 128))])
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
@pytest.mark.parametrize('C,s0,s1', [(1, 0, 1), (64, 0, 64), (128, 64, 128), (37, 3, 22),
                                     (4, 0, 3), (5, 3, 5), (8, 1, 5), (96, 0, 96),
                                     (300, 0, 256), (37, 36, 37), (37, 0, 37), (128, 0, 128)])
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
    # random indices, then runs as the selection lays them out: 16 slots a
    # center, a few hits each, the first hit repeated
    runs = np.repeat(rng.randint(-1, N, (B, R // 16 + 1)), 16, -1)[:, :R]
    runs[:, 5::16] = rng.randint(0, N, (B, runs[:, 5::16].shape[1]))
    for rows in (idx, torch.from_numpy(runs.astype(np.int64))):
        back = dispatch.scatter_add_rows(vals.cuda(), rows.cuda(), N)
        torch.cuda.synchronize()
        want = group.scatter_add_rows_plain(vals.double(), rows, N)
        # float32 sums of ~R/N = 6 terms of unit scale in any order, held
        # against a float64 sum: a few ulp of the largest partial sum
        torch.testing.assert_close(back.cpu().double(), want, rtol=0, atol=1e-5)


def _ball_query_inputs(rng, B, N, M):
    """Duplicated points, centers far outside the cloud (empty balls) and a
    mask: CPU tensors (xyz, new_xyz, mask)."""
    xyz = rng.uniform(0, 8, (B, N, 3)).astype(np.float32)
    xyz[:, N // 2: N // 2 + N // 5] = xyz[:, :N // 5]
    new_xyz = xyz[:, :M].copy()
    new_xyz[:, :5] += 100.0
    return torch.from_numpy(xyz), torch.from_numpy(new_xyz), torch.from_numpy(rng.rand(B, N) < 0.8)


@pytest.mark.gpu
@pytest.mark.parametrize('B,N,M,radii,nsamples', [
    (3, 3001, 333, (0.5, 1.3, 0.9), (5, 70, 3)), (2, 16384, 4096, (0.2, 0.8), (16, 32)),
    (50, 512, 128, (0.2,), (16,)), (7, 20, 9, (3.0, 50.0), (4, 33))])
def test_ball_query_kernel_matches_plain_on_the_card(B, N, M, radii, nsamples):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    xyz, new_xyz, mask = _ball_query_inputs(np.random.RandomState(6), B, N, M)
    for m in (None, mask):
        got = dispatch.ball_query_level(radii, nsamples, xyz.cuda(), new_xyz.cuda(),
                                        None if m is None else m.cuda())
        torch.cuda.synchronize()
        for r, k, g in zip(radii, nsamples, got):
            want = plain.ball_query(r, k, xyz, new_xyz, mask=m)
            assert (want[:, :5] == 0).all()
            assert torch.equal(g.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize('width,c0,c1,n0', [(4, 0, 3, 0), (4, 3, 4, 0), (5, 0, 3, 0),
                                            (128, 0, 128, 0), (4, 0, 3, 77)])
def test_grouping_operation_kernel_matches_plain_on_strided_views(width, c0, c1, n0):
    """`dispatch.grouping_operation` on a channel slice of a wider tensor (the
    kernel reads at the row stride) and on a slice of the points (a dense
    copy first) equals the plain gather, exactly."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    rng = np.random.RandomState(8)
    B, N, M, K = 3, 501, 40, 7
    wide = torch.from_numpy(rng.randn(B, N, width).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, N - n0, (B, M, K)).astype(np.int32))
    group.gather_rows_cuda.launches = 0
    got = dispatch.grouping_operation(wide.cuda()[:, n0:, c0:c1], idx.cuda())
    torch.cuda.synchronize()
    assert group.gather_rows_cuda.launches == 1
    assert torch.equal(got.cpu(), plain.grouping_operation(wide[:, n0:, c0:c1], idx))
