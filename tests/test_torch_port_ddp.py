"""Data parallelism of the port (`pdm_ssd_torch/parallel`) on the CPU: two
gloo ranks, each on half of a global batch, against one process over all of
it, and that one process against the JAX package's step on its 8-device
mesh (`tests/test_syncbn.py`, `tests/test_train_multichip.py`).

One pair of ranks runs every case of `torch_port_ddp_cases` (started by the
`launched` fixture, read by `ranks`) while this process computes the same
cases over the whole batch and the JAX side:

- BatchNorm: `BatchNormLast` and `MaskedBatchNorm` (two clouds without an
  active slot) against flax's BatchNorm and the JAX package's
  `MaskedBatchNorm` on the mesh: outputs, input gradients, running
  statistics.
- Training steps in float64, where the ranks' step must equal one process's
  up to the order of float64 sums: the tiny flagship at B=8, its PDM-SSD
  siblings, and the tiny sparse SECOND (transposed maps), Voxel R-CNN and
  Part-A2 on the sparse ladder and UNet (the ROI heads' target draw
  included): loss, metrics,
  every gradient, BatchNorm buffers, parameters after the Adam update. The
  one-process flagship loss in float32 against the JAX package's mesh step.
- Evaluation sharded over the ranks (a 7-frame mini-KITTI set, so one rank
  takes a wrap-around sample): the same detections per frame and metrics.
- The samplers, the ROI draw's rows, the refusal of detectors whose
  statistics or normalisers are not held, and the train and test CLIs with
  `--launcher pytorch` in the ranks' group.
"""
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pdm_ssd_torch.parallel import ddp
from pdm_ssd_torch.tools.make_mini_kitti import make as make_mini_kitti
from pdm_ssd_tpu.parallel import make_mesh, replicate, shard_batch

import torch_port_ddp_cases as cases
from torch_port_harness import (FlagshipPair, jax_bf16_extraction, one_torch_thread,  # noqa: F401
                                port_loss_and_grads)

# the ranks' whole run (spawn, imports, every case) must end within this
RANKS_TIMEOUT_S = 240
# two ranks against one process in float64: the same sums in another order
F64_RTOL = 1e-9
# BatchNorm of the port against flax's on the mesh, float32
# (`tests/test_syncbn.py`'s bounds)
BN_TOL = 1e-5
# the one-process flagship loss (the JAX package's bf16 extraction emulated)
# against its 8-device step, as `test_torch_port_train.py` holds the loss
# against its one-device step
JAX_LOSS_RTOL = 5e-4
# detections of a frame under two ranks against one process: the same
# predict on other batch-mates, float32
DET_ATOL = 1e-5


@pytest.fixture(scope='module')
def pair():
    return FlagshipPair(B=8, N=512, seed=0, jax_init=False)


@pytest.fixture(scope='module')
def launched(pair, tmp_path_factory):
    """The pair of ranks, started on what they read: the flagship's weights
    and batch, and a 7-frame mini-KITTI set."""
    tmp = tmp_path_factory.mktemp('ddp')
    torch.save({'cfg': pair.cfg.to_dict(), 'state': pair.net.state_dict(),
                'batch': pair.batch}, tmp / 'flagship.pt')
    make_mini_kitti(tmp / 'kitti', frames=cases.EVAL_FRAMES, n_bg=2000)
    cfg = cases.eval_cfg(tmp / 'kitti').to_dict()
    for k in ('TAG', 'EXP_GROUP_PATH'):
        cfg.pop(k)
    (tmp / 'tiny_flagship.yaml').write_text(yaml.safe_dump(cfg))
    ctx = ddp.spawn(cases.run_ranks, 2, device='cpu', backend='gloo', args=(str(tmp),),
                    threads=1, join=False)
    yield tmp, ctx
    for p in ctx.processes:
        if p.is_alive():
            p.terminate()
            p.join(10)


@pytest.fixture(scope='module')
def ranks(launched):
    tmp, ctx = launched
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            pytest.fail(f'the two ranks did not end within {RANKS_TIMEOUT_S} s')
    out = []
    for r in range(2):
        with open(tmp / f'rank{r}.pkl', 'rb') as f:
            out.append(pickle.load(f))
    assert [o['world'] for o in out] == [2, 2]
    return out


# ---- the JAX side (while the ranks run) ---------------------------------------

def jax_bn(kind: str) -> dict:
    """flax's BatchNorm ('last') or the JAX package's `MaskedBatchNorm` in
    training mode on the 8-device mesh, the batch sharded: output, the
    gradient of sum(y * g) in the input, running statistics."""
    import flax.linen as nn
    from pdm_ssd_tpu.models.backbones_3d.sparse_backbone import MaskedBatchNorm
    a = cases.bn_inputs()
    variables = {'params': {'scale': a['scale'], 'bias': a['bias']},
                 'batch_stats': {'mean': a['mean'], 'var': a['var']}}
    if kind == 'last':
        module, data = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5), \
            {'x': a['x'], 'g': a['g']}
    else:
        module, data = MaskedBatchNorm(), {'x': a['xm'], 'g': a['gm'], 'mask': a['mask']}

    def run(v, b):
        def loss(x):
            args = (x, b['mask'], True) if 'mask' in b else (x,)
            y, mut = module.apply(v, *args, mutable=['batch_stats'])
            return jnp.sum(y * b['g']), (y, mut['batch_stats'])
        (_, (y, stats)), dx = jax.value_and_grad(loss, has_aux=True)(b['x'])
        return y, dx, stats

    mesh = make_mesh()
    assert mesh.devices.size == 8
    y, dx, stats = jax.jit(run)(replicate(variables, mesh), shard_batch(data, mesh))
    return {'y': np.asarray(y), 'dx': np.asarray(dx), 'mean': np.asarray(stats['mean']),
            'var': np.asarray(stats['var'])}


@pytest.mark.parametrize('kind', ['last', 'masked'])
def test_batchnorm_of_one_process_equals_the_jax_mesh(kind, launched):
    got = cases.bn_case()[kind]
    want = jax_bn(kind)
    for k in ('y', 'dx', 'mean', 'var'):
        np.testing.assert_allclose(got[k], want[k], rtol=BN_TOL, atol=BN_TOL, err_msg=k)
    if kind == 'masked':
        assert (got['y'][6:] == 0).all() and (got['dx'][6:] == 0).all()


def test_flagship_one_process_loss_equals_the_jax_mesh_step(pair, launched):
    """`__graft_entry__._flagship(tiny=True)` on `_make_batch(B=8, N=512)`,
    as `test_point_exact_flagship_multichip_parity` builds them: the port's
    loss and each term against the JAX package's training forward and loss
    with the batch sharded over its 8 devices."""
    def loss_fn(module, b):
        return module.get_training_loss(module(b, training=True))

    mesh = make_mesh()
    (loss, tb), _ = jax.jit(lambda v, b: pair.jax_model.apply(
        v, b, mutable=['batch_stats'], method=loss_fn))(replicate(pair.variables, mesh),
                                                        shard_batch(pair.batch, mesh))
    with jax_bf16_extraction():
        got, got_tb, _, _ = port_loss_and_grads(pair, pair.torch_batch())
    np.testing.assert_allclose(got, float(loss), rtol=JAX_LOSS_RTOL)
    for k, v in tb.items():
        np.testing.assert_allclose(got_tb[k], float(v), rtol=JAX_LOSS_RTOL, err_msg=k)


# ---- two ranks against one process ----------------------------------------------

@pytest.mark.parametrize('kind', ['last', 'masked'])
def test_batchnorm_statistics_of_two_ranks_are_the_global_batch(kind, ranks):
    want = cases.bn_case()[kind]
    got = [r['bn'][kind] for r in ranks]
    for k in ('y', 'dx'):
        np.testing.assert_allclose(np.concatenate([g[k] for g in got]), want[k], rtol=BN_TOL,
                                   atol=BN_TOL, err_msg=k)
    for g in got:
        for k in ('mean', 'var'):
            np.testing.assert_allclose(g[k], want[k], rtol=BN_TOL, atol=BN_TOL, err_msg=k)


def assert_same_step(got: dict, want: dict) -> None:
    """A rank's step against one process's: every metric, every gradient
    (each parameter has one), the state after the update."""
    assert got['tb'].keys() == want['tb'].keys()
    for k, v in want['tb'].items():
        np.testing.assert_allclose(got['tb'][k], v, rtol=F64_RTOL, atol=1e-12, err_msg=k)
    assert got['grads'].keys() == want['grads'].keys() == set(want['params'])
    for k, g in want['grads'].items():
        scale = max(float(g.abs().max()), 1e-30)
        np.testing.assert_allclose(got['grads'][k].numpy(), g.numpy(), rtol=0,
                                   atol=F64_RTOL * scale, err_msg=k)
    for k, v in want['state'].items():
        assert got['state'][k].dtype == v.dtype, k
        np.testing.assert_allclose(got['state'][k].numpy(), v.numpy(), rtol=F64_RTOL,
                                   atol=1e-12, err_msg=k)


def test_flagship_step_of_two_ranks_equals_one_process(ranks, launched):
    tmp, _ = launched
    want = cases.flagship_case(tmp)
    for r in ranks:
        assert_same_step(r['flagship'], want)


@pytest.mark.parametrize('name', cases.SPARSE)
def test_sparse_family_step_of_two_ranks_equals_one_process(name, ranks):
    want = cases.sparse_case(name)
    assert want['tb']['loss'] > 0
    for r in ranks:
        assert_same_step(r[name], want)


@pytest.mark.parametrize('cfg_file', cases.SIBLINGS)
def test_pdm_sibling_step_of_two_ranks_equals_one_process(cfg_file, ranks):
    """The grid PDM-SSD, its aux and large variants and the nuScenes file:
    the flagship's family trains on two ranks as in one process too."""
    want = cases.sibling_case(cfg_file)
    for r in ranks:
        assert_same_step(r[cfg_file], want)


def test_roi_target_draw_of_two_ranks_is_one_process_draw(ranks):
    want = cases.draw_case()
    assert want.shape == (4, 5)
    torch.testing.assert_close(torch.cat([r['draw'] for r in ranks]), want, rtol=0, atol=0)


def test_sharded_eval_gives_one_process_detections_and_metrics(ranks, launched, tmp_path):
    """Seven frames over two ranks at two a batch: rank 1's last batch holds
    frame 0 again as padding, which no count or detection may include."""
    tmp, _ = launched
    want = cases.eval_case(tmp / 'kitti', tmp_path)
    got = ranks[0]['eval']
    assert len(want['annos']) == len(got['annos']) == cases.EVAL_FRAMES
    assert ranks[1]['eval']['ret'] == got['ret']
    n_boxes = 0
    for g, w in zip(got['annos'], want['annos']):
        assert g['frame_id'] == w['frame_id']
        assert list(g['name']) == list(w['name']), w['frame_id']
        np.testing.assert_allclose(g['boxes_lidar'], w['boxes_lidar'], rtol=0, atol=DET_ATOL)
        np.testing.assert_allclose(g['score'], w['score'], rtol=0, atol=DET_ATOL)
        n_boxes += len(w['name'])
    assert n_boxes > 0
    assert got['ret'].keys() == want['ret'].keys()
    assert any(k.endswith('_R40') for k in want['ret'])
    for k, v in want['ret'].items():
        if not k.endswith('_fps'):
            np.testing.assert_allclose(got['ret'][k], v, rtol=0, atol=1e-6, err_msg=k)


def test_samplers_cover_the_set_once(ranks):
    n = cases.EVAL_FRAMES
    train = [r['sampler']['epochs'] for r in ranks]
    for epoch in (0, 1):
        seen = train[0][epoch] + train[1][epoch]
        # each rank 3 samples: the last partial share dropped, none twice
        assert len(train[0][epoch]) == len(train[1][epoch]) == n // 2
        assert len(set(seen)) == len(seen) and set(seen) <= set(range(n))
        assert all(r['sampler']['batches'] == n // 2 for r in ranks)
    assert train[0][0] + train[1][0] != train[0][1] + train[1][1]   # reshuffled each epoch
    ev = [r['sampler']['eval'] for r in ranks]
    assert ev[0] == ddp.shard_indices(n, 0, 2) == [0, 2, 4, 6]
    assert ev[1] == ddp.shard_indices(n, 1, 2) == [1, 3, 5, 0]
    merged = [r['sampler']['merged'] for r in ranks]
    assert all(r['sampler']['merged_len'] == 3 * n for r in ranks)
    assert all(r['sampler']['merged_batches'] == 3 * n // 2 for r in ranks)
    assert len(set(merged[0] + merged[1])) == 2 * (3 * n // 2)


def test_unheld_detectors_refuse_two_ranks(ranks):
    for r in ranks:
        for name, msg in r['refusal'].items():
            assert msg is not None, name
            assert 'not held' in msg and ddp.NOT_HELD_ITEM in msg, msg


@pytest.mark.parametrize('name,held', [
    ('pdm_ssd_point', True), ('pdm_ssd', True), ('second_sparse', True),
    ('voxel_rcnn_sparse', True), ('parta2_sparse', True), ('second', False),
    ('voxel_rcnn', False), ('parta2', False), ('pv_rcnn_sparse', False), ('pointrcnn', False)])
def test_detector_classes_declare_what_data_parallelism_holds(name, held):
    """`check_held` reads the detector class's `DATA_PARALLEL_HELD` and the
    config's BACKBONE_3D: the four held families pass, the same classes on
    another backbone and the other detectors raise, naming the ROADMAP item
    (the shipped file built on the meta device, no process group)."""
    from pdm_ssd_torch.models.detectors import build_detector
    from pdm_ssd_torch.utils import synthetic
    with cases.in_repo():
        cfg = synthetic.load_cfg(f'configs/kitti_models/{name}.yaml')
    net = build_detector(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG,
                         class_names=cfg.CLASS_NAMES, device='meta')
    if held:
        ddp.check_held(net)
    else:
        with pytest.raises(NotImplementedError, match=ddp.NOT_HELD_ITEM):
            ddp.check_held(net)


def test_train_and_test_clis_under_the_pytorch_launcher(ranks):
    """`tools.train` then `tools.test --launcher pytorch` in the ranks' group:
    one checkpoint (rank 0 writes it) and one log each (rank 0 logs), every
    rank the same evaluation of the set's 7 frames, the group kept up."""
    got = [r['clis'] for r in ranks]
    for g in got:
        assert g['ckpts'] == ['checkpoint_epoch_1.pth']
        assert g['logs'] == ['eval', 'train'] and g['group_kept']
    assert got[0]['ret'] == got[1]['ret']
    assert 0 <= got[0]['ret']['recall/rcnn_0.3'] <= 1
    assert any(k.endswith('_R40') for k in got[0]['ret'])


def test_helpers_are_the_identity_without_a_group():
    assert not ddp.is_initialized() and ddp.world_size() == 1 and ddp.rank() == 0
    t = torch.arange(3.0)
    assert ddp.global_sum(t) is t and ddp.sync_sum(t) is t
    net = torch.nn.Linear(2, 2)
    assert ddp.wrap_model(net) is net and ddp.unwrap(net) is net
    gen = torch.Generator().manual_seed(3)
    torch.testing.assert_close(ddp.rank_rows(torch.rand, 2, 3, generator=gen),
                               torch.rand((2, 3), generator=torch.Generator().manual_seed(3)))
    assert ddp.gather_to_rank0('x') == ['x'] and ddp.broadcast_from_rank0('x') == 'x'
    assert ddp.shard_indices(5) == list(range(5)) and ddp.padded_size(5) == 5
    assert ddp.padded_size(5, 4) == 8 and ddp.shard_indices(5, 3, 4) == [3, 2]
