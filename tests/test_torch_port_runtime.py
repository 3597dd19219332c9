"""The runtime's edges of the port on the CPU: the batch prefetch
(`runtime/prefetch.py`, the contract of the JAX package's
`tests/test_prefetch.py`), the epoch hooks and the pretrained overlay (its
`tests/test_hooks_pretrained.py`), the CLIs' flags (`--pretrained_model`,
`--fix_random_seed`, `--merge_all_iters_to_one_epoch`, `--profile`, a
config's HOOK; `--ckpt_step`, `--eval_all`, `--max_waiting_mins`,
`--matmul_precision`), the demo, and `dryrun --nprocs 2 --device cpu` (its
one pair of gloo ranks). The CLIs run in this process on the tiny flagship
over a 3-frame mini-KITTI set; no JAX here."""
import logging
import pickle
import sys
import time

import numpy as np
import pytest
import torch
import yaml

from pdm_ssd_torch.models import build_network
from pdm_ssd_torch.runtime import trainer
from pdm_ssd_torch.runtime.hooks import apply_epoch_hooks
from pdm_ssd_torch.runtime.prefetch import prefetch_batches
from pdm_ssd_torch.tools import cli_common, demo, dryrun
from pdm_ssd_torch.tools import test as test_cli
from pdm_ssd_torch.tools import train as train_cli
from pdm_ssd_torch.tools.make_mini_kitti import make as make_mini_kitti
from pdm_ssd_torch.utils.config import CfgNode

import torch_port_ddp_cases as cases
from torch_port_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


# ---- prefetch -------------------------------------------------------------------

def test_prefetch_order_and_values():
    batches = [{'i': i} for i in range(7)]
    got = list(prefetch_batches(batches, lambda b: {'i': b['i'] * 10}))
    assert [b['i'] for b in got] == [i * 10 for i in range(7)]


def test_prefetch_passthrough_without_prepare():
    batches = [{'i': i} for i in range(3)]
    got = list(prefetch_batches(batches, None))
    assert got == batches and got[0] is batches[0]      # no thread, the same objects


def test_prefetch_propagates_prepare_error():
    def bad(b):
        if b['i'] == 2:
            raise ValueError('boom')
        return b

    it = prefetch_batches(({'i': i} for i in range(5)), bad)
    assert next(it)['i'] == 0
    with pytest.raises(ValueError, match='boom'):
        list(it)


def test_prefetch_overlaps_slow_prepare():
    """prepare(i + 1) runs during consume(i): about n * max(prepare,
    consume), not n * (prepare + consume)."""
    prep_s, consume_s, n = 0.03, 0.03, 8

    def prep(b):
        time.sleep(prep_s)
        return b

    t0 = time.perf_counter()
    for _ in prefetch_batches([{'i': i} for i in range(n)], prep):
        time.sleep(consume_s)
    elapsed = time.perf_counter() - t0
    serial = n * (prep_s + consume_s)
    assert elapsed < serial * 0.85, f'{elapsed:.3f}s vs serial {serial:.3f}s'


# ---- hooks and the pretrained overlay ----------------------------------------------

class FakeAugmentor:
    def __init__(self):
        self.disabled_with = None

    def disable_augmentation(self, cfg):
        self.disabled_with = list(cfg['DISABLE_AUG_LIST'])


class FakeDataset:
    def __init__(self):
        self.data_augmentor = FakeAugmentor()
        self.dataset_cfg = CfgNode({'DATA_AUGMENTOR': {'DISABLE_AUG_LIST': ['placeholder'],
                                                       'AUG_CONFIG_LIST': []}})


def test_disable_augmentation_hook_fires_only_in_last_epochs():
    hook_cfg = CfgNode({'DisableAugmentationHook': {'DISABLE_AUG_LIST': ['gt_sampling'],
                                                    'NUM_LAST_EPOCHS': 2}})
    ds = FakeDataset()
    apply_epoch_hooks(None, ds, cur_epoch=9, total_epochs=10)
    apply_epoch_hooks(hook_cfg, ds, cur_epoch=7, total_epochs=10)
    assert ds.data_augmentor.disabled_with is None
    apply_epoch_hooks(hook_cfg, ds, cur_epoch=8, total_epochs=10)
    assert ds.data_augmentor.disabled_with == ['gt_sampling']


@pytest.fixture(scope='module')
def mini(tmp_path_factory):
    """A 3-frame mini-KITTI set and a YAML of the tiny flagship on it."""
    base = tmp_path_factory.mktemp('runtime')
    root = make_mini_kitti(base / 'kitti', frames=3, n_bg=2000)
    cfg = cases.eval_cfg(root).to_dict()
    for k in ('TAG', 'EXP_GROUP_PATH'):
        cfg.pop(k)
    cfg_file = base / 'tiny_flagship.yaml'
    cfg_file.write_text(yaml.safe_dump(cfg))
    return root, cfg_file


def tiny_net(cfg_file, seed: int = 0):
    cfg = cli_common.cfg_from_yaml_file(str(cfg_file))
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.DATA_CONFIG, device='cpu',
                        seed=seed, class_names=cfg.CLASS_NAMES)
    return cfg, net


def test_pretrained_overlay_is_partial_and_restores_no_step(mini, tmp_path):
    """Matching entries load; an entry of another shape and one the model
    lacks are passed over; neither the optimizer's state nor its update
    count is read (no resume)."""
    cfg, src = tiny_net(mini[1], seed=0)
    opt, _ = trainer.create_train_state(src, cfg.OPTIMIZATION, 10, 2)
    opt.count = 7
    path = trainer.save_checkpoint(tmp_path / 'ckpt', src, opt, epoch=3)
    ckpt = torch.load(path, weights_only=True)
    state = ckpt['model_state']
    reshaped = next(k for k, v in state.items() if v.dim() == 2)
    state[reshaped] = state[reshaped][:-1]
    state['no_such.weight'] = torch.zeros(2)
    torch.save(ckpt, path)

    _, dst = tiny_net(mini[1], seed=1)
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    dst_opt, _ = trainer.create_train_state(dst, cfg.OPTIMIZATION, 10, 2)
    loaded, kept = trainer.load_pretrained(tmp_path / 'ckpt', dst)
    after = dst.state_dict()
    assert kept == 1 and loaded == len(after) - 1
    torch.testing.assert_close(after[reshaped], before[reshaped], rtol=0, atol=0)
    assert not torch.equal(before[reshaped], src.state_dict()[reshaped][:-1])
    for k, v in src.state_dict().items():
        if k != reshaped:
            torch.testing.assert_close(after[k], v, rtol=0, atol=0)
    assert dst_opt.count == 0 and not dst_opt.optimizer.state


def log_text(out_dir, prefix: str) -> str:
    return '\n'.join(p.read_text() for p in sorted(out_dir.glob(f'{prefix}_*.log')))


def test_train_cli_flags_and_hook(mini, tmp_path):
    """One run of the train CLI with a HOOK in the config,
    `--pretrained_model`, `--fix_random_seed`, `--merge_all_iters_to_one_epoch`
    over 2 epochs (one epoch of two passes: 3 steps at batch 2) and
    `--profile`."""
    root, cfg_file = mini
    cfg = yaml.safe_load(cfg_file.read_text())
    cfg['HOOK'] = {'DisableAugmentationHook': {'DISABLE_AUG_LIST': ['gt_sampling'],
                                               'NUM_LAST_EPOCHS': 1}}
    hooked = tmp_path / 'hooked.yaml'
    hooked.write_text(yaml.safe_dump(cfg))
    ycfg, src = tiny_net(cfg_file, seed=3)
    opt, _ = trainer.create_train_state(src, ycfg.OPTIMIZATION, 10, 2)
    pre = trainer.save_checkpoint(tmp_path / 'pre', src, opt, epoch=9)
    out = tmp_path / 'out'
    train_cli.main(['--cfg_file', str(hooked), '--batch_size', '2', '--workers', '0',
                    '--device', 'cpu', '--output_dir', str(out), '--epochs', '2',
                    '--pretrained_model', str(pre), '--fix_random_seed',
                    '--merge_all_iters_to_one_epoch', '--profile'])
    log = log_text(out, 'train')
    assert f'pretrained {pre}: loaded' in log
    assert "hook: disabled augs ['gt_sampling'] from epoch 0" in log
    assert 'epoch 0 iter 0/3 ' in log
    assert [p.name for p in trainer.list_checkpoints(out / 'ckpt')] == ['checkpoint_epoch_1.pth']
    assert (out / 'profile' / 'trace_rank0.json').stat().st_size > 0


def test_test_cli_ckpt_step_eval_all_and_matmul_precision(mini, tmp_path):
    """Two checkpoints: `--ckpt_step 1` takes the first; `--eval_all` with
    `--max_waiting_mins 0` evaluates both in epoch order and lists them in
    eval_list_val.txt, and a second run finds nothing new."""
    _, cfg_file = mini
    cfg, net = tiny_net(cfg_file)
    opt, _ = trainer.create_train_state(net, cfg.OPTIMIZATION, 10, 2)
    out = tmp_path / 'out'
    for epoch in (1, 2):
        trainer.save_checkpoint(out / 'ckpt', net, opt, epoch)
        with torch.no_grad():       # the two checkpoints hold other weights
            next(net.parameters()).add_(1.0)
    common = ['--cfg_file', str(cfg_file), '--batch_size', '2', '--workers', '0',
              '--device', 'cpu', '--output_dir', str(out)]
    try:
        ret = test_cli.main(common + ['--ckpt_step', '1', '--matmul_precision', 'float32'])
    finally:
        cli_common.set_matmul_precision('tensorfloat32')
    assert 'recall/rcnn_0.7' in ret and any(k.endswith('_R40') for k in ret)
    log = log_text(out, 'eval')
    assert f"loaded {out / 'ckpt' / 'checkpoint_epoch_1.pth'} (epoch 1)" in log
    assert "matmul precision float32: {'float32_matmul_precision': 'highest'" in log
    results = test_cli.main(common + ['--eval_all', '--max_waiting_mins', '0'])
    assert sorted(results) == [1, 2]
    assert (out / 'eval' / 'eval_list_val.txt').read_text().split() == ['1', '2']
    assert test_cli.main(common + ['--eval_all', '--max_waiting_mins', '0']) == {}


@pytest.mark.parametrize('name', sorted(cli_common.MATMUL_PRECISIONS))
def test_matmul_precision_sets_what_it_names(name):
    want = {'float32': ('highest', False, False), 'tensorfloat32': ('high', True, True),
            'bfloat16': ('medium', True, True)}[name]
    before = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    try:
        got = cli_common.set_matmul_precision(name, logging.getLogger('test'))
        assert got == {'float32_matmul_precision': want[0],
                       'cuda.matmul.allow_tf32': want[1], 'cudnn.allow_tf32': want[2]}
        assert torch.get_float32_matmul_precision() == want[0]
        assert torch.backends.cudnn.allow_tf32 is want[2]
    finally:
        torch.set_float32_matmul_precision(before[0])
        torch.backends.cudnn.allow_tf32 = before[1]


# ---- the demo and the dry run on two ranks ---------------------------------------------

def test_demo_over_two_clouds(mini, tmp_path, monkeypatch):
    """Two generated .bin clouds with `--vis none --save_dir`: each frame's
    boxes saved as (n, 9) rows, finite, labels among the classes; a render
    without matplotlib names it and `--vis none`."""
    root, cfg_file = mini
    clouds = tmp_path / 'clouds'
    clouds.mkdir()
    for i in range(2):
        (clouds / f'{i:06d}.bin').write_bytes(
            (root / 'training' / 'velodyne' / f'00000{i}.bin').read_bytes())
    save = tmp_path / 'boxes'
    frames = demo.main(['--cfg_file', str(cfg_file), '--data_path', str(clouds), '--vis', 'none',
                        '--save_dir', str(save), '--device', 'cpu'])
    assert len(frames) == 2
    for i, f in enumerate(frames):
        rows = np.load(save / f'frame_{i}_boxes.npy')
        assert rows.shape == (len(f['boxes']), 9) and np.isfinite(rows).all()
        assert set(rows[:, 8].astype(int)) <= {1, 2, 3}
    assert sum(len(f['boxes']) for f in frames) > 0
    from pdm_ssd_torch.tools import visual_utils
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    with pytest.raises(ImportError, match='matplotlib.*--vis none'):
        visual_utils.draw_scenes(np.zeros((4, 4), np.float32), mode='bev')


def test_dryrun_on_two_gloo_ranks(capsys):
    dryrun.main(['--nprocs', '2', '--device', 'cpu', '--batch', '2', '--points', '256'])
    out = capsys.readouterr().out
    assert 'dryrun_multichip(2): PDMSSD train step on 2 ranks (gloo, cpu) + predict OK, loss=' \
        in out


def test_eval_result_is_the_set_in_order(mini, tmp_path):
    """`eval_one_epoch` without a group: every frame once, in the set's
    order, in `result.pkl` (the order the sharded run restores)."""
    root, cfg_file = mini
    cases.eval_case(root, tmp_path)
    with open(tmp_path / 'result.pkl', 'rb') as f:
        annos = pickle.load(f)
    assert [a['frame_id'] for a in annos] == ['000000', '000001', '000002']
