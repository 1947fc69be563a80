"""The port's Runner, checkpoints and CLI on the CPU: exact resume (two
epochs straight against one, a resume and one more, bitwise), the V5
config's run and resume (iters 16 -> 24, as tests/test_e2e_workloads.py
holds JAX's), the SIGTERM checkpoint, validation by loss leaving the state
as it was, the checkpoint format, and the CLI in a subprocess.

The data are PNG frames and ``.npy`` flows, which the port reads without
cv2. Host draws: where two runs must draw the same clips in an epoch, the
test reseeds Python's and numpy's global generators from the epoch number
when the loader starts the epoch (a patched ``NumpyLoader.set_epoch``)."""
import json
import os
import os.path as osp
import random
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from mscl_torch.apis import build_model_from_cfg, narrow_flagship_cfg
from mscl_torch.apis import train_model
from mscl_torch.config import Config
from mscl_torch.core import (load_checkpoint, load_meta, publish_model,
                             restore_model_state, restore_train_state,
                             save_checkpoint, train_loop, train_state)
from mscl_torch.datasets import loader as t_loader

from _torch_data_util import (one_torch_thread, register_tiny3d,  # noqa: F401
                              tiny_pretrain_cfg, write_videos)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
pytestmark = pytest.mark.usefixtures('one_torch_thread')


@pytest.fixture(scope='module')
def pkl(tmp_path_factory):
    register_tiny3d()
    root = str(tmp_path_factory.mktemp('videos'))
    return write_videos(root, 8, 24, (32, 32), (16, 16))


@pytest.fixture
def epoch_seeded(monkeypatch):
    real = t_loader.NumpyLoader.set_epoch

    def set_epoch(self, epoch):
        random.seed(epoch)
        np.random.seed(epoch)
        real(self, epoch)
    monkeypatch.setattr(t_loader.NumpyLoader, 'set_epoch', set_epoch)


def _train(cfg, **kwargs):
    return train_model(Config.fromdict(cfg), seed=0, device='cpu', **kwargs)


def _full_state(runner):
    state = train_state(runner.model, runner.optimizer)
    assert state['aug_rng'] is not None
    return state


def _assert_states_equal(a, b):
    assert sorted(a['state_dict']) == sorted(b['state_dict'])
    for k, v in a['state_dict'].items():
        assert torch.equal(v, b['state_dict'][k]), k
    oa, ob = a['optimizer'], b['optimizer']
    assert oa['steps'] == ob['steps']
    assert sorted(oa['sgd']['state']) == sorted(ob['sgd']['state'])
    for i, s in oa['sgd']['state'].items():
        assert torch.equal(s['momentum_buffer'],
                           ob['sgd']['state'][i]['momentum_buffer']), i
    assert torch.equal(a['aug_rng'], b['aug_rng'])


def test_resume_is_exact(pkl, tmp_path, epoch_seeded):
    """2 epochs straight == the same run's epoch_1 checkpoint resumed in a
    new run for its second epoch: parameters, buffers, momentum, steps and
    the aug generator bitwise."""
    straight, _ = _train(tiny_pretrain_cfg(pkl, str(tmp_path / 'a')),
                         validate=False)
    resumed, _ = _train(tiny_pretrain_cfg(pkl, str(tmp_path / 'c')),
                        validate=False,
                        resume_from=str(tmp_path / 'a' / 'epoch_1.pth'))
    assert straight.optimizer.steps == resumed.optimizer.steps == 4
    _assert_states_equal(_full_state(straight), _full_state(resumed))
    a = [json.loads(x) for x in open(tmp_path / 'a' / 'log.json')]
    c = [json.loads(x) for x in open(tmp_path / 'c' / 'log.json')]
    assert [r['loss'] for r in a[2:]] == [r['loss'] for r in c]


def test_loaded_state_equals_saved(pkl, tmp_path):
    runner, model = _train(tiny_pretrain_cfg(pkl, str(tmp_path),
                                             total_epochs=1), validate=False)
    saved = _full_state(runner)
    path = osp.join(str(tmp_path), 'epoch_1.pth')
    _assert_states_equal(saved, load_checkpoint(path))
    fresh = build_model_from_cfg(tiny_pretrain_cfg(pkl, '')['model'],
                                 device='cpu', seed=5)
    opt = type(runner.optimizer)(
        [p for n, p in fresh.named_parameters()
         if not any(k in n for k in ('encoder_k', 'neck_k', 'mlp_k'))],
        runner.lr_schedule, momentum=0.9)
    restore_train_state(fresh, opt, load_checkpoint(path))
    _assert_states_equal(saved, train_state(fresh, opt))
    assert load_meta(path) == {'epoch': 1}
    torch.load(path, weights_only=True)


def test_v5_runs_checkpoints_and_resumes(pkl, tmp_path):
    """tests/test_e2e_workloads.py's V5 pretrain at a global batch of 8:
    iters 16 after 2 epochs, 24 after resuming for a third."""
    cfg = tiny_pretrain_cfg(pkl, str(tmp_path), videos_per_gpu=8)
    runner, model = _train(cfg, validate=False)
    assert runner.optimizer.steps == 2
    assert int(model.recognizer.iters) == 16
    for name in ('epoch_1.pth', 'epoch_2.pth', 'log.json'):
        assert osp.exists(osp.join(str(tmp_path), name))
    cfg['total_epochs'] = 3
    runner, model = _train(cfg, validate=False,
                           resume_from=osp.join(str(tmp_path), 'epoch_2.pth'))
    assert runner.optimizer.steps == 3
    assert int(model.recognizer.iters) == 24
    assert int(model.recognizer_flow.iters) == 48
    assert open(osp.join(str(tmp_path), 'latest')).read() == 'epoch_3.pth'


def test_sigterm_writes_a_resumable_checkpoint(pkl, tmp_path, monkeypatch):
    work = str(tmp_path)
    previous = signal.getsignal(signal.SIGTERM)
    real = train_loop.to_torch
    sent = []

    def to_torch(batch, device):
        if not sent:
            sent.append(1)
            os.kill(os.getpid(), signal.SIGTERM)
        return real(batch, device)
    monkeypatch.setattr(train_loop, 'to_torch', to_torch)
    with pytest.raises(SystemExit) as exit_info:
        _train(tiny_pretrain_cfg(pkl, work), validate=False)
    assert exit_info.value.code == 143
    assert signal.getsignal(signal.SIGTERM) == previous
    assert open(osp.join(work, 'latest')).read() == 'preempt_epoch_0.pth'
    path = osp.join(work, 'preempt_epoch_0.pth')
    assert load_meta(path) == {'preempted': True, 'iter': 1, 'epoch': 0}
    assert load_checkpoint(path)['optimizer']['steps'] == 1
    log = [json.loads(x) for x in open(osp.join(work, 'log.json'))]
    assert log[-1]['mode'] == 'preempt'
    monkeypatch.setattr(train_loop, 'to_torch', real)
    runner, _ = _train(tiny_pretrain_cfg(pkl, work), validate=False,
                       resume_from=path)
    assert runner.optimizer.steps == 5        # epoch 1 again, then epoch 2


def test_validate_leaves_the_state_unchanged(pkl, tmp_path):
    cfg = tiny_pretrain_cfg(pkl, str(tmp_path), total_epochs=1, val_pkl=pkl)
    runner, _ = _train(cfg, validate=True)
    before = _full_state(runner)
    for _ in range(2):          # the same clips both times
        random.seed(1)
        np.random.seed(1)
        runner.validate()
    _assert_states_equal(before, _full_state(runner))
    log = [json.loads(x) for x in open(osp.join(str(tmp_path), 'log.json'))]
    vals = [r for r in log if r['mode'] == 'val']
    assert len(vals) == 3 and vals[1] == vals[2]
    assert all(np.isfinite(r['loss']) for r in vals)


def test_save_best_keeps_one_best_checkpoint(pkl, tmp_path):
    """evaluation.save_best='loss': the rule is 'less', and only the best
    validation's best_loss_ checkpoint is kept, apart from 'latest'."""
    cfg = tiny_pretrain_cfg(pkl, str(tmp_path), val_pkl=pkl)
    cfg['evaluation'] = dict(interval=1, simple=True, save_best='loss')
    runner, _ = _train(cfg, validate=True)
    assert runner.best_rule == 'less'
    log = [json.loads(x) for x in open(osp.join(str(tmp_path), 'log.json'))]
    vals = [r['loss'] for r in log if r['mode'] == 'val' and 'loss' in r]
    best = [r for r in log if 'best_score' in r]
    assert best and best[-1]['best_score'] == min(vals)
    files = [f for f in os.listdir(str(tmp_path))
             if f.startswith('best_loss_') and f.endswith('.pth')]
    assert files == [osp.basename(best[-1]['best_ckpt'])]
    assert open(osp.join(str(tmp_path), 'latest')).read() == 'epoch_2.pth'


def test_reference_state_dict_and_publish(pkl, tmp_path):
    model = build_model_from_cfg(tiny_pretrain_cfg(pkl, '')['model'],
                                 device='cpu', seed=1)
    ref = str(tmp_path / 'reference.pth')
    torch.save({'meta': {'epoch': 400, 'mmcv_version': '1.3.9'},
                'state_dict': model.state_dict()}, ref)
    loaded = load_checkpoint(ref)
    assert sorted(loaded) == sorted(model.state_dict())
    other = build_model_from_cfg(tiny_pretrain_cfg(pkl, '')['model'],
                                 device='cpu', seed=2)
    restore_model_state(other, loaded)
    for k, v in model.state_dict().items():
        assert torch.equal(v, other.state_dict()[k]), k
    path = save_checkpoint(train_state(model), str(tmp_path), 3)
    out = publish_model(path, str(tmp_path / 'published.pth'))
    assert osp.basename(out).startswith('published-') and out.endswith('.pth')
    assert load_checkpoint(out)['optimizer'] is None


def _cli_cfg(pkl, work):
    model = narrow_flagship_cfg(K=16, dim=16, rgb_width=4, flow_width=2,
                                num_frames=4, max_iters=200)
    model['aug'] = dict(type='SyncMoCoAugmentV5', crop_size=16,
                        sync_level=('batch', 'batch'), t=(4, 4),
                        flow_suffix='flow_imgs', weak_aug=(False, False),
                        visualize=True)
    model['sup_head']['t'] = 2
    cfg = tiny_pretrain_cfg(pkl, work, val_pkl=pkl)
    cfg['model'] = model
    return cfg


def test_cli_trains_on_the_cpu(pkl, tmp_path):
    work = str(tmp_path / 'work')
    cfg_file = str(tmp_path / 'tiny.py')
    Config.fromdict(_cli_cfg(pkl, work)).dump(cfg_file)
    cmd = [sys.executable, '-m', 'mscl_torch.tools.train', cfg_file,
           '--validate', '--seed', '0', '--device', 'cpu', '--cfg-options',
           'total_epochs=1', 'log_config.interval=1']
    env = dict(os.environ, OMP_NUM_THREADS='1')
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    log = [json.loads(x) for x in open(osp.join(work, 'log.json'))]
    assert [r['mode'] for r in log] == ['train', 'train', 'val']
    assert all(np.isfinite(r['loss']) for r in log)
    assert osp.exists(osp.join(work, 'epoch_1.pth'))
    assert osp.exists(osp.join(work, 'tiny.py'))
    # two gloo ranks on the CPU: a global batch of 8, so one train step
    work2 = str(tmp_path / 'work2')
    two = subprocess.run(cmd + ['--num-devices', '2', '--work-dir', work2],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=env)
    assert two.returncode == 0, two.stderr[-3000:]
    lines = [json.loads(x) for x in two.stdout.splitlines()
             if x.startswith('{"mode"')]
    by_rank = [[(r['mode'], r['loss']) for r in lines if r['rank'] == k]
               for k in (0, 1)]
    assert [m for m, _ in by_rank[0]] == ['train', 'val']
    assert by_rank[0] == by_rank[1]
    log2 = [json.loads(x) for x in open(osp.join(work2, 'log.json'))]
    assert [(r['mode'], r['loss']) for r in log2] == by_rank[0]
    assert osp.exists(osp.join(work2, 'epoch_1.pth'))
    bad = subprocess.run(cmd + ['--num-devices', '0'], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert bad.returncode == 2 and 'at least 1' in bad.stderr
