"""README workloads 2 and 3 with the port, against mscl_tpu, on the CPU, on
tests/test_e2e_workloads.py's tiny configs (the ``test.tiny3d`` backbone,
PNG frames on disk):

- the SSL surgery from a narrow MSCLWithAug checkpoint that the port's
  Runner wrote: the backbone equals its encoder_q bitwise and equals what
  JAX's ``apply_ssl_pretrain`` makes of the same file; a shape mismatch is
  reported; a ``.ckpt`` is read as the JAX package's checkpoint;
- ``train_model`` on the fine-tune config (dropout 0) for 2 epochs with
  validation by metrics each epoch, both from JAX's initial variables (the
  surgery's result): every logged loss within 2e-4, the accuracies and the
  top1/top5/mean-class metrics equal, the checkpoints present;
- exact resume with dropout, and the decode processes stopped after a run;
- the test and retrieval CLIs: the metrics of JAX's CLIs on the same
  weights (the test CLI both from a converted ``.pth`` and from the JAX
  ``.ckpt`` itself).
"""
import json
import os.path as osp
import random
import runpy
import sys

import jax
import multiprocessing
import numpy as np
import pytest
import torch

import mscl_tpu.apis.train as jax_train
from mscl_tpu import Config as JaxConfig
from mscl_tpu.core import save_checkpoint as jax_save_checkpoint
from mscl_tpu.parallel.mesh import create_mesh
from mscl_torch.apis import (apply_ssl_pretrain, build_model_from_cfg,
                             train_model)
from mscl_torch.config import Config
from mscl_torch.convert import jax_to_state_dict, load_jax_variables
from mscl_torch.core import (build_lr_schedule, build_optimizer,
                             load_checkpoint, save_checkpoint, train_state)
from mscl_torch.datasets import build_dataset
from mscl_torch.datasets import loader as t_loader
from mscl_torch.tools import test as test_cli
from mscl_torch.tools import test_retrieval as retrieval_cli

from _torch_data_util import (one_torch_thread, register_tiny3d,  # noqa: F401
                              tiny_pretrain_cfg, write_videos)
from _torch_port_util import xla3d_conv  # noqa: F401

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
B = 4
pytestmark = pytest.mark.usefixtures('one_torch_thread')


def _seed(s=0):
    random.seed(s)
    np.random.seed(s)


def _log(work_dir):
    with open(osp.join(work_dir, 'log.json')) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    register_tiny3d()
    root = str(tmp_path_factory.mktemp('videos'))
    pkl = write_videos(root, 8, 24, (32, 32), (16, 16))
    pre = str(tmp_path_factory.mktemp('pretrain'))
    train_model(Config.fromdict(tiny_pretrain_cfg(
        pkl, pre, aug=dict(type='IdentityAug'), total_epochs=1)),
        validate=False, seed=0, device='cpu')
    return dict(pkl=pkl, ckpt=osp.join(pre, 'epoch_1.pth'))


def ft_cfg(data, work_dir, dropout=0.0, ssl=True, epochs=2):
    """tests/test_e2e_workloads.py's fine-tune config: a batch of 4, the
    given dropout, validation by top-k and mean-class accuracy every
    epoch, a checkpoint every epoch."""
    from test_e2e_workloads import finetune_cfg
    cfg = finetune_cfg(dict(pkl=data['pkl']), work_dir,
                       data['ckpt']).to_dict()
    cfg['data']['videos_per_gpu'] = B
    cfg['model']['cls_head']['dropout_ratio'] = dropout
    if not ssl:
        del cfg['model']['train_cfg']
    cfg['evaluation'] = dict(interval=1, metrics=['top_k_accuracy',
                                                  'mean_class_accuracy'])
    cfg['checkpoint_config'] = dict(interval=1)
    cfg['total_epochs'] = epochs
    return cfg


def _jax_variables(cfg):
    """mscl_tpu's initial variables of the fine-tune model, its surgery
    applied (the port's checkpoint read through JAX's torch path)."""
    captured = []
    real = jax_train.init_state

    def init_state(*args, **kwargs):
        captured.append(real(*args, **kwargs))
        raise StopIteration
    jax_train.init_state = init_state
    try:
        jax_train.train_model(JaxConfig.fromdict(cfg), validate=False,
                              seed=0, mesh=create_mesh(1))
    except StopIteration:
        pass
    finally:
        jax_train.init_state = real
    state = captured[0]
    return {'params': state.params, 'batch_stats': state.batch_stats}


@pytest.fixture(scope='module')
def jax_init(data, xla3d_conv):
    return _jax_variables(ft_cfg(data, 'unused'))


def test_surgery_matches_jax(data, jax_init, capsys):
    cfg = ft_cfg(data, 'unused')
    ssl = cfg['model']['train_cfg']['ssl_pretrain']
    model = build_model_from_cfg(cfg['model'], device='cpu')
    head = model.cls_head.fc_cls.weight.detach().clone()
    apply_ssl_pretrain(model, ssl)
    enc = {k[len('recognizer.encoder_q.'):]: v for k, v in
           load_checkpoint(data['ckpt'])['state_dict'].items()
           if k.startswith('recognizer.encoder_q.')}
    got = {k[len('backbone.'):]: v for k, v in model.state_dict().items()
           if k.startswith('backbone.')}
    assert sorted(got) == sorted(enc)
    for k, v in enc.items():
        assert torch.equal(got[k], v), k
    assert torch.equal(model.cls_head.fc_cls.weight, head)
    assert 'params not loaded' not in capsys.readouterr().out

    want = jax_to_state_dict(jax_init)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want['backbone.' + k],
                                      err_msg=k)


def test_surgery_reports_a_shape_mismatch(data, tmp_path, capsys):
    ckpt = load_checkpoint(data['ckpt'])
    key = 'recognizer.encoder_q.layer1.0.conv1.0.weight'
    ckpt['state_dict'][key] = torch.zeros(1)
    path = str(tmp_path / 'bad.pth')
    torch.save(ckpt, path)
    cfg = ft_cfg(data, 'unused')
    model = build_model_from_cfg(cfg['model'], device='cpu')
    before = model.backbone.layer1[0].conv1[0].weight.detach().clone()
    apply_ssl_pretrain(model, dict(pretrained=dict(filename=path)))
    assert '(shape mismatch)' in capsys.readouterr().out
    assert torch.equal(model.backbone.layer1[0].conv1[0].weight, before)
    with pytest.raises(FileNotFoundError, match='e.ckpt'):
        apply_ssl_pretrain(model, dict(pretrained=dict(filename='e.ckpt')))
    with pytest.raises(KeyError, match='no keys under prefix'):
        apply_ssl_pretrain(model, dict(pretrained=dict(filename=path),
                                       backbone=dict(prefix='recognizer.q')))


def test_train_model_matches_jax(data, tmp_path, xla3d_conv):
    jdir, tdir, t0dir = (str(tmp_path / n) for n in ('jax', 'port', 'p0'))
    captured = []
    real = jax_train.init_state

    def init_state(*args, **kwargs):
        state = real(*args, **kwargs)
        captured.append(jax.tree.map(lambda x: np.array(x, copy=True), {
            'params': state.params, 'batch_stats': state.batch_stats}))
        return state
    jax_train.init_state = init_state
    try:
        _seed()
        jax_train.train_model(JaxConfig.fromdict(ft_cfg(data, jdir)),
                              validate=True, seed=0, mesh=create_mesh(1))
    finally:
        jax_train.init_state = real

    cfg = ft_cfg(data, tdir)
    model = build_model_from_cfg(cfg['model'], device='cpu')
    load_jax_variables(model, captured[0])
    opt = build_optimizer(model, dict(type='SGD', lr=0.0),
                          build_lr_schedule({}, 0.0, 1, 1))
    ckpt0 = save_checkpoint(train_state(model, opt), t0dir, 0)
    _seed()
    example = build_dataset(dict(cfg['data']['train']))
    for i in range(B):                   # JAX's example_batch_from draws
        example[i]
    runner, _ = train_model(Config.fromdict(cfg), validate=True, seed=0,
                            device='cpu', resume_from=ckpt0)

    jlog, tlog = _log(jdir), _log(tdir)
    assert [r['mode'] for r in tlog] == [r['mode'] for r in jlog] == \
        ['train', 'train', 'val'] * 2
    for j, t in zip(jlog, tlog):
        assert sorted(j) == sorted(t)
        for k in j:
            if k in ('time', 'data_time'):
                continue
            if k.startswith('loss') or k == 'lr':
                np.testing.assert_allclose(t[k], j[k], rtol=2e-4, atol=2e-4,
                                           err_msg=f'{t["mode"]} {k}')
            else:
                assert t[k] == j[k], (t['mode'], k)
    val = [r for r in tlog if r['mode'] == 'val']
    assert all({'top1_acc', 'top5_acc', 'mean_class_accuracy'} <= set(r)
               for r in val)
    assert runner.optimizer.steps == 4
    for name in ('epoch_1.pth', 'epoch_2.pth', 'latest'):
        assert osp.exists(osp.join(tdir, name)), name


@pytest.fixture
def epoch_seeded(monkeypatch):
    real = t_loader.NumpyLoader.set_epoch

    def set_epoch(self, epoch):
        random.seed(epoch)
        np.random.seed(epoch)
        real(self, epoch)
    monkeypatch.setattr(t_loader.NumpyLoader, 'set_epoch', set_epoch)


def test_resume_with_dropout_is_exact(data, tmp_path, epoch_seeded):
    """2 epochs straight == the epoch_1 checkpoint resumed for the second:
    parameters, BN statistics, momentum, steps and the dropout generator
    bitwise (dropout 0.5 draws a mask every step)."""
    a, c = str(tmp_path / 'a'), str(tmp_path / 'c')
    straight, _ = train_model(Config.fromdict(ft_cfg(data, a, 0.5, False)),
                              validate=False, seed=0, device='cpu')
    resumed, _ = train_model(Config.fromdict(ft_cfg(data, c, 0.5, False)),
                             validate=False, seed=0, device='cpu',
                             resume_from=osp.join(a, 'epoch_1.pth'))
    sa, sc = (train_state(r.model, r.optimizer) for r in (straight, resumed))
    assert sa['dropout_rng'] is not None and sa['aug_rng'] is None
    assert torch.equal(sa['dropout_rng'], sc['dropout_rng'])
    for k, v in sa['state_dict'].items():
        assert torch.equal(v, sc['state_dict'][k]), k
    assert sa['optimizer']['steps'] == sc['optimizer']['steps'] == 4
    for i, s in sa['optimizer']['sgd']['state'].items():
        assert torch.equal(s['momentum_buffer'],
                           sc['optimizer']['sgd']['state'][i][
                               'momentum_buffer'])
    assert [r['loss'] for r in _log(a)[2:]] == [r['loss'] for r in _log(c)]
    assert load_checkpoint(osp.join(a, 'epoch_1.pth'))['dropout_rng'] \
        is not None


def test_process_workers_stop_with_the_run(data, tmp_path):
    cfg = ft_cfg(data, str(tmp_path), ssl=False, epochs=1)
    cfg['data'].update(workers_per_gpu=2, workers_mode='process')
    runner, _ = train_model(Config.fromdict(cfg), validate=True, seed=0,
                            device='cpu')
    assert runner.optimizer.steps == 2
    assert runner.train_loader._pool is None
    assert not multiprocessing.active_children()
    assert 'top1_acc' in _log(str(tmp_path))[-1]


def _cli_config(data, path):
    """tests/test_e2e_workloads.py's CLI config file: a batch of 1 (JAX's
    CLIs run it on 8 CPU devices, a batch of 8), its test set the train
    set, the surgery from the port's pretrain checkpoint."""
    cfg = ft_cfg(data, 'unused')
    ds = dict(type='FileRawframeDataset', pkl_path=data['pkl'],
              pipeline=cfg['data']['test']['pipeline'])
    with open(path, 'w') as f:
        f.write(f'model = {cfg["model"]!r}\n'
                f'data = dict(videos_per_gpu=1, workers_per_gpu=0, '
                f'train={ds!r}, test={ds!r})\n')
    return str(path)


def _jax_cli(script, argv):
    saved = sys.argv
    sys.argv = [script] + argv
    try:
        runpy.run_path(osp.join(ROOT, script), run_name='__main__')
    finally:
        sys.argv = saved


def test_test_cli_matches_jax(data, tmp_path, jax_init):
    from flax import serialization
    cfg_py = _cli_config(data, tmp_path / 'cfg.py')
    cfg = ft_cfg(data, 'unused')
    variables = jax_init
    jstate = jax_train.init_state(
        jax_train.build_model_from_cfg(cfg['model']),
        jax_train.build_optimizer(dict(type='SGD', lr=0.0),
                                  jax_train.build_lr_schedule(
                                      dict(policy='fixed'), 0.0, 1, 1)),
        jax_train.example_batch_from(jax_train.build_dataset(
            dict(cfg['data']['test'], test_mode=True)), 8),
        post_init_fn=lambda v: dict(v, **variables))
    jckpt = jax_save_checkpoint(serialization.to_state_dict(jstate),
                                str(tmp_path / 'jax'), 1)
    tckpt = str(tmp_path / 'port.pth')
    torch.save({'state_dict': {k: torch.from_numpy(v) for k, v in
                               jax_to_state_dict(variables).items()}}, tckpt)
    metrics = ['--metrics', 'top_k_accuracy', 'mean_class_accuracy']
    _jax_cli('tools/test.py', [cfg_py, jckpt, *metrics, '--out',
                               str(tmp_path / 'jax.json')])
    got = test_cli.main([cfg_py, tckpt, *metrics, '--out',
                         str(tmp_path / 'port.json'), '--device', 'cpu'])
    want = json.load(open(tmp_path / 'jax.json'))
    assert got == want == json.load(open(tmp_path / 'port.json'))
    assert sorted(got) == ['mean_class_accuracy', 'top1_acc', 'top5_acc']
    # the JAX checkpoint itself, read by the port
    assert test_cli.main([cfg_py, jckpt, *metrics, '--device', 'cpu']) == \
        want


def test_retrieval_cli_matches_jax(data, tmp_path, xla3d_conv):
    """--ssl: both take the encoder from the port's pretrain checkpoint;
    the test set is the train set, so recall@1 is 1."""
    cfg_py = _cli_config(data, tmp_path / 'cfg.py')
    _jax_cli('tools/test_retrieval.py', [cfg_py, '--ssl', '--out',
                                         str(tmp_path / 'jax.json')])
    got = retrieval_cli.main([cfg_py, '--ssl', '--device', 'cpu'])
    assert got == json.load(open(tmp_path / 'jax.json'))
    assert got['recall@1'] == 1.0


def _dp_cli_config(data, path):
    """_cli_config's data with a narrow r3d_18 (a registered backbone, so a
    spawned rank builds it) and 3 videos a card: at 2 ranks the last
    global batch (2 of 6) is padded and trimmed."""
    cfg = ft_cfg(data, 'unused')
    ds = dict(type='FileRawframeDataset', pkl_path=data['pkl'],
              pipeline=cfg['data']['test']['pipeline'])
    model = dict(type='Recognizer3D',
                 backbone=dict(type='torchvision.r3d_18',
                               layers=(1, 1, 1, 1), base_width=4),
                 cls_head=dict(type='I3DHead', num_classes=2, in_channels=32,
                               dropout_ratio=0.0))
    with open(path, 'w') as f:
        f.write(f'model = {model!r}\n'
                f'data = dict(videos_per_gpu=3, workers_per_gpu=0, '
                f'train={ds!r}, test={ds!r})\n')
    ckpt = str(path) + '.pth'
    torch.save({'state_dict': build_model_from_cfg(
        model, device='cpu', seed=7).state_dict()}, ckpt)
    return str(path), ckpt


def test_test_cli_on_two_ranks(data, tmp_path):
    """--num-devices 2 with --device cpu: two gloo ranks, each scoring its
    rows; the metrics rank 0 writes are one device's."""
    cfg_py, ckpt = _dp_cli_config(data, tmp_path / 'cfg.py')
    metrics = ['--metrics', 'top_k_accuracy', 'mean_class_accuracy']
    want = test_cli.main([cfg_py, ckpt, *metrics, '--device', 'cpu'])
    got = test_cli.main([cfg_py, ckpt, *metrics, '--device', 'cpu',
                         '--num-devices', '2', '--out',
                         str(tmp_path / 'two.json')])
    assert got == want == json.load(open(tmp_path / 'two.json'))
    with pytest.raises(SystemExit) as e:
        test_cli.parse_args([cfg_py, ckpt, '--num-devices', '0'])
    assert e.value.code == 2


def test_retrieval_cli_on_two_ranks(data, tmp_path):
    cfg_py, ckpt = _dp_cli_config(data, tmp_path / 'cfg.py')
    want = retrieval_cli.main([cfg_py, ckpt, '--device', 'cpu'])
    got = retrieval_cli.main([cfg_py, ckpt, '--device', 'cpu',
                              '--num-devices', '2'])
    assert got == want and want['recall@1'] == 1.0
    with pytest.raises(SystemExit) as e:
        retrieval_cli.parse_args([cfg_py, '--num-devices', '0'])
    assert e.value.code == 2
