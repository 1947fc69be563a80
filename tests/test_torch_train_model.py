"""The slice as a whole: the port's ``train_model`` against mscl_tpu's on
tests/test_e2e_workloads.py's tiny pretrain config (the ``test.tiny3d``
backbone, JPEG frames and np4 flows on disk, MatchFlow + MDS sampling +
FRA + MoCo crops), with IdentityAug, a global batch of 4, validation by
loss every epoch, 2 epochs of 2 steps.

The JAX side runs on a 1-device mesh with its convolutions pinned to
'xla3d'. The port starts from JAX's initial variables, converted by
``mscl_torch/convert.py`` into a port checkpoint at epoch 0, so the run
resumes too. Both read the same files with ``workers_per_gpu=0``. The host
draws match because both runs start from ``random.seed(0)`` and
``np.random.seed(0)`` and make the same draws in the same order: JAX's
``train_model`` first builds an example batch (4 samples) to initialise
its model, so the port's run is preceded by the same 4 samples.
"""
import json
import os.path as osp
import random

import jax
import numpy as np
import pytest

import mscl_tpu.apis.train as jax_train
from mscl_tpu import Config as JaxConfig
from mscl_tpu.parallel.mesh import create_mesh
from mscl_torch.apis import MOCO_FREEZE, build_model_from_cfg, train_model
from mscl_torch.config import Config
from mscl_torch.convert import jax_to_state_dict, load_jax_variables
from mscl_torch.core import (build_lr_schedule, build_optimizer,
                             save_checkpoint, train_state)
from mscl_torch.datasets import build_dataset

from _torch_data_util import (one_torch_thread, register_tiny3d,  # noqa: F401
                              tiny_pretrain_cfg, write_videos)
from _torch_port_util import xla3d_conv  # noqa: F401

B, TOWERS = 4, ('recognizer', 'recognizer_flow')


def _seed():
    random.seed(0)
    np.random.seed(0)


def _log(work_dir):
    with open(osp.join(work_dir, 'log.json')) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope='module')
def runs(tmp_path_factory, xla3d_conv, one_torch_thread):
    register_tiny3d()
    root = str(tmp_path_factory.mktemp('videos'))
    pkl = write_videos(root, 8, 24, (32, 32), (16, 16), 'jpg', 'np4')
    val_pkl = write_videos(root, 8, 24, (32, 32), (16, 16), 'jpg', 'np4',
                           seed=1, name='val.pkl')
    jdir, tdir, t0dir = (str(tmp_path_factory.mktemp(n))
                         for n in ('jax', 'port', 'port0'))

    captured = []
    real_init = jax_train.init_state

    def init_state(*args, **kwargs):
        state = real_init(*args, **kwargs)
        # host copies: the JAX step donates (and deletes) the state
        captured.append(jax.tree.map(lambda x: np.array(x, copy=True), {
            'params': state.params, 'batch_stats': state.batch_stats,
            'moco_state': state.moco_state}))
        return state

    jax_train.init_state = init_state
    try:
        _seed()
        _, jstate = jax_train.train_model(
            JaxConfig.fromdict(tiny_pretrain_cfg(
                pkl, jdir, aug=dict(type='IdentityAug'), val_pkl=val_pkl)),
            validate=True, seed=0, mesh=create_mesh(1))
    finally:
        jax_train.init_state = real_init
    s0 = captured[0]

    cfg = tiny_pretrain_cfg(pkl, tdir, aug=dict(type='IdentityAug'),
                            val_pkl=val_pkl)
    model = build_model_from_cfg(cfg['model'], device='cpu')
    load_jax_variables(model, s0)
    opt = build_optimizer(model, dict(type='SGD', lr=0.0, momentum=0.9),
                          build_lr_schedule({}, 0.0, 1, 1),
                          freeze_patterns=MOCO_FREEZE)
    ckpt0 = save_checkpoint(train_state(model, opt), t0dir, 0)

    _seed()
    example = build_dataset(dict(cfg['data']['train']))
    for i in range(B):                   # JAX's example_batch_from draws
        example[i]
    runner, tmodel = train_model(Config.fromdict(cfg), validate=True,
                                 seed=0, device='cpu', resume_from=ckpt0)
    return dict(jstate=jstate, jlog=_log(jdir), tlog=_log(tdir),
                runner=runner, model=tmodel, tdir=tdir)


def test_every_logged_loss_matches(runs):
    jlog, tlog = runs['jlog'], runs['tlog']
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
                assert t[k] == j[k], k


def test_queues_and_counters_match(runs):
    want = jax_to_state_dict({'moco_state': runs['jstate'].moco_state})
    got = runs['model'].state_dict()
    for tower in TOWERS:
        np.testing.assert_allclose(got[f'{tower}.queue'].numpy(),
                                   want[f'{tower}.queue'], atol=2e-5,
                                   err_msg=f'{tower} queue')
        for name in ('count', 'queue_ptr', 'iters'):
            np.testing.assert_array_equal(got[f'{tower}.{name}'].numpy(),
                                          want[f'{tower}.{name}'],
                                          err_msg=f'{tower}.{name}')
    assert runs['runner'].optimizer.steps == int(runs['jstate'].step) == 4
    assert int(got['recognizer.iters']) == 4 * B
    assert int(got['recognizer_flow.iters']) == 8 * B   # two passes a step


def test_checkpoints_and_log(runs):
    tdir = runs['tdir']
    for name in ('epoch_1.pth', 'epoch_2.pth', 'epoch_2.pth.meta.json'):
        assert osp.exists(osp.join(tdir, name)), name
    assert open(osp.join(tdir, 'latest')).read() == 'epoch_2.pth'
