"""Every pretrain config the repo ships (configs/recognition/moco/) in
mscl_torch, against mscl_tpu:

- each file builds with ``Config.fromfile`` and ``build_model_from_cfg`` on
  the CPU at its own widths, with as many parameters as the JAX model of the
  same config (``jax.eval_shape``, no forward), and ``convert.py`` maps the
  JAX variables onto the port's state dict key for key and shape, with none
  left over on either side;
- ``train_model`` over 2 epochs of a tiny plain-MoCo config (MoCo on
  ``test.tiny3d``, MoCoTransform on JPEG frames, IdentityAug so that JAX's
  and the port's device draws do not enter) against JAX's ``train_model``:
  every logged loss within 2e-4, the queue within 2e-5, its counters exact;
- the same config with MoCoAugmentV2 (drawn from the port's own
  generator): 2 epochs straight against epoch 1's checkpoint resumed for
  the second, bitwise.
"""
import json
import os.path as osp
import random

import jax
import numpy as np
import pytest
import torch

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
                              write_videos)
from _torch_port_util import xla3d_conv  # noqa: F401
from test_torch_runner import (_assert_states_equal, _full_state,  # noqa: F401
                               epoch_seeded)

CONFIGS = ['moco_r18_consistent_augmentation_lr3e-2',
           'moco_r18_cosistent_video_lr3e-2', 'moco_r18_lr3e-2',
           'moco_r50_consistent_augmentation_lr3e-2', 'mscl_r18_cosm_lr2e-2',
           'mscl_r50_cosm_lr3e-2']
B = 4


def _model_cfg(name):
    return Config.fromfile(
        f'configs/recognition/moco/{name}.py').to_dict()['model']


def _example_batch(cfg, crop):
    """Two clips of the config's shapes (the flows for MSCL)."""
    imgs = [np.zeros((2, 3, 8, crop, crop), np.float32)] * 2
    if cfg['type'] != 'MSCLWithAug':
        return {'imgs': imgs}
    return {'imgs': imgs,
            'flow_imgs': [np.zeros((2, 2, 16, crop, crop), np.float32)] * 2}


@pytest.mark.parametrize('name', CONFIGS)
def test_config_builds_with_jax_shapes(name):
    cfg = _model_cfg(name)
    crop = 224 if 'r50' in name else 112
    model = build_model_from_cfg(cfg, device='cpu')
    shapes = jax.eval_shape(
        lambda: jax_train.build_model_from_cfg(cfg).init(
            {k: jax.random.PRNGKey(0) for k in ('params', 'dropout', 'moco')},
            _example_batch(cfg, crop), method='train_step'))
    n_jax = sum(int(np.prod(s.shape)) for s in
                jax.tree.leaves(shapes['params']))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), s.dtype),
                                                   s.shape), shapes)
    want = {k: v.shape for k, v in jax_to_state_dict(
        {c: zeros[c] for c in ('params', 'batch_stats', 'moco_state')}
    ).items()}
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k, shape in want.items():
        assert got[k] == shape, k
    queue = model.queue if cfg['type'] == 'MoCo' else model.recognizer.queue
    assert queue.shape == (128, 65536)


def test_r50_towers_are_resnet3d_and_r2d_50():
    model = build_model_from_cfg(_model_cfg('mscl_r50_cosm_lr3e-2'),
                                 device='cpu')
    rgb, flow = model.recognizer, model.recognizer_flow
    assert type(rgb.encoder_q).__name__ == 'ResNet3dSlowOnly'
    assert type(rgb).__name__ == type(flow).__name__ == 'MoCoV2'
    assert flow.encoder_q.layer4[-1].conv3[0].out_channels == 256
    assert model.sup_head.trans_flow.in_features == 256
    moco = build_model_from_cfg(_model_cfg('moco_r18_lr3e-2'), device='cpu')
    assert type(moco).__name__ == 'MoCo' and \
        type(moco.aug).__name__ == 'MoCoAugmentV2'


def test_refusals_name_what_is_not_ported():
    """shuffle_bn > 1 is refused; so is a tower's own aug inside
    MSCLWithAug, which the composite would never run."""
    cfg = _model_cfg('moco_r18_lr3e-2')
    with pytest.raises(NotImplementedError, match='shuffle_bn'):
        build_model_from_cfg(dict(cfg, shuffle_bn=2), device='cpu')
    cfg = _model_cfg('mscl_r18_cosm_lr2e-2')
    cfg['recognizer'] = dict(cfg['recognizer'], aug=dict(
        type='MoCoAugmentV2', crop_size=112))
    with pytest.raises(NotImplementedError, match='MoCoAugmentV2'):
        build_model_from_cfg(cfg, device='cpu')


def tiny_moco_cfg(pkl, work_dir, aug, val_pkl=None, total_epochs=2):
    """A plain-MoCo config as the shipped ones, cut to test.tiny3d, 16x16
    crops, K=16 and a global batch of 4; validation by loss every epoch
    with ``val_pkl``."""
    pipeline = [
        dict(type='SampleFrames', clip_len=8, frame_interval=2, num_clips=1),
        dict(type='LocalDecode'),
        dict(type='MoCoTransform',
             crop_transform=dict(size=(16, 16), scale=(0.2, 1))),
        dict(type='Collect', keys=['imgs'], meta_keys=[]),
        dict(type='ToTensor', keys=['imgs'], batched=True)]
    data = dict(videos_per_gpu=B, workers_per_gpu=0,
                train=dict(type='FileRawframeDataset', pkl_path=pkl,
                           pipeline=pipeline),
                train_dataloader=dict(drop_last=True),
                val_dataloader=dict(drop_last=True))
    cfg = dict(
        model=dict(type='MoCo', backbone=dict(type='test.tiny3d'),
                   neck=dict(type='BaseMoCo'),
                   moco_head=dict(type='MoCoHead', loss_cls=dict(
                       type='CrossEntropyLoss_torch', ignore_index=-1)),
                   im_key='imgs', dim_in=64, dim=16, K=16, m=0.99, T=0.07,
                   mlp=True, aux_info=[], aug=dict(aug)),
        data=data,
        optimizer=dict(type='SGD', lr=0.03, momentum=0.9, weight_decay=1e-4),
        optimizer_config=dict(grad_clip=dict(max_norm=40, norm_type=2)),
        lr_config=dict(policy='CosineAnnealing', min_lr=0),
        total_epochs=total_epochs, checkpoint_config=dict(interval=1),
        log_config=dict(interval=1), work_dir=work_dir)
    if val_pkl is not None:
        data['val'] = dict(data['train'], pkl_path=val_pkl)
        cfg['evaluation'] = dict(interval=1, simple=True)
    return cfg


def _seed():
    random.seed(0)
    np.random.seed(0)


def _log(work_dir):
    with open(osp.join(work_dir, 'log.json')) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope='module')
def videos(tmp_path_factory):
    register_tiny3d()
    root = str(tmp_path_factory.mktemp('videos'))
    return (write_videos(root, 8, 24, (32, 32), (16, 16), 'jpg', 'npy'),
            write_videos(root, 8, 24, (32, 32), (16, 16), 'jpg', 'npy',
                         seed=1, name='val.pkl'))


@pytest.fixture(scope='module')
def runs(videos, tmp_path_factory, xla3d_conv, one_torch_thread):
    pkl, val_pkl = videos
    jdir, tdir, t0dir = (str(tmp_path_factory.mktemp(n))
                         for n in ('jax', 'port', 'port0'))
    aug = dict(type='IdentityAug')
    captured = []
    real_init = jax_train.init_state

    def init_state(*args, **kwargs):
        state = real_init(*args, **kwargs)
        captured.append(jax.tree.map(lambda x: np.array(x, copy=True), {
            'params': state.params, 'batch_stats': state.batch_stats,
            'moco_state': state.moco_state}))
        return state

    jax_train.init_state = init_state
    try:
        _seed()
        _, jstate = jax_train.train_model(
            JaxConfig.fromdict(tiny_moco_cfg(pkl, jdir, aug, val_pkl)),
            validate=True, seed=0, mesh=create_mesh(1))
    finally:
        jax_train.init_state = real_init

    cfg = tiny_moco_cfg(pkl, tdir, aug, val_pkl)
    model = build_model_from_cfg(cfg['model'], device='cpu')
    load_jax_variables(model, captured[0])
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
                runner=runner, model=tmodel)


def test_train_model_losses_match(runs):
    jlog, tlog = runs['jlog'], runs['tlog']
    assert [r['mode'] for r in tlog] == [r['mode'] for r in jlog] == \
        ['train', 'train', 'val'] * 2
    for j, t in zip(jlog, tlog):
        assert sorted(j) == sorted(t)
        for k in j:
            if k in ('time', 'data_time'):
                continue
            if k.startswith('loss') or k == 'lr' or 'acc' in k:
                np.testing.assert_allclose(t[k], j[k], rtol=2e-4, atol=2e-4,
                                           err_msg=f'{t["mode"]} {k}')
            else:
                assert t[k] == j[k], k


def test_train_model_queue_matches(runs):
    want = jax_to_state_dict({'moco_state': runs['jstate'].moco_state})
    got = runs['model'].state_dict()
    np.testing.assert_allclose(got['queue'].numpy(), want['queue'],
                               atol=2e-5)
    for name in ('count', 'queue_ptr', 'iters'):
        np.testing.assert_array_equal(got[name].numpy(), want[name],
                                      err_msg=name)
    assert runs['runner'].optimizer.steps == int(runs['jstate'].step) == 4
    assert int(got['iters']) == 4 * B


def test_resume_with_own_aug_is_exact(videos, tmp_path, one_torch_thread,
                                     epoch_seeded):
    """MoCoAugmentV2 from the model's generator: 2 epochs straight against
    epoch 1's checkpoint resumed for the second, bitwise (parameters,
    buffers, momentum, steps, the aug generator) and the same losses (the
    host crops seeded by epoch, as tests/test_torch_runner.py does)."""
    pkl, _ = videos
    register_tiny3d()
    aug = dict(type='MoCoAugmentV2', crop_size=16)
    cfgs = [Config.fromdict(tiny_moco_cfg(pkl, str(tmp_path / d), aug))
            for d in ('a', 'c')]
    _seed()
    straight, _ = train_model(cfgs[0], validate=False, seed=0, device='cpu')
    _seed()
    resumed, _ = train_model(cfgs[1], validate=False, seed=0, device='cpu',
                             resume_from=str(tmp_path / 'a' / 'epoch_1.pth'))
    assert straight.optimizer.steps == resumed.optimizer.steps == 4
    _assert_states_equal(_full_state(straight), _full_state(resumed))
    a, c = _log(str(tmp_path / 'a')), _log(str(tmp_path / 'c'))
    assert [r['loss'] for r in a[2:]] == [r['loss'] for r in c]
    assert torch.isfinite(torch.tensor([r['loss'] for r in a])).all()
