"""Checkpoints of the JAX package (``.ckpt``, flax msgpack) read by the
port, on the CPU, on tests/test_e2e_workloads.py's tiny configs:

- a tiny MSCL pretrain state and a tiny Recognizer3D state, saved by
  ``mscl_tpu.core.save_checkpoint``, read back by ``read_ckpt`` equal to
  ``flax.serialization.msgpack_restore`` leaf for leaf, with arrays over a
  lowered chunk size chunked; and through a work dir's ``latest``;
- fine-tune surgery (``apply_ssl_pretrain``) from the pretrain ``.ckpt``
  gives JAX's surgery's backbone, bitwise;
- resuming a run of the port from a ``.ckpt`` is refused by name.

The test CLI on a fine-tuned ``.ckpt`` is held to JAX's in
``tests/test_torch_finetune_train.py::test_test_cli_matches_jax``.
"""
import os.path as osp

import numpy as np
import pytest
import torch
from flax import serialization

import mscl_tpu.apis.train as jax_train
from mscl_tpu import Config as JaxConfig
from mscl_tpu.core import save_checkpoint as jax_save_checkpoint
from mscl_tpu.parallel.mesh import create_mesh
from mscl_torch.apis import apply_ssl_pretrain, build_model_from_cfg
from mscl_torch.config import Config
from mscl_torch.convert import jax_to_state_dict
from mscl_torch.core import load_checkpoint, restore_model_state
from mscl_torch.core.checkpoint import restore_train_state
from mscl_torch.core.jax_checkpoint import read_ckpt

from _torch_data_util import (one_torch_thread, register_tiny3d,  # noqa: F401
                              tiny_pretrain_cfg, write_videos)
from _torch_port_util import xla3d_conv  # noqa: F401
from test_torch_finetune_train import ft_cfg

pytestmark = pytest.mark.usefixtures('one_torch_thread')


def _jax_state(cfg):
    """mscl_tpu's TrainState for a config, as its train_model builds it
    (surgery included), captured before any step."""
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
    return captured[0]


@pytest.fixture(scope='module')
def ckpts(tmp_path_factory, xla3d_conv):
    """The JAX pretrain state saved with arrays over 4 KiB chunked, and the
    fine-tune state (its backbone from that file by JAX's surgery) saved
    as the JAX package saves it."""
    register_tiny3d()
    root = str(tmp_path_factory.mktemp('jax_ckpt'))
    pkl = write_videos(osp.join(root, 'videos'), 8, 24, (32, 32), (16, 16))
    pre = _jax_state(tiny_pretrain_cfg(pkl, osp.join(root, 'pre'),
                                       aug=dict(type='IdentityAug'),
                                       total_epochs=1))
    real = serialization.MAX_CHUNK_SIZE
    serialization.MAX_CHUNK_SIZE = 4096
    try:
        pre_ckpt = jax_save_checkpoint(serialization.to_state_dict(pre),
                                       osp.join(root, 'pre'), 1)
    finally:
        serialization.MAX_CHUNK_SIZE = real
    cfg = ft_cfg(dict(pkl=pkl, ckpt=pre_ckpt), 'unused')
    ft = _jax_state(cfg)
    ft_ckpt = jax_save_checkpoint(serialization.to_state_dict(ft),
                                  osp.join(root, 'ft'), 2)
    return dict(pre=pre_ckpt, ft=ft_ckpt, cfg=cfg,
                ft_vars={'params': ft.params,
                         'batch_stats': ft.batch_stats})


def _same_tree(a, b, path='ckpt'):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _same_tree(a[k], b[k], f'{path}/{k}')
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f'{path}[{i}]')
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert type(a) is type(b) and (a == b or a != a), (path, a, b)


@pytest.mark.parametrize('which', ['pre', 'ft'])
def test_read_matches_flax(ckpts, which):
    with open(ckpts[which], 'rb') as f:
        raw = f.read()
    want = serialization.msgpack_restore(raw)
    _same_tree(want, read_ckpt(ckpts[which]))
    if which == 'pre':       # the chunked form was written and is undone
        assert b'__msgpack_chunked_array__' in raw


def test_work_dir_latest_and_meta(ckpts):
    ckpt = load_checkpoint(osp.dirname(ckpts['ft']))
    assert ckpt['path'] == ckpts['ft'] and ckpt['meta'] == {'epoch': 2}
    want = jax_to_state_dict(ckpts['ft_vars'])
    assert sorted(ckpt['state_dict']) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(ckpt['state_dict'][k].numpy(), v,
                                      err_msg=k)
    model = build_model_from_cfg(
        {k: v for k, v in ckpts['cfg']['model'].items() if k != 'train_cfg'},
        device='cpu')
    restore_model_state(model, ckpt)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_surgery_from_ckpt_matches_jax(ckpts, capsys):
    """The port's surgery from the JAX pretrain .ckpt gives the backbone
    JAX's surgery gave (the fine-tune state saved in ``ft``)."""
    cfg = ckpts['cfg']
    model = build_model_from_cfg(cfg['model'], device='cpu')
    apply_ssl_pretrain(model, cfg['model']['train_cfg']['ssl_pretrain'])
    assert 'params not loaded' not in capsys.readouterr().out
    want = jax_to_state_dict(ckpts['ft_vars'])
    got = {k: v for k, v in model.state_dict().items()
           if k.startswith('backbone.')}
    assert got and sorted(got) == sorted(k for k in want
                                         if k.startswith('backbone.'))
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_resume_from_ckpt_is_refused(ckpts, tmp_path):
    from mscl_torch.apis import train_model
    cfg = Config.fromdict(dict(ckpts['cfg'], work_dir=str(tmp_path)))
    with pytest.raises(NotImplementedError, match='epoch_1.ckpt'):
        train_model(cfg, validate=False, seed=0, device='cpu',
                    resume_from=ckpts['pre'])
    model = build_model_from_cfg(
        {k: v for k, v in ckpts['cfg']['model'].items() if k != 'train_cfg'},
        device='cpu')
    with pytest.raises(NotImplementedError, match='does not resume'):
        restore_train_state(model, None, load_checkpoint(ckpts['ft']))
    assert not (tmp_path / 'log.json').exists()
