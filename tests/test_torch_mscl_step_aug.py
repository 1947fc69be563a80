"""Two consecutive MSCLWithAug train steps with the flagship's device aug,
SyncMoCoAugmentV5 (flow visualised: a 3-channel flow stem), in mscl_torch
against mscl_tpu, on the CPU at B=4, T=8, HW=32, flow 16x16, K=32.

torch cannot replay jax.random. The JAX aug's key is captured inside the
jitted step (its __call__ wrapped here with jax.debug.callback); the test
replays JAX's draws from it (tests/_torch_aug_util.py) and hands them to the
port through its draw/apply split, by replacing the draw of this model's aug
instance. Everything else is tests/test_torch_mscl_step.py's set-up, and its
tolerances: losses 2e-4, queues 2e-5, EMA 1e-5, BN statistics 1e-4, query
towers 5e-3.
"""
import jax
import numpy as np
import pytest
import torch

import _torch_aug_util as draws
from mscl_tpu.apis.train import build_model_from_cfg as jax_build
from mscl_tpu.core import build_lr_schedule as jax_lr
from mscl_tpu.core import build_optimizer as jax_optimizer
from mscl_tpu.core import init_state
from mscl_tpu.core import make_train_step as jax_step
from mscl_tpu.models.common import ssl_aug as jax_ssl_aug
from mscl_tpu.models.recognizers import build_ema_fn as jax_ema
from mscl_tpu.models.recognizers import sync_key_variables
from mscl_torch.apis import (FLAGSHIP_AUG, MOCO_FREEZE, build_model_from_cfg,
                             flagship_batch, narrow_flagship_cfg, to_torch)
from mscl_torch.convert import jax_to_state_dict, load_jax_variables
from mscl_torch.core import build_lr_schedule, build_optimizer, \
    make_train_step
from mscl_torch.models.recognizers import build_ema_fn

from _torch_port_util import xla3d_conv  # noqa: F401

B, T, HW, FLOW_HW, K, DIM = 4, 8, 32, 16, 32, 32
RGB_W, FLOW_W = 8, 2
LR = 0.02
MAX_NORM = 2.0
AUG = dict(FLAGSHIP_AUG, crop_size=HW)
LOSS_KEYS = ['loss_cls', 'loss_cls_flow', 'loss_cls_flow_aug', 'loss_cls_mx',
             'loss_cls_mx_r', 'loss_cls_mx_aug', 'loss_cls_mx_r_aug',
             'loss_pos']
TOWERS = ('recognizer', 'recognizer_flow')


def _start_state(variables):
    """As tests/test_torch_mscl_step.py: k <- q, then the key side and the
    queues moved off their trivial values."""
    variables = sync_key_variables(variables)
    params = {}
    for name, tower in variables['params'].items():
        tower = dict(tower)
        for kn in ('encoder_k', 'mlp_k', 'neck_k'):
            if kn in tower:
                tower[kn] = jax.tree.map(lambda x: x * 1.02 + 0.001,
                                         tower[kn])
        params[name] = tower
    rng = np.random.default_rng(7)
    moco = {}
    for name, ms in variables['moco_state'].items():
        moco[name] = dict(
            ms, queue_ptr=np.int32(K - 2 * B),
            count=rng.integers(0, 500, size=(K,)).astype(np.int32),
            iters=np.int32(300 if name == 'recognizer_m' else 600))
    return dict(variables, params=params, moco_state=moco)


def _lr_cfg():
    return dict(policy='CosineAnnealing', min_lr=0), LR, 400, 100


def _opt_cfg():
    return dict(type='SGD', lr=LR, momentum=0.9, weight_decay=1e-4)


@pytest.fixture(scope='module')
def runs(xla3d_conv):
    cfg = narrow_flagship_cfg(K=K, dim=DIM, rgb_width=RGB_W,
                              flow_width=FLOW_W, num_frames=T, aug=AUG)
    batches = [flagship_batch(B, num_frames=T, hw=HW, flow_hw=FLOW_HW,
                              seed=s) for s in (21, 22)]

    keys = []
    call = jax_ssl_aug.SyncMoCoAugmentV5.__call__

    def recording_call(self, rng, im_q, im_k, aux_info):
        jax.debug.callback(lambda k: keys.append(np.asarray(k)), rng)
        return call(self, rng, im_q, im_k, aux_info)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ssl_aug.SyncMoCoAugmentV5, '__call__', recording_call)
        jmodel = jax_build(cfg)
        tx = jax_optimizer(_opt_cfg(), jax_lr(*_lr_cfg()),
                           grad_clip=dict(max_norm=MAX_NORM),
                           freeze_patterns=MOCO_FREEZE)
        state = init_state(jmodel, tx, batches[0], post_init_fn=_start_state)
        step = jax.jit(jax_step(jmodel, tx, jax_ema(jmodel)))
        jax.effects_barrier()
        del keys[:]                           # the init's own aug call
        jstates, jlogs = [state], []
        for batch in batches:
            state, log_vars = step(state, batch)
            jstates.append(state)
            jlogs.append(jax.device_get(log_vars))
        jax.effects_barrier()
    assert len(keys) == 2, len(keys)

    model = build_model_from_cfg(cfg, device='cpu')
    s0 = jstates[0]
    load_jax_variables(model, {'params': s0.params,
                               'batch_stats': s0.batch_stats,
                               'moco_state': s0.moco_state})
    replayed = [draws.sync_v5(model.aug, jax.numpy.asarray(k), B, T)
                for k in keys]
    model.aug.draw = lambda gen, im_q, im_k, aux_info=None: replayed.pop(0)
    opt = build_optimizer(model, _opt_cfg(), build_lr_schedule(*_lr_cfg()),
                          grad_clip=dict(max_norm=MAX_NORM),
                          freeze_patterns=MOCO_FREEZE)
    tstep = make_train_step(model, opt, build_ema_fn(model))
    tstates, tlogs = [], []
    for batch in batches:
        tlogs.append({k: v.item() for k, v in
                      tstep(to_torch(batch, 'cpu')).items()})
        tstates.append({k: v.clone() for k, v in
                        model.state_dict().items()})
    assert not replayed
    return dict(jstates=jstates, jlogs=jlogs, tstates=tstates, tlogs=tlogs,
                model=model)


def _jax_sd(state):
    return jax_to_state_dict({'params': state.params,
                              'batch_stats': state.batch_stats,
                              'moco_state': state.moco_state})


def test_flow_stem_takes_the_colour_wheel(runs):
    stem = runs['model'].recognizer_flow.encoder_q.stem[0]
    assert stem.weight.shape[1] == 3
    assert _jax_sd(runs['jstates'][0])[
        'recognizer_flow.encoder_q.stem.0.weight'].shape[1] == 3


@pytest.mark.parametrize('step', [0, 1])
def test_losses_match(runs, step):
    jl, tl = runs['jlogs'][step], runs['tlogs'][step]
    for k in LOSS_KEYS + ['loss']:
        np.testing.assert_allclose(tl[k], float(jl[k]), rtol=2e-4, atol=2e-4,
                                   err_msg=f'step {step + 1} {k}')
    assert sorted(tl) == sorted(jl)


@pytest.mark.parametrize('step', [0, 1])
def test_queue_state_matches(runs, step):
    want = _jax_sd(runs['jstates'][step + 1])
    got = runs['tstates'][step]
    for tower in TOWERS:
        np.testing.assert_allclose(got[f'{tower}.queue'].numpy(),
                                   want[f'{tower}.queue'], atol=2e-5,
                                   err_msg=f'{tower} queue')
        for name in ('count', 'queue_ptr', 'iters'):
            np.testing.assert_array_equal(got[f'{tower}.{name}'].numpy(),
                                          want[f'{tower}.{name}'],
                                          err_msg=f'{tower}.{name}')


def _compare(runs, select, rtol, atol):
    want = _jax_sd(runs['jstates'][2])
    got = runs['tstates'][1]
    keys = [k for k in want if select(k)]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=rtol,
                                   atol=atol, err_msg=k)
    return keys


def test_ema_key_params_match(runs):
    _compare(runs, lambda k: any(f'.{p}.' in k for p in MOCO_FREEZE)
             and 'running' not in k, rtol=1e-5, atol=1e-6)


def test_bn_running_stats_match(runs):
    _compare(runs, lambda k: 'running' in k, rtol=1e-4, atol=1e-5)


def test_sgd_updated_params_match(runs):
    keys = _compare(runs, lambda k: '_q.' in k and 'running' not in k,
                    rtol=5e-3, atol=1e-4)
    start = _jax_sd(runs['jstates'][0])
    want, got = _jax_sd(runs['jstates'][2]), runs['tstates'][1]
    for k in keys:
        np.testing.assert_allclose(
            (got[k].numpy() - start[k]) / LR, (want[k] - start[k]) / LR,
            rtol=5e-3, atol=2e-3, err_msg=f'{k} update')


def test_aug_draws_from_the_model_generator():
    """Unpatched, the step draws from the model's generator on the batch's
    device, seeded by build_model_from_cfg: the same seed gives the same
    step, another seed another."""
    cfg = narrow_flagship_cfg(K=K, dim=DIM, rgb_width=RGB_W,
                              flow_width=FLOW_W, num_frames=T, aug=AUG)
    batch = flagship_batch(B, num_frames=T, hw=HW, flow_hw=FLOW_HW, seed=23)
    losses = []
    for seed in (5, 5, 6):
        model = build_model_from_cfg(cfg, device='cpu', seed=5)
        model.seed_aug(seed)
        with torch.no_grad():
            _, log_vars = model.train_step(to_torch(batch, 'cpu'))
        losses.append(float(log_vars['loss']))
        assert model.aug_generator(torch.device('cpu')).device.type == 'cpu'
    assert losses[0] == losses[1] != losses[2]
