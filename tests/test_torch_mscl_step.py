"""The whole slice: two consecutive MSCLWithAug train steps of mscl_torch
against two of mscl_tpu (make_train_step with the EMA pre-update, SGD with
momentum, weight decay and the global-norm clip), on the CPU at B=4, T=8,
HW=32, K=32, with the RGB tower on TPNMoCo (FPN + SEPC).

The second step is the one that catches a queue aliasing fault: it reads the
queues, counts and pointers the first step left, and its flow FRA pass reads
what its base pass just enqueued. The queue pointers start 8 short of K, so
the second step's enqueue wraps to 0; counts and iters start non-zero, so
the decay and the cosine momentum are not at their trivial values.
"""
import jax
import numpy as np
import pytest
import torch

from mscl_tpu.apis.train import build_model_from_cfg as jax_build
from mscl_tpu.core import build_lr_schedule as jax_lr
from mscl_tpu.core import build_optimizer as jax_optimizer
from mscl_tpu.core import init_state
from mscl_tpu.core import make_train_step as jax_step
from mscl_tpu.models.recognizers import build_ema_fn as jax_ema
from mscl_tpu.models.recognizers import sync_key_variables
from mscl_torch.apis import (MOCO_FREEZE, build_model_from_cfg,
                             flagship_batch, narrow_flagship_cfg, to_torch)
from mscl_torch.convert import jax_to_state_dict, load_jax_variables
from mscl_torch.core import build_lr_schedule, build_optimizer, \
    make_train_step
from mscl_torch.models.recognizers import build_ema_fn

from _torch_port_util import xla3d_conv  # noqa: F401

B, T, HW, K, DIM = 4, 8, 32, 32, 32
RGB_W, FLOW_W = 8, 2        # TPN out_channels == flow stage-4 width == 16
LR = 0.02
MAX_NORM = 2.0              # low enough that the clip acts on these grads
LOSS_KEYS = ['loss_cls', 'loss_cls_flow', 'loss_cls_flow_aug', 'loss_cls_mx',
             'loss_cls_mx_r', 'loss_cls_mx_aug', 'loss_cls_mx_r_aug',
             'loss_pos']
TOWERS = ('recognizer', 'recognizer_flow')


def _start_state(variables):
    """Sync k <- q, then de-sync the key side and age the queues so the
    EMA, the decay and the momentum schedule all do real work."""
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
                              flow_width=FLOW_W, num_frames=T)
    batches = [flagship_batch(B, num_frames=T, hw=HW, seed=s)
               for s in (11, 12)]

    jmodel = jax_build(cfg)
    tx = jax_optimizer(_opt_cfg(), jax_lr(*_lr_cfg()),
                       grad_clip=dict(max_norm=MAX_NORM),
                       freeze_patterns=MOCO_FREEZE)
    state = init_state(jmodel, tx, batches[0], post_init_fn=_start_state)
    step = jax.jit(jax_step(jmodel, tx, jax_ema(jmodel)))
    jstates, jlogs = [state], []
    for batch in batches:
        state, log_vars = step(state, batch)
        jstates.append(state)
        jlogs.append(jax.device_get(log_vars))

    model = build_model_from_cfg(cfg, device='cpu')
    s0 = jstates[0]
    load_jax_variables(model, {'params': s0.params,
                               'batch_stats': s0.batch_stats,
                               'moco_state': s0.moco_state})
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
    return dict(jstates=jstates, jlogs=jlogs, tstates=tstates, tlogs=tlogs,
                model=model, opt=opt, batches=batches)


def _jax_sd(state):
    return jax_to_state_dict({'params': state.params,
                              'batch_stats': state.batch_stats,
                              'moco_state': state.moco_state})


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
    # flow runs twice a step (iters +2B) and enqueues once; ptr wraps to 0
    assert int(got['recognizer.queue_ptr']) == (K - 2 * B + (step + 1) * B) % K
    assert int(got['recognizer_flow.iters']) == 600 + 2 * B * (step + 1)
    assert int(got['recognizer.iters']) == 300 + B * (step + 1)


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
    """The key towers, twice EMA'd (the flow tower with m**2)."""
    start = _jax_sd(runs['jstates'][0])
    keys = _compare(runs, lambda k: any(f'.{p}.' in k for p in MOCO_FREEZE)
                    and 'running' not in k, rtol=1e-5, atol=1e-6)
    assert any(not np.allclose(start[k], runs['tstates'][1][k].numpy())
               for k in keys)


def test_bn_running_stats_match(runs):
    _compare(runs, lambda k: 'running' in k, rtol=1e-4, atol=1e-5)


def test_sgd_updated_params_match(runs):
    keys = _compare(runs, lambda k: '_q.' in k and 'running' not in k,
                    rtol=5e-3, atol=1e-4)
    start = _jax_sd(runs['jstates'][0])
    want, got = _jax_sd(runs['jstates'][2]), runs['tstates'][1]
    for k in keys:    # the updates themselves, relative to the lr
        np.testing.assert_allclose(
            (got[k].numpy() - start[k]) / LR, (want[k] - start[k]) / LR,
            rtol=5e-3, atol=2e-3, err_msg=f'{k} update')


def test_clip_acted(runs):
    """MAX_NORM is below this batch's gradient norm, so the update path
    with the clip is the one compared above."""
    model, opt = runs['model'], runs['opt']
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    opt.zero_grad()
    model.train_step(to_torch(runs['batches'][0], 'cpu'))[0].backward()
    norm = torch.linalg.vector_norm(torch.stack(
        [p.grad.norm() for p in opt.params if p.grad is not None]))
    model.load_state_dict(saved)
    opt.zero_grad()
    assert norm > MAX_NORM


def test_validation_step_changes_nothing(runs):
    """update=False gives the losses the next training step would and
    leaves every parameter and buffer as it was."""
    model, opt = runs['model'], runs['opt']
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = to_torch(runs['batches'][1], 'cpu')
    val = make_train_step(model, None, build_ema_fn(model), update=False)(
        batch)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    steps = opt.steps
    trained = make_train_step(model, opt, build_ema_fn(model))(batch)
    for k in LOSS_KEYS:
        torch.testing.assert_close(val[k], trained[k], rtol=1e-6, atol=1e-6)
    assert opt.steps == steps + 1
