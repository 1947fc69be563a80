"""Two consecutive train steps of a model config in mscl_torch against
mscl_tpu's (make_train_step with the EMA pre-update, SGD with momentum,
weight decay and the global-norm clip), from the same converted weights,
with the device aug's draws replayed from JAX's key.

As tests/test_torch_mscl_step_aug.py: the JAX aug's key is captured inside
the jitted step (its ``__call__`` wrapped with ``jax.debug.callback``), JAX's
draws are replayed from it (tests/_torch_aug_util.py) and handed to the
port's aug through its draw/apply split. ShuffleBN's permutations are
captured the same way (``jax.random.permutation`` wrapped, in program
order) and handed to each tower's ``draw_shuffle``. The start state syncs the key side
to the query side and then moves it, its queues and its counters off their
trivial values, so the EMA, the decay and the momentum do real work and the
second step's enqueue wraps to 0. With ``x64`` the JAX step runs in float64
(x64 on, the model's dtype float64, flax's nn.BatchNorm through
MSCL_BN_IMPL=flax; its parameters stay float32), the reference for inputs
on which JAX's float32 BN statistics are ill-conditioned, and the port in
float32 is held to it; the aug runs in float32 in both (its colour wheel
floors at exact ties, which float64 breaks otherwise), its draws replayed
as JAX drew them under x64 and handed to the port in float32. Tolerances (ROADMAP.md): losses 2e-4,
queues 2e-5 (count, queue_ptr, iters exact), EMA 1e-5, BN statistics 1e-4,
SGD-updated query parameters rtol 5e-3, atol 1e-4.
"""
import contextlib
import os

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
from mscl_torch.apis import MOCO_FREEZE, build_model_from_cfg, to_torch
from mscl_torch.convert import jax_to_state_dict, load_jax_variables
from mscl_torch.core import build_lr_schedule, build_optimizer, \
    make_train_step
from mscl_torch.models.recognizers import build_ema_fn

LR, MAX_NORM = 0.02, 2.0     # the clip acts on these gradients


def _lr_cfg():
    return dict(policy='CosineAnnealing', min_lr=0), LR, 400, 100


def _opt_cfg():
    return dict(type='SGD', lr=LR, momentum=0.9, weight_decay=1e-4)


def _moved(ms, K, B, iters, rng):
    # under x64 the enqueue's literal 0 index is int64, and
    # dynamic_update_slice wants the pointer of the same type
    ptr = np.int64 if jax.config.jax_enable_x64 else np.int32
    return dict(ms, queue_ptr=ptr(K - 2 * B),
                count=rng.integers(0, 500, size=(K,)).astype(np.int32),
                iters=np.int32(iters))


def start_state(K, B):
    """post_init_fn for init_state: k <- q, then the key side, the queues
    and the counters moved (a tower on its own, or each of a composite's)."""
    def fn(variables):
        variables = sync_key_variables(variables)

        def move_keys(tower):
            tower = dict(tower)
            for kn in ('encoder_k', 'mlp_k', 'neck_k'):
                if kn in tower:
                    tower[kn] = jax.tree.map(lambda x: x * 1.02 + 0.001,
                                             tower[kn])
            return tower
        rng = np.random.default_rng(7)
        params, ms = variables['params'], variables['moco_state']
        if 'encoder_q' in params:
            params, ms = move_keys(params), _moved(ms, K, B, 300, rng)
        else:
            params = {n: move_keys(p) for n, p in params.items()}
            ms = {n: _moved(s, K, B, 300 if n == 'recognizer_m' else 600,
                            rng) for n, s in ms.items()}
        return dict(variables, params=params, moco_state=ms)
    return fn


def replay(aug_type, model_aug, key, B, T):
    """The port-layout draws of JAX's aug call with ``key``."""
    if aug_type == 'MoCoAugmentV2':
        return draws.moco(draws.moco_v2_clips, jax.numpy.asarray(key), B * T)
    return draws.sync_v5(model_aug, jax.numpy.asarray(key), B, T)


@contextlib.contextmanager
def jax_float64():
    """x64 on and flax's nn.BatchNorm (float64 statistics) for the models
    built inside."""
    prev = os.environ.get('MSCL_BN_IMPL')
    os.environ['MSCL_BN_IMPL'] = 'flax'
    try:
        with jax.enable_x64(True):
            yield
    finally:
        if prev is None:
            del os.environ['MSCL_BN_IMPL']
        else:
            os.environ['MSCL_BN_IMPL'] = prev


def _float32(tree):
    if isinstance(tree, dict):
        return {k: _float32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_float32(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float64:
        return tree.float()
    return tree


def two_steps(cfg, batches, K, B, T, x64=False):
    """Two JAX steps and two port steps of ``cfg`` from the same start on
    the same batches and aug draws (JAX in float64 with ``x64``). Returns
    JAX's states and logs and the port's state dicts and logs."""
    aug_type = cfg['aug']['type']
    keys, perms = [], []
    aug_cls = getattr(jax_ssl_aug, aug_type)
    call = aug_cls.__call__
    permutation = jax.random.permutation

    def recording_call(self, rng, *args, **kwargs):
        jax.debug.callback(lambda k: keys.append(np.asarray(k)), rng)
        if not x64:
            return call(self, rng, *args, **kwargs)
        # the aug in float32, as the port's float32 model runs it: in
        # float64 the wheel's floor lands otherwise at exact ties
        to32 = jax.tree.map(lambda a: a.astype(np.float32) if a.dtype ==
                            np.float64 else a, (args, kwargs))
        dt = jax.numpy.float64
        return jax.tree.map(lambda a: a.astype(dt) if a.dtype == np.float32
                            else a, call(self, rng, *to32[0], **to32[1]))

    def recording_permutation(key, x, *args, **kwargs):
        out = permutation(key, x, *args, **kwargs)
        jax.debug.callback(lambda p: perms.append(np.asarray(p)), out,
                           ordered=True)
        return out

    model = build_model_from_cfg(cfg, device='cpu')
    precision = jax_float64() if x64 else contextlib.nullcontext()
    with pytest.MonkeyPatch.context() as mp, precision:
        mp.setattr(aug_cls, '__call__', recording_call)
        mp.setattr(jax.random, 'permutation', recording_permutation)
        jmodel = jax_build(cfg, dtype=jax.numpy.float64 if x64 else None)
        tx = jax_optimizer(_opt_cfg(), jax_lr(*_lr_cfg()),
                           grad_clip=dict(max_norm=MAX_NORM),
                           freeze_patterns=MOCO_FREEZE)
        state = init_state(jmodel, tx, batches[0],
                           post_init_fn=start_state(K, B))
        step = jax.jit(jax_step(jmodel, tx, jax_ema(jmodel)))
        jax.effects_barrier()
        del keys[:]                           # the init's own aug call
        del perms[:]
        jstates, jlogs = [state], []
        for batch in batches:
            state, log_vars = step(state, batch)
            jstates.append(state)
            jlogs.append(jax.device_get(log_vars))
        jax.effects_barrier()
        replayed = [_float32(replay(aug_type, model.aug, k, B, T))
                    for k in keys]
    assert len(keys) == len(batches), len(keys)

    s0 = jstates[0]
    load_jax_variables(model, {'params': s0.params,
                               'batch_stats': s0.batch_stats,
                               'moco_state': s0.moco_state})
    model.aug.draw = lambda gen, im_q, im_k, aux_info=None: replayed.pop(0)
    for _, tower in towers(model):
        tower.draw_shuffle = \
            lambda gen, b, device: torch.from_numpy(perms.pop(0)).long()
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
    assert not replayed and not perms
    return dict(jstates=jstates, jlogs=jlogs, tstates=tstates, tlogs=tlogs,
                model=model, opt=opt)


def towers(model):
    """(prefix, tower) of each MoCo tower of a model."""
    if hasattr(model, 'recognizer'):
        return (('recognizer.', model.recognizer),
                ('recognizer_flow.', model.recognizer_flow))
    return (('', model),)


def jax_sd(state):
    return jax_to_state_dict({'params': state.params,
                              'batch_stats': state.batch_stats,
                              'moco_state': state.moco_state})


def check_losses(runs, step):
    jl, tl = runs['jlogs'][step], runs['tlogs'][step]
    assert sorted(tl) == sorted(jl)
    for k in jl:
        np.testing.assert_allclose(tl[k], float(jl[k]), rtol=2e-4, atol=2e-4,
                                   err_msg=f'step {step + 1} {k}')


def check_queues(runs, step, prefixes):
    want = jax_sd(runs['jstates'][step + 1])
    got = runs['tstates'][step]
    for p in prefixes:
        np.testing.assert_allclose(got[f'{p}queue'].numpy(),
                                   want[f'{p}queue'], atol=2e-5,
                                   err_msg=f'{p}queue')
        for name in ('count', 'queue_ptr', 'iters'):
            np.testing.assert_array_equal(got[f'{p}{name}'].numpy(),
                                          want[f'{p}{name}'],
                                          err_msg=f'{p}{name}')


def compare(runs, select, rtol, atol):
    """The state after both steps, on the keys ``select`` picks."""
    want = jax_sd(runs['jstates'][2])
    got = runs['tstates'][1]
    keys = [k for k in want if select(k)]
    assert keys
    assert sorted(want) == sorted(got)
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=rtol,
                                   atol=atol, err_msg=k)
    return keys


def is_key_side(k):
    return any(k.startswith(f'{p}.') or f'.{p}.' in k for p in MOCO_FREEZE)


def check_ema(runs):
    start = jax_sd(runs['jstates'][0])
    keys = compare(runs, lambda k: is_key_side(k) and 'running' not in k,
                   rtol=1e-5, atol=1e-6)
    assert any(not np.allclose(start[k], runs['tstates'][1][k].numpy())
               for k in keys)


def check_bn_stats(runs):
    compare(runs, lambda k: 'running' in k, rtol=1e-4, atol=1e-4)


def check_sgd(runs):
    keys = compare(runs, lambda k: ('encoder_q' in k or 'mlp_q' in k or
                                    'neck_q' in k or 'sup_head' in k)
                   and 'running' not in k, rtol=5e-3, atol=1e-4)
    start = jax_sd(runs['jstates'][0])
    want, got = jax_sd(runs['jstates'][2]), runs['tstates'][1]
    for k in keys:    # the updates themselves, relative to the lr
        np.testing.assert_allclose(
            (got[k].numpy() - start[k]) / LR, (want[k] - start[k]) / LR,
            rtol=5e-3, atol=2e-3, err_msg=f'{k} update')
