"""The bfloat16 compute dtype of the port against the JAX package's, on the
CPU: LowPrecisionBatchNorm (mscl_tpu/ops/split_bn.py) alone, then one narrow
MSCLWithAug train step (IdentityAug: the towers; B=4, T=8, HW=32, flow
16x16, K=32) built with dtype=bfloat16 on both sides, from the same state
and batch.

Two bf16 computations round at different places (XLA fuses, torch rounds
each op), so the step is held by distance. For the losses (the largest gap
over the nine), each queue (its largest entry gap) and the updates of the
query towers (all of them as one vector, relative to the lr, in L2 norm),
the port's bf16 result is no further from JAX's bf16 result than JAX's bf16
result is from JAX's float32 one on the same inputs (the rounding the dtype
brings). And within an absolute bound: each loss 0.05, each queue entry
0.02, each parameter's update relative to the lr 1.0 (JAX's own bf16
updates are up to 0.77 off its float32 ones here). One loss or one
tensor alone is not held to the gap: where bf16 happens to land near float32
the gap is a rounding's luck, smaller than the port's own rounding.
BN alone: forward within one bf16 rounding of the output (2^-7 relative
plus 2^-7 absolute), running statistics 1e-5, grads 2e-2 relative.
"""
import jax
import jax.numpy as jnp
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
from mscl_tpu.ops.split_bn import LowPrecisionBatchNorm as JaxLPBN
from mscl_torch.apis import (MOCO_FREEZE, build_model_from_cfg,
                             flagship_batch, narrow_flagship_cfg, to_torch)
from mscl_torch.convert import jax_to_state_dict, load_jax_variables
from mscl_torch.core import build_lr_schedule, build_optimizer, \
    make_train_step
from mscl_torch.models.recognizers import build_ema_fn
from mscl_torch.ops.batch_norm import LowPrecisionBatchNorm

from _torch_port_util import xla3d_conv  # noqa: F401

B, T, HW, FLOW_HW, K, DIM = 4, 8, 32, 16, 32, 32
LR = 0.02
LOSS_KEYS = ['loss_cls', 'loss_cls_flow', 'loss_cls_flow_aug', 'loss_cls_mx',
             'loss_cls_mx_r', 'loss_cls_mx_aug', 'loss_cls_mx_r_aug',
             'loss_pos']
TOWERS = ('recognizer', 'recognizer_flow')
LOSS_ABS, QUEUE_ABS, UPDATE_ABS = 0.05, 0.02, 1.0
BF16_EPS = 2.0 ** -7


# --------------------------------------------------------------------- BN
@pytest.mark.parametrize('train', [True, False])
def test_low_precision_bn_matches_jax(train):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 6, 3, 5, 7)) * 2 + 0.5).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    mean = rng.normal(size=6).astype(np.float32) * 0.1
    var = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    to_nthwc = (0, 2, 3, 4, 1)

    bn = JaxLPBN(use_running_average=not train, momentum=0.9, epsilon=1e-5,
                 dtype=jnp.bfloat16)
    variables = {'params': {'scale': scale, 'bias': bias},
                 'batch_stats': {'mean': mean, 'var': var}}
    xj = jnp.asarray(x.transpose(to_nthwc)).astype(jnp.bfloat16)

    def f(params, xin):
        return bn.apply(dict(variables, params=params), xin,
                        mutable=['batch_stats'])
    (yj, new_vars), vjp = jax.vjp(f, variables['params'], xj)
    g_params, g_x = vjp((jnp.asarray(dy.transpose(to_nthwc))
                         .astype(jnp.bfloat16), jax.tree.map(
                             jnp.zeros_like, new_vars)))

    tbn = LowPrecisionBatchNorm(6, torch.bfloat16)
    tbn.train(train)
    with torch.no_grad():
        for name, v in (('weight', scale), ('bias', bias),
                        ('running_mean', mean), ('running_var', var)):
            getattr(tbn, name).copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    yt = tbn(xt)
    yt.backward(torch.from_numpy(dy).bfloat16())

    assert yt.dtype == torch.bfloat16
    want = np.asarray(yj.astype(jnp.float32)).transpose(0, 4, 1, 2, 3)
    np.testing.assert_allclose(yt.detach().float().numpy(), want,
                               rtol=BF16_EPS, atol=BF16_EPS)
    stats = new_vars['batch_stats']
    np.testing.assert_allclose(tbn.running_mean.numpy(), stats['mean'],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tbn.running_var.numpy(), stats['var'],
                               rtol=1e-5, atol=1e-5)
    for got, ref in ((tbn.weight.grad, g_params['scale']),
                     (tbn.bias.grad, g_params['bias'])):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-2,
                                   atol=2e-2 * np.abs(ref).max())
    gx = np.asarray(g_x.astype(jnp.float32)).transpose(0, 4, 1, 2, 3)
    assert xt.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(xt.grad.float().numpy(), gx, rtol=2e-2,
                               atol=2e-2 * np.abs(gx).max())


# ------------------------------------------------------------------- step
def _start_state(variables):
    """k <- q, the key side moved off q, the queues aged (as
    tests/test_torch_mscl_step.py does)."""
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


def _jax_sd(state):
    return jax_to_state_dict({'params': state.params,
                              'batch_stats': state.batch_stats,
                              'moco_state': state.moco_state})


@pytest.fixture(scope='module')
def runs(xla3d_conv):
    cfg = narrow_flagship_cfg(K=K, dim=DIM, num_frames=T)
    batch = flagship_batch(B, num_frames=T, hw=HW, flow_hw=FLOW_HW, seed=31)
    tx = jax_optimizer(_opt_cfg(), jax_lr(*_lr_cfg()),
                       grad_clip=dict(max_norm=40.0),
                       freeze_patterns=MOCO_FREEZE)
    state = init_state(jax_build(cfg), tx, batch, post_init_fn=_start_state)
    jax_out = {}
    for name, dtype in (('f32', None), ('bf16', jnp.bfloat16)):
        jmodel = jax_build(cfg, dtype=dtype)
        new, log_vars = jax.jit(jax_step(jmodel, tx, jax_ema(jmodel)))(
            state, batch)
        jax_out[name] = (_jax_sd(new), jax.device_get(log_vars))

    model = build_model_from_cfg(cfg, device='cpu', dtype=torch.bfloat16)
    load_jax_variables(model, {'params': state.params,
                               'batch_stats': state.batch_stats,
                               'moco_state': state.moco_state})
    acts = {}

    def keep(name):
        def hook(mod, inp, out):
            acts.setdefault(name, out)       # returns None: out unchanged
        return hook
    hooks = [m.register_forward_hook(keep(name))
                  for name, m in (
                 ('encoder_q', model.recognizer.encoder_q),
                 ('neck_q', model.recognizer.neck_q),
                 ('mlp_q', model.recognizer.mlp_q),
                 ('flow_encoder_q', model.recognizer_flow.encoder_q),
                 ('flow_mlp_q', model.recognizer_flow.mlp_q))]
    opt = build_optimizer(model, _opt_cfg(), build_lr_schedule(*_lr_cfg()),
                          grad_clip=dict(max_norm=40.0),
                          freeze_patterns=MOCO_FREEZE)
    tlog = {k: v.item() for k, v in make_train_step(
        model, opt, build_ema_fn(model))(to_torch(batch, 'cpu')).items()}
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    for h in hooks:
        h.remove()
    return dict(jax=jax_out, start=_jax_sd(state), tlog=tlog,
                tsd=model.state_dict(), acts=acts, grads=grads, model=model)


def _distances(got, bf16, f32, norm=np.inf):
    """(|port - JAX bf16|, |JAX bf16 - JAX f32|) in the given norm."""
    return (float(np.linalg.norm(np.ravel(got - bf16), norm)),
            float(np.linalg.norm(np.ravel(bf16 - f32), norm)))


def test_bf16_losses_match_jax(runs):
    (_, j32), (_, j16) = runs['jax']['f32'], runs['jax']['bf16']
    assert sorted(runs['tlog']) == sorted(j16)
    keys = LOSS_KEYS + ['loss']
    got, want16, want32 = (np.array([float(log[k]) for k in keys])
                           for log in (runs['tlog'], j16, j32))
    port, dtype_gap = _distances(got, want16, want32)
    assert port <= dtype_gap, (port, dtype_gap)
    np.testing.assert_allclose(got, want16, rtol=0, atol=LOSS_ABS)


def test_bf16_queues_match_jax(runs):
    (s32, _), (s16, _) = runs['jax']['f32'], runs['jax']['bf16']
    for tower in TOWERS:
        key = f'{tower}.queue'
        port, dtype_gap = _distances(runs['tsd'][key].numpy(), s16[key],
                                     s32[key])
        assert port <= dtype_gap and port <= QUEUE_ABS, (key, port,
                                                         dtype_gap)
        for name in ('count', 'queue_ptr', 'iters'):
            np.testing.assert_array_equal(
                runs['tsd'][f'{tower}.{name}'].numpy(),
                s16[f'{tower}.{name}'])


def test_bf16_updated_params_match_jax(runs):
    """The SGD update of every query-side parameter, relative to the lr."""
    (s32, _), (s16, _) = runs['jax']['f32'], runs['jax']['bf16']
    start = runs['start']
    keys = [k for k in s16 if '_q.' in k and 'running' not in k]
    assert keys
    upd = [np.concatenate([np.ravel((sd[k] - start[k]) / LR) for k in keys])
           for sd in ({k: runs['tsd'][k].numpy() for k in keys}, s16, s32)]
    port, dtype_gap = _distances(*upd, norm=2)
    assert port <= dtype_gap, (port, dtype_gap)
    np.testing.assert_allclose(upd[0], upd[1], rtol=0, atol=UPDATE_ABS)


def test_bf16_dtypes(runs):
    """Activations in bf16; parameters, grads, BN statistics and queues in
    float32."""
    acts = runs['acts']
    for name in ('encoder_q', 'flow_encoder_q'):
        assert all(a.dtype == torch.bfloat16 for a in acts[name]), name
    emb, mlvl = acts['neck_q']
    assert emb.dtype == torch.bfloat16
    assert all(a.dtype == torch.bfloat16 for a in mlvl)
    for name in ('mlp_q', 'flow_mlp_q'):
        assert acts[name].dtype == torch.bfloat16
    model = runs['model']
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert runs['grads'] and all(g.dtype == torch.float32
                                 for g in runs['grads'].values())
    for name, buf in model.named_buffers():
        if 'running' in name or name.endswith('queue'):
            assert buf.dtype == torch.float32, name


def test_float32_is_the_default(runs):
    cfg = narrow_flagship_cfg(K=K, dim=DIM, num_frames=T)
    m32 = build_model_from_cfg(cfg, device='cpu')
    m32b = build_model_from_cfg(cfg, device='cpu', dtype=torch.float32)
    assert m32.dtype == m32b.dtype == torch.float32
    assert runs['model'].dtype == torch.bfloat16
    assert type(m32.recognizer.encoder_q.stem[1]).__name__ == 'BatchNorm3d'
    assert isinstance(runs['model'].recognizer.encoder_q.stem[1],
                      LowPrecisionBatchNorm)
