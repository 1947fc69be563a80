"""TIN's pieces and its LR policy in mscl_torch against mscl_tpu, on the
CPU: ``tin_shift`` bitwise (offsets inside and beyond the segments, both
signs), ``linear_sampler``'s output and its gradients in the data and in
the offsets (the blend weights carry the offsets' gradient, the integer
shifts none), TemporalInterlace and TANet's TAM alone in train mode
(outputs, gradients in the input and the parameters, BN statistics), and
the 'TIN' lr policy at every step of short schedules (its own linear
warmup, by epoch and by iteration, with and without warmup).
Tolerances: outputs and statistics 1e-4, gradients rtol 5e-3 / atol 1e-4,
the lr 1e-6 relative (JAX computes it in float32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mscl_tpu.core.lr_schedule import build_lr_schedule as jax_schedule
from mscl_tpu.models.backbones import resnet_tin as jax_tin
from mscl_tpu.models.backbones import tanet as jax_tanet
from mscl_torch.convert import jax_to_state_dict, load_jax_variables
from mscl_torch.core import build_lr_schedule
from mscl_torch.models.backbones import resnet_tin, tanet

from _torch_data_util import one_torch_thread  # noqa: F401
from _torch_port_util import perturb, t

pytestmark = pytest.mark.usefixtures('one_torch_thread')
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=5e-3, atol=1e-4)


def test_tin_shift_bitwise():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(3, 8, 12, 5)).astype(np.float32)
    offset = np.array([[0, 1, -1, 3], [-8, 9, 2, -3], [7, -7, 0, 5]],
                      np.int32)
    want = jax_tin.tin_shift(jnp.asarray(data), jnp.asarray(offset))
    got = resnet_tin.tin_shift(t(data), t(offset).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_linear_sampler_and_its_gradient():
    rng = np.random.default_rng(1)
    data = rng.normal(size=(2, 8, 8, 3, 3)).astype(np.float32)
    offset = rng.uniform(-2.5, 2.5, size=(2, 4)).astype(np.float32)
    w = rng.normal(size=data.shape).astype(np.float32)

    def loss(d, o):
        out = jax_tin.linear_sampler(d, o)
        return jnp.sum(out * w), out
    (_, want), (jgd, jgo) = jax.value_and_grad(loss, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(data), jnp.asarray(offset))
    td, to = t(data).requires_grad_(), t(offset).requires_grad_()
    got = resnet_tin.linear_sampler(td, to)
    (got * t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jgd), **GRAD_TOL)
    np.testing.assert_allclose(to.grad.numpy(), np.asarray(jgo), **GRAD_TOL)
    assert np.abs(np.asarray(jgo)).max() > 1e-2


def _nhwc(x):
    return np.transpose(x, (0, 2, 3, 1))


@pytest.mark.parametrize('name', ['TemporalInterlace', 'TAM'])
def test_module_alone_matches(name):
    """(N * T, C, H, W) frames, T = 8, in train mode."""
    rng = np.random.default_rng(2)
    c, segs = 16, 8
    x = rng.normal(size=(2 * segs, c, 4, 4)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32) / 8
    if name == 'TemporalInterlace':
        jmod = jax_tin.TemporalInterlace(segs, 4)
        tmod = resnet_tin.TemporalInterlace(c, segs, 4)
    else:
        jmod = jax_tanet.TAM(segs)
        tmod = tanet.TAM(c, segs)
    variables = dict(jax.jit(lambda r, v: jmod.init(
        r, v, **({'train': False} if name == 'TAM' else {})))(
            jax.random.PRNGKey(0), jnp.asarray(_nhwc(x))))
    variables['params'] = perturb(variables['params'], 3, scale=0.5)
    kwargs = dict(train=True, mutable=['batch_stats']) if name == 'TAM' \
        else {}

    def loss(params, xx):
        out = jmod.apply(dict(variables, params=params), xx, **kwargs)
        out, new = out if kwargs else (out, {})
        return jnp.sum(out * _nhwc(w)), (out, new)
    (_, (want, new)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables['params'],
                                             jnp.asarray(_nhwc(x)))
    load_jax_variables(tmod, variables)
    tmod.train()
    tx = t(x).requires_grad_()
    got = tmod(tx)
    (got * t(w)).sum().backward()
    np.testing.assert_allclose(_nhwc(got.detach().numpy()), np.asarray(want),
                               **TOL)
    np.testing.assert_allclose(_nhwc(tx.grad.numpy()), np.asarray(jgx),
                               **GRAD_TOL)
    params = dict(tmod.named_parameters())
    for k, v in jax_to_state_dict({'params': jgp}).items():
        np.testing.assert_allclose(params[k].grad.numpy(), v, err_msg=k,
                                   **GRAD_TOL)
    for k, v in jax_to_state_dict({'batch_stats': new.get('batch_stats',
                                                          {})}).items():
        np.testing.assert_allclose(tmod.state_dict()[k].numpy(), v,
                                   err_msg=k, **TOL)


TIN_LR = dict(policy='TIN', min_lr=0, warmup='linear', warmup_iters=1,
              warmup_by_epoch=True, warmup_ratio=0.1)


@pytest.mark.parametrize('lr_config,epochs,per_epoch', [
    (TIN_LR, 4, 3),                                   # the TIN recipe's
    (dict(TIN_LR, warmup_iters=5, warmup_by_epoch=False, min_lr=1e-3), 3, 4),
    (dict(TIN_LR, by_epoch=False), 3, 4),
    (dict(policy='TIN', min_lr=0.002), 3, 2),          # no warmup
    (dict(TIN_LR, warmup='constant'), 3, 2),           # the generic warmup
])
def test_tin_lr_curve(lr_config, epochs, per_epoch):
    want = jax_schedule(dict(lr_config), 0.02, epochs, per_epoch)
    got = build_lr_schedule(dict(lr_config), 0.02, epochs, per_epoch)
    lrs = [got(s) for s in range(epochs * per_epoch + 1)]
    np.testing.assert_allclose(lrs, [float(want(s)) for s in
                                     range(epochs * per_epoch + 1)],
                               rtol=1e-6, atol=1e-9)
    assert isinstance(lrs[0], float)
