"""The reid and distill heads and TripletLoss in mscl_torch against
mscl_tpu, on the CPU, each head alone: TSMReidSimpleHead (its flax BN-neck,
momentum 0.99 and no bias, with its running statistics after a train step;
cosface with and without labels, and in eval mode, where the margin is
off), FGTSMReidSimpleHead, TSMHead3D with one and two classifiers, pooled
and flattened, RcMoDistHead over three pyramid levels, and the batch-hard
TripletLoss: the scores, every loss term and the gradients of their sum in
the input and the parameters, from the same (perturbed) weights through
``mscl_torch.convert`` (the raw ``fc_cls_kernel``/``fc_cls_bias`` as they
are). Dropout is 0 (the port's masks are not JAX's). Layouts: JAX NHWC /
NTHWC, the port NCHW / NCTHW. Tolerances: outputs and losses 2e-4,
gradients rtol 5e-3 / atol 1e-4, BN statistics 1e-4 (ROADMAP)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscl_tpu.models import HEADS as JAX_HEADS
from mscl_tpu.models import LOSSES as JAX_LOSSES
from mscl_torch.convert import jax_to_state_dict, load_jax_variables
from mscl_torch.models import HEADS, LOSSES

from _torch_data_util import one_torch_thread  # noqa: F401
from _torch_port_util import ncthw, nthwc, perturb, t  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')
N, SEGS, C, CLASSES = 4, 4, 16, 6
TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-3, atol=1e-4)
STAT_TOL = dict(rtol=1e-4, atol=1e-4)
LABELS = np.array([0, 2, 0, 5])
COSFACE = dict(use=True, s=16, m=0.2)


def _close(got, want, tol=TOL, msg=''):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), err_msg=msg, **tol)


def _sum_losses(losses):
    return sum(v for k, v in losses.items() if k.startswith('loss'))


def _nhwc(x):
    return np.transpose(x, (0, 2, 3, 1)) if x.ndim == 4 else x


def _init(jhead, x, **kwargs):
    variables = dict(jhead.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                train=False, **kwargs))
    variables['params'] = perturb(variables['params'], 2, scale=0.5)
    if 'batch_stats' in variables:
        variables['batch_stats'] = perturb(variables['batch_stats'], 3)
    return variables


def _param_grads(model):
    """Each parameter's gradient, 0 for one the loss does not reach (the
    bias under cosface), as JAX gives it."""
    return {k: np.zeros(p.shape, np.float32) if p.grad is None
            else p.grad.numpy() for k, p in model.named_parameters()}


REID_CASES = {
    'TSMReidSimpleHead': (dict(), True, True),
    'TSMReidSimpleHead/cosface': (dict(use_cosface=COSFACE), True, True),
    'TSMReidSimpleHead/cosface_no_labels': (dict(use_cosface=COSFACE), True,
                                            False),
    'TSMReidSimpleHead/cosface_eval': (dict(use_cosface=COSFACE), False,
                                       True),
    'TSMReidSimpleHead/eval_no_bnneck_2d': (dict(use_bnneck=False), False,
                                            True),
    'FGTSMReidSimpleHead': (dict(), True, True),
    'FGTSMReidSimpleHead/cosface': (dict(use_cosface=COSFACE), True, True),
}


@pytest.mark.parametrize('case', sorted(REID_CASES))
def test_reid_head_matches(case):
    name = case.split('/')[0]
    extra, train, with_labels = REID_CASES[case]
    cfg = dict(extra, num_classes=CLASSES, in_channels=C,
               num_segments=SEGS, dropout_ratio=0.0)
    rng = np.random.default_rng(len(case))
    shape = (N * SEGS, C) if case.endswith('_2d') else (N * SEGS, C, 3, 3)
    x = rng.normal(size=shape).astype(np.float32)
    labels = LABELS if with_labels else None
    jhead = JAX_HEADS.get(name)(**cfg)
    variables = _init(jhead, _nhwc(x))
    mutable = ['batch_stats'] if train and 'batch_stats' in variables \
        else False

    def jfn(params, x):
        v = dict(variables, params=params)
        out = jhead.apply(v, x, train=train, return_feat=True,
                          labels=None if labels is None else
                          jnp.asarray(labels), mutable=mutable)
        (score, feat), new = out if mutable else (out, {})
        losses = jhead.apply(v, score, jnp.asarray(LABELS), reid_feat=feat,
                             method='loss')
        return _sum_losses(losses), (score, feat, losses, new)
    (_, (jscore, jfeat, jlosses, new)), (jgp, jgx) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(variables['params'],
                                           jnp.asarray(_nhwc(x)))

    head = HEADS.build(dict(cfg, type=name))
    load_jax_variables(head, variables)
    head.train(train)
    tx = t(x).requires_grad_(True)
    score, feat = head(tx, labels=None if labels is None else t(labels),
                       return_feat=True)
    losses = head.loss(score, t(LABELS), reid_feat=feat)
    _sum_losses(losses).backward()
    _close(score, jscore, msg='score')
    _close(feat, jfeat, msg='reid_feat')
    assert sorted(losses) == sorted(jlosses)
    for k in jlosses:
        _close(losses[k], jlosses[k], msg=k)
    assert 'loss_reid' in losses
    _close(tx.grad, np.asarray(jgx).transpose((0, 3, 1, 2))
           if x.ndim == 4 else jgx, GRAD_TOL, 'dx')
    want = jax_to_state_dict({'params': jgp})
    got = _param_grads(head)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], GRAD_TOL, k)
    if mutable:
        stats = jax_to_state_dict({'batch_stats': new['batch_stats']})
        sd = head.state_dict()
        old = jax_to_state_dict({'batch_stats': variables['batch_stats']})
        for k in stats:
            _close(sd[k], stats[k], STAT_TOL, k)
            # flax's momentum 0.99: a step moves them by 1 % of the way
            assert np.abs(stats[k] - old[k]).max() < 0.05


@pytest.mark.parametrize('num_clfs,spatial', [(1, 'avg'), (2, 'avg'),
                                              (2, 'none')])
def test_tsm_head_3d_matches(num_clfs, spatial):
    cfg = dict(num_classes=CLASSES, in_channels=C if spatial == 'avg'
               else C * 4, num_segments=SEGS, num_clfs=num_clfs,
               spatial_type=spatial, dropout_ratio=0.0)
    rng = np.random.default_rng(num_clfs)
    x = rng.normal(size=(N * SEGS, C, 2, 2)).astype(np.float32)
    jhead = JAX_HEADS.get('TSMHead3D')(**cfg)
    variables = _init(jhead, _nhwc(x))

    def jfn(params, x):
        score = jhead.apply({'params': params}, x, train=True)
        losses = jhead.apply({'params': params}, score,
                             jnp.asarray(LABELS), method='loss')
        return _sum_losses(losses), (score, losses)
    (_, (jscore, jlosses)), (jgp, jgx) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(variables['params'],
                                           jnp.asarray(_nhwc(x)))
    head = HEADS.build(dict(cfg, type='TSMHead3D'))
    load_jax_variables(head, variables)
    tx = t(x).requires_grad_(True)
    score = head(tx)
    losses = head.loss(score, t(LABELS))
    _sum_losses(losses).backward()
    _close(score, jscore, msg='score')
    assert sorted(losses) == sorted(jlosses)
    for k in jlosses:
        _close(losses[k], jlosses[k], msg=k)
    _close(tx.grad, np.asarray(jgx).transpose((0, 3, 1, 2)), GRAD_TOL, 'dx')
    want = jax_to_state_dict({'params': jgp})
    got = _param_grads(head)
    assert sorted(got) == sorted(want) and len(want) == 2 * num_clfs
    for k in want:
        _close(got[k], want[k], GRAD_TOL, k)


def test_rc_modist_head_matches():
    rng = np.random.default_rng(4)
    dim, c = 8, 3
    flow = rng.uniform(size=(2, c, 8, 32, 32)).astype(np.float32)
    levels = [rng.normal(size=(2, dim, 4, s, s)).astype(np.float32)
              for s in (8, 4, 2)]
    jhead = JAX_HEADS.get('RcMoDistHead')(dim_fpn=dim)
    jlevels = [jnp.asarray(nthwc(v)) for v in levels]
    variables = dict(jhead.init(jax.random.PRNGKey(0), jlevels,
                                jnp.asarray(nthwc(flow))))
    variables['params'] = perturb(variables['params'], 2, scale=0.5)

    def jfn(params, levels):
        out = jhead.apply({'params': params}, levels, jnp.asarray(
            nthwc(flow)))
        losses = jhead.apply({'params': params}, **out, method='loss_mx')
        return losses['loss_rc'], losses
    (_, jlosses), (jgp, jgl) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(variables['params'], jlevels)
    head = HEADS.build(dict(type='RcMoDistHead', dim_fpn=dim, num_levels=3,
                            flow_channels=c))
    load_jax_variables(head, variables)
    tl = [t(v).requires_grad_(True) for v in levels]
    losses = head.loss_mx(**head(tl, t(flow)))
    losses['loss_rc'].backward()
    _close(losses['loss_rc'], jlosses['loss_rc'], msg='loss_rc')
    for got, want in zip(tl, jgl):
        _close(got.grad, ncthw(want), GRAD_TOL, 'dlevel')
    want = jax_to_state_dict({'params': jgp})
    got = _param_grads(head)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], GRAD_TOL, k)


@pytest.mark.parametrize('margin', [0.3, 2.0])
def test_triplet_loss_matches(margin):
    """Batch-hard over 8 anchors, one of them with no positive."""
    rng = np.random.default_rng(int(margin * 10))
    feat = rng.normal(size=(8, C)).astype(np.float32)
    label = np.array([0, 1, 0, 2, 1, 0, 3, 2])
    jloss = JAX_LOSSES.get('TripletLoss')(margin=margin)
    want, wgrad = jax.value_and_grad(
        lambda f: jloss(f, jnp.asarray(label)))(jnp.asarray(feat))
    tf = t(feat).requires_grad_(True)
    got = LOSSES.build(dict(type='TripletLoss', margin=margin))(
        tf, t(label))
    got.backward()
    _close(got, want)
    assert float(want) > 0
    _close(tf.grad, wgrad, GRAD_TOL)
