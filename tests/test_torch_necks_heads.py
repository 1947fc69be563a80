"""mscl_torch's necks, heads and loss against mscl_tpu's, on the CPU:
TPNMoCo (FPN + SEPC) and BaseMoCo forward and input gradients, the
cross-modal Mx head with its negatives through the decayed-InfoNCE op, the
LMCL PosHeadV2, and cross-entropy with ignore_index=-1."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscl_tpu.models import HEADS as JAX_HEADS
from mscl_tpu.models import NECKS as JAX_NECKS
from mscl_tpu.models.losses.cross_entropy_loss import \
    cross_entropy as jax_ce
from mscl_torch.convert import load_jax_variables
from mscl_torch.models import HEADS, NECKS
from mscl_torch.models.losses import cross_entropy
from mscl_torch.ops import decay_weights

from _torch_port_util import ncthw, nthwc, perturb, t, xla3d_conv  # noqa: F401

B = 2
# r3d-shaped stage outputs at T=8, HW=32, width 8 (NCTHW)
STAGES = [(8, 8, 16, 16), (16, 4, 8, 8), (32, 2, 4, 4), (64, 1, 2, 2)]
TPN = dict(type='TPNMoCo', in_channels=[16, 32, 64], out_channels=16,
           sepc_cfg=dict(in_channels=[16, 16, 16], out_channels=16,
                         stride=(2, 2, 2), iBN=False, Pconv_num=2))


def _stages(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B,) + s).astype(np.float32) for s in STAGES]


@pytest.mark.parametrize('neck', ['TPNMoCo', 'BaseMoCo'])
def test_moco_necks_match(xla3d_conv, neck):
    cfg = dict(TPN) if neck == 'TPNMoCo' else dict(type='BaseMoCo')
    cfg.pop('type')
    xs = _stages()
    jneck = JAX_NECKS.get(neck)(**cfg)
    jx = [jnp.asarray(nthwc(x)) for x in xs]
    variables = jneck.init(jax.random.PRNGKey(0), jx)
    tneck = NECKS.get(neck)(**cfg)
    if 'params' in variables:
        variables = {'params': perturb(variables['params'], 1)}
        load_jax_variables(tneck, variables)
    rng = np.random.default_rng(5)

    def jloss(inputs):
        emb, feats = jneck.apply(variables, inputs)
        return (emb * wts[0]).sum() + sum(
            (f * w).sum() for f, w in zip(feats, wts[1:])), (emb, feats)

    (jemb, jfeats) = jneck.apply(variables, jx)
    wts = [jnp.asarray(rng.normal(size=np.shape(a)).astype(np.float32))
           for a in [jemb] + list(jfeats)]
    jgrads, _ = jax.grad(jloss, has_aux=True)(jx)

    tx = [t(x).requires_grad_(True) for x in xs]
    temb, tfeats = tneck(tx)
    np.testing.assert_allclose(temb.detach().numpy(), np.asarray(jemb),
                               rtol=1e-5, atol=1e-5)
    assert len(tfeats) == len(jfeats)
    for g, w in zip(tfeats, jfeats):
        np.testing.assert_allclose(g.detach().numpy(), ncthw(w), rtol=1e-4,
                                   atol=1e-5)
    tw = [t(np.asarray(wts[0]))] + [t(ncthw(w)) for w in wts[1:]]
    ((temb * tw[0]).sum() + sum((f * w).sum() for f, w in
                                zip(tfeats, tw[1:]))).backward()
    for i, (g, w) in enumerate(zip(tx, jgrads)):
        # TPNMoCo reads only the last three stages: no grad reaches stage 1
        got = torch.zeros_like(g) if g.grad is None else g.grad
        np.testing.assert_allclose(got.numpy(), ncthw(w), rtol=1e-4,
                                   atol=1e-5, err_msg=f'input {i} grad')


def test_mx_head_matches(xla3d_conv):
    rng = np.random.default_rng(3)
    n, c, k = 4, 16, 64

    def unit(*shape, axis):
        x = rng.normal(size=shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=axis, keepdims=True)

    q, key, qf, kf = (unit(n, c, axis=1) for _ in range(4))
    queue, queue_f = unit(c, k, axis=0), unit(c, k, axis=0)
    count = rng.integers(0, 50, size=k)
    count_f = rng.integers(0, 50, size=k)
    cfg = dict(basename='mx', loss_cls=dict(type='CrossEntropyLoss_torch',
                                            ignore_index=-1),
               same_kn=True, T=0.07)
    jhead = JAX_HEADS.get('MSCLWithAugMxHead')(**cfg)
    w = queue * (0.99999 ** count.astype(np.float32))[None]
    wf = queue_f * (0.99999 ** count_f.astype(np.float32))[None]
    jrf, jfr, jlbl = jhead.forward_moco_mx(q, key, qf, kf, w, wf)
    jlosses = jhead.loss(jrf, jfr, jlbl, suffix='_aug')

    thead = HEADS.get('MSCLWithAugMxHead')(**cfg)
    bank = (t(queue), decay_weights(t(count), 0.99999))
    bank_f = (t(queue_f), decay_weights(t(count_f), 0.99999))
    trf, tfr, tlbl = thead.forward_moco_mx(t(q), t(key), t(qf), t(kf), bank,
                                           bank_f)
    np.testing.assert_allclose(trf.numpy(), np.asarray(jrf), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(tfr.numpy(), np.asarray(jfr), rtol=1e-5,
                               atol=1e-4)
    tlosses = thead.loss(trf, tfr, tlbl, suffix='_aug')
    assert sorted(tlosses) == sorted(jlosses)
    for name in jlosses:
        np.testing.assert_allclose(tlosses[name].item(),
                                   float(jlosses[name]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize('bkb_channels', [(None, None), (8, 4)])
def test_pos_head_matches(bkb_channels):
    rng = np.random.default_rng(4)
    c_rgb, c_flow = bkb_channels if bkb_channels[0] else (6, 6)
    x_q = rng.normal(size=(B, c_rgb, 4, 3, 3)).astype(np.float32)
    x_f = rng.normal(size=(B, c_flow, 4, 3, 3)).astype(np.float32)
    x_a = rng.normal(size=(B, c_flow, 4, 3, 3)).astype(np.float32)
    cfg = dict(basename='', loss_pos=dict(type='CrossEntropyLoss_torch',
                                          ignore_index=-1),
               bkb_channels=bkb_channels, t=4, T=0.07)
    jhead = JAX_HEADS.get('MSCLWithAugPosHeadV2')(**cfg)
    jargs = ([nthwc(x_q)], [nthwc(x_f)], [nthwc(x_a)])
    variables = jhead.init(jax.random.PRNGKey(0), *jargs)
    jout = jhead.apply(variables, *jargs)
    jlosses = jhead.apply(variables, **jout, method='loss')

    thead = HEADS.get('MSCLWithAugPosHeadV2')(**cfg)
    if variables:
        load_jax_variables(thead, {'params': variables['params']})
    tout = thead([t(x_q)], [t(x_f)], [t(x_a)])
    np.testing.assert_array_equal(tout['pos_labels'].numpy(),
                                  np.asarray(jout['pos_labels']))
    np.testing.assert_allclose(tout['pos_scores'].detach().numpy(),
                               np.asarray(jout['pos_scores']), rtol=1e-5,
                               atol=1e-4)
    tlosses = thead.loss(**tout)
    for name in jlosses:
        np.testing.assert_allclose(tlosses[name].item(),
                                   float(jlosses[name]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize('labels', [[0, -1, 2, 1, -1], [-1] * 5,
                                    [3, 3, 0, 1, 2]])
def test_cross_entropy_ignore_index(labels):
    rng = np.random.default_rng(6)
    scores = rng.normal(size=(5, 4)).astype(np.float32)
    lbl = np.asarray(labels, np.int32)
    want = float(jax_ce(jnp.asarray(scores), jnp.asarray(lbl),
                        ignore_index=-1))
    got = float(cross_entropy(t(scores), t(lbl.astype(np.int64)), -1))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
