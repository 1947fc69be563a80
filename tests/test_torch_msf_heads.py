"""The Mean-Shift heads and their multi-positive losses in mscl_torch against
mscl_tpu, on the CPU: ``losses/circle_loss.py`` (each loss flat and with a
group axis, the circle loss on sn holding the -1e6 that ``_msf_sp_sn``
puts at the positives, which JAX counts as exp(0) each) and every head of
``heads/moco_head_v3.py`` alone (outputs, every loss term, the gradient of
their sum in the queries), the cross-modal heads with ``same_kn`` both
ways and the distill head with and without ``small_p``; the recognizers'
refusal of the distill head; the decayed-InfoNCE products a train step of
MSCLWithAug with the MSF head runs (11 forward, 7 backward); and two train
steps of the narrow MSCLWithAug with ``MSCLWithAugMSFMxHead`` against
JAX's (tests/_torch_step_util.py, which states its tolerances).

The queue is a bank (queue, decay) in the port and the dense decayed
matrix in JAX, from the same numbers. The inputs are continuous draws, so
no two queue entries tie at the k-th place of a top-k (torch.topk and
jax.lax.top_k may break ties otherwise). Tolerances: outputs and losses
2e-4, gradients rtol 5e-3 / atol 1e-4 (ROADMAP).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscl_tpu.models import HEADS as JAX_HEADS
from mscl_tpu.models import LOSSES as JAX_LOSSES
from mscl_torch.apis import (FLAGSHIP_AUG, build_model_from_cfg,
                             flagship_batch, narrow_flagship_cfg, to_torch)
from mscl_torch.models import HEADS, LOSSES
from mscl_torch.ops import decayed_infonce

import _torch_step_util as su
from _torch_data_util import one_torch_thread  # noqa: F401
from _torch_port_util import t, xla3d_conv  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')
B, C, K, TOPK = 4, 16, 256, 5
TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-3, atol=1e-4)
MSF_MX = dict(type='MSCLWithAugMSFMxHead', basename='mx', T=0.07, topk=TOPK)
DISTILL_MX = dict(type='MSCLWithAugDistillMxHead', basename='mx', T=0.07)


def _unit(x, axis):
    return (x / np.linalg.norm(x, axis=axis, keepdims=True)).astype(
        np.float32)


def _bank(rng):
    """A queue of unit columns and its decay 0.99**count, float32."""
    queue = _unit(rng.normal(size=(C, K)), 0)
    decay = (0.99 ** rng.integers(0, 300, size=K)).astype(np.float32)
    return queue, decay


def _feats(rng, n=2):
    return [_unit(rng.normal(size=(B, C)), 1) for _ in range(n)]


def _jax_weight(bank):
    queue, decay = bank
    return jnp.asarray(queue * decay[None, :])


def _port_bank(bank):
    return tuple(t(x) for x in bank)


def _close(got, want, tol=TOL, msg=''):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), err_msg=msg, **tol)


def _sum_losses(losses):
    return sum(v for k, v in losses.items() if k.startswith('loss'))


def _check_losses(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], msg=k)


# ---- the multi-positive losses -------------------------------------------

LOSS_CASES = {
    'MultiPositiveSumLoss': dict(),
    'MultiPositiveSumLoss/group': dict(avg_on_group=False),
    'MultiPositiveUniLoss': dict(m=0.2, gamma=4),
    'MultiPositiveUniLoss/group': dict(m=0.2, gamma=4, avg_on_group=False),
    'MultiPositiveCircleLoss': dict(),
    'MultiPositiveCircleLoss/group': dict(m=0.3, gamma=32,
                                          avg_on_group=False),
}


def _sp_sn(rng, grouped):
    """Cosine-like similarities; sn with -1e6 at two entries a row, as
    _msf_sp_sn masks the positives."""
    shape = (B, 3) if grouped else (B,)
    sp = rng.uniform(-1, 1, size=shape + (TOPK,)).astype(np.float32)
    sn = rng.uniform(-1, 1, size=shape + (40,)).astype(np.float32)
    sn[..., 3] = sn[..., 17] = -1e6
    return sp, sn


@pytest.mark.parametrize('case', sorted(LOSS_CASES))
def test_multi_positive_loss_matches(case):
    name = case.split('/')[0]
    cfg = LOSS_CASES[case]
    sp, sn = _sp_sn(np.random.default_rng(len(case)), '/group' in case)
    jloss = JAX_LOSSES.get(name)(**cfg)
    want, (wsp, wsn) = jax.value_and_grad(
        lambda a, b: jloss(a, b), argnums=(0, 1))(jnp.asarray(sp),
                                                  jnp.asarray(sn))
    tsp, tsn = t(sp).requires_grad_(True), t(sn).requires_grad_(True)
    got = LOSSES.build(dict(cfg, type=name))(tsp, tsn)
    got.backward()
    _close(got, want)
    _close(tsp.grad, wsp, GRAD_TOL)
    _close(tsn.grad, wsn, GRAD_TOL)


def test_circle_loss_counts_each_masked_entry_as_exp0():
    """JAX's an = clip(sg(sn) + m, 0) is 0 at -1e6, so a masked entry's
    logit is 0 and adds exp(0) to the negatives' log-sum-exp: the port
    gives that value (here also in float64 numpy), not the one without
    those entries."""
    from scipy.special import logsumexp
    # near their optima (sp -> 1, sn -> 0) the unmasked terms are small,
    # so the masked entries' exp(0) shows
    rng = np.random.default_rng(3)
    sp = rng.uniform(0.85, 0.95, size=(B, TOPK)).astype(np.float32)
    sn = rng.uniform(-0.2, 0.2, size=(B, 40)).astype(np.float32)
    sn[:, 3] = sn[:, 17] = -1e6
    want = float(JAX_LOSSES.get('MultiPositiveCircleLoss')()(
        jnp.asarray(sp), jnp.asarray(sn)))
    loss = LOSSES.build(dict(type='MultiPositiveCircleLoss'))
    got = float(loss(t(sp), t(sn)))
    np.testing.assert_allclose(got, want, **TOL)

    def circle64(sp, sn, m=0.25, gamma=128):
        sp, sn = sp.astype(np.float64), sn.astype(np.float64)
        ap = np.clip(-sp + 1 + m, 0, None)
        an = np.clip(sn + m, 0, None)
        x = logsumexp(an * (sn - m) * gamma, axis=1) + \
            logsumexp(-ap * (sp - (1 - m)) * gamma, axis=1)
        return float(np.mean(np.logaddexp(0, x)))
    assert np.all(np.clip(sn[:, [3, 17]] + 0.25, 0, None) == 0)
    np.testing.assert_allclose(got, circle64(sp, sn), **TOL)
    without = float(loss(t(sp), t(np.delete(sn, [3, 17], axis=1))))
    assert got > 5 * without, (got, without)


# ---- the heads alone ------------------------------------------------------

def test_moco_head_v2_matches():
    rng = np.random.default_rng(0)
    q, k = _feats(rng)
    bank = _bank(rng)
    jhead = JAX_HEADS.get('MoCoHeadV2')(basename='v2')

    def jfn(q):
        out = jhead(q, jnp.asarray(k), _jax_weight(bank))
        losses = jhead.loss(**out)
        return _sum_losses(losses), (out, losses)
    (_, (jout, jlosses)), jgrad = jax.value_and_grad(jfn, has_aux=True)(
        jnp.asarray(q))
    head = HEADS.build(dict(type='MoCoHeadV2', basename='v2'))
    tq = t(q).requires_grad_(True)
    out = head(tq, t(k), _port_bank(bank))
    losses = head.loss(**out)
    _sum_losses(losses).backward()
    _close(out['cls_score'], jout['cls_score'])
    _check_losses(losses, jlosses)
    _close(tq.grad, jgrad, GRAD_TOL)


def _labels(rng):
    label = rng.integers(0, 4, size=B)
    label_queue = rng.integers(0, 4, size=K)
    return label, label_queue


@pytest.mark.parametrize('name', ['MSFHead', 'NMSFHead/sum', 'NMSFHead/uni',
                                  'NMSFHead/circle'])
def test_msf_head_matches(name):
    rng = np.random.default_rng(len(name))
    q, k = _feats(rng)
    bank = _bank(rng)
    label, label_queue = _labels(rng)
    cfg = dict(basename='msf', topk=TOPK)
    if name != 'MSFHead':
        cfg['loss_cls'] = {
            'sum': None,
            'uni': dict(type='MultiPositiveUniLoss', m=0.1, gamma=2),
            'circle': dict(type='MultiPositiveCircleLoss', gamma=16),
        }[name.split('/')[1]]
    kind = name.split('/')[0]
    jhead = JAX_HEADS.get(kind)(**cfg)

    def jfn(q):
        out = jhead(q, jnp.asarray(k), _jax_weight(bank), jnp.asarray(label),
                    jnp.asarray(label_queue))
        losses = jhead.loss(**out)
        return _sum_losses(losses), (out, losses)
    (_, (jout, jlosses)), jgrad = jax.value_and_grad(jfn, has_aux=True)(
        jnp.asarray(q))
    head = HEADS.build(dict(cfg, type=kind))
    tq = t(q).requires_grad_(True)
    out = head(tq, t(k), _port_bank(bank), t(label), t(label_queue))
    losses = head.loss(**out)
    _sum_losses(losses).backward()
    assert sorted(out) == sorted(jout)
    for key in jout:
        _close(out[key], jout[key], msg=key)
    assert 0 < float(losses['msf_purity_msf']) < 1
    _check_losses(losses, jlosses)
    _close(tq.grad, jgrad, GRAD_TOL)


def _mx_inputs(seed):
    rng = np.random.default_rng(seed)
    q, k, q_flow, k_flow = _feats(rng, 4)
    return (q, k, q_flow, k_flow), _bank(rng), _bank(rng)


def _mx_case(cfg, seed, n_out):
    """JAX's and the port's forward_moco_mx, loss and the gradient of the
    loss sum in q and q_flow."""
    (q, k, q_flow, k_flow), bank, bank_flow = _mx_inputs(seed)
    jcfg = {kk: v for kk, v in cfg.items() if kk != 'type'}
    jhead = JAX_HEADS.get(cfg['type'])(**jcfg)

    def jfn(q, q_flow):
        out = jhead.forward_moco_mx(q, jnp.asarray(k), q_flow,
                                    jnp.asarray(k_flow), _jax_weight(bank),
                                    _jax_weight(bank_flow))
        extra = out[3] if n_out == 4 else {}
        losses = jhead.loss(*out[:3], **extra)
        losses.update(jhead.loss(*out[:3], suffix='_aug', **extra))
        return _sum_losses(losses), (out, losses)
    (_, (jout, jlosses)), jgrads = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(jnp.asarray(q),
                                           jnp.asarray(q_flow))
    head = HEADS.build(cfg)
    tq, tqf = t(q).requires_grad_(True), t(q_flow).requires_grad_(True)
    out = head.forward_moco_mx(tq, t(k), tqf, t(k_flow), _port_bank(bank),
                               _port_bank(bank_flow))
    assert len(out) == n_out
    extra = out[3] if n_out == 4 else {}
    losses = head.loss(*out[:3], **extra)
    losses.update(head.loss(*out[:3], suffix='_aug', **extra))
    _sum_losses(losses).backward()
    _check_losses(losses, jlosses)
    _close(tq.grad, jgrads[0], GRAD_TOL)
    _close(tqf.grad, jgrads[1], GRAD_TOL)
    return out, jout, losses


@pytest.mark.parametrize('same_kn', [True, False])
def test_msf_mx_head_matches(same_kn):
    out, jout, losses = _mx_case(dict(MSF_MX, same_kn=same_kn), 5, 3)
    for got, want in zip(out[:2], jout[:2]):     # rf, fr: (sp, sn) each
        _close(got[0], want[0], msg='sp')
        _close(got[1], want[1], msg='sn')
        assert (got[1] == -1e6).sum() == B * TOPK
    assert sorted(losses) == ['loss_circle_mx', 'loss_circle_mx_aug',
                              'loss_circle_mx_r', 'loss_circle_mx_r_aug']


@pytest.mark.parametrize('small_p', [None, 24])
@pytest.mark.parametrize('same_kn', [True, False])
def test_distill_mx_head_matches(same_kn, small_p):
    out, jout, losses = _mx_case(
        dict(DISTILL_MX, same_kn=same_kn, small_p=small_p), 7, 4)
    _close(out[0], jout[0], msg='rf_logits')
    _close(out[1], jout[1], msg='fr_logits')
    _close(out[3]['loss_kl'], jout[3]['loss_kl'], msg='loss_kl')
    assert out[3]['loss_kl'].item() > 0
    assert 'loss_kl' in losses and 'top5_acc_mx_r_aug' in losses


@pytest.mark.parametrize('recognizer', ['MSCLWithAug', 'MSCL', 'MoDist'])
def test_distill_mx_head_is_refused_by_the_recognizers(recognizer):
    cfg = narrow_flagship_cfg()
    cfg.update(type=recognizer, moco_mx_head=dict(DISTILL_MX))
    if recognizer == 'MoDist':
        for key in ('sup_head', 'update_aug_flow', 'weight_aug_flow'):
            cfg.pop(key, None)
    with pytest.raises(NotImplementedError,
                       match='MSCLWithAugDistillMxHead'):
        build_model_from_cfg(cfg, device='cpu')


# ---- MSCLWithAug with the MSF head ---------------------------------------

# forward and backward decayed-InfoNCE products of one train step: the
# towers' (each with its dq), then per _msf_sp_sn the key's product and
# the query's (with its dq), 2 directions x the flow passes (2 with FRA)
STEP_PRODUCTS = {'mscl': dict(l_neg=3 + 2 * 2 * 2, dq=3 + 2 * 2),
                 'mscl_nofra': dict(l_neg=2 + 2 * 2, dq=2 + 2),
                 'modist': dict(l_neg=2 + 2 * 2, dq=2 + 2)}


@pytest.mark.parametrize('arm', sorted(STEP_PRODUCTS))
def test_msf_mx_step_runs_its_products(monkeypatch, arm):
    """One train step of each MSCL recognizer with the MSF head (the
    ablation tool's arms at its tiny scale: MSCLWithAug, MSCL, MoDist),
    counted through the plain versions each kernel launch stands for on
    the card: MSCLWithAug 11 forward and 7 backward."""
    from mscl_torch.tools import ablation_ordering as tool
    calls = dict(l_neg=0, dq=0)
    plain = dict(l_neg=decayed_infonce.l_neg_plain,
                 dq=decayed_infonce.dq_plain)

    def counted(name):
        def fn(*args):
            calls[name] += 1
            return plain[name](*args)
        return fn
    monkeypatch.setattr(decayed_infonce, 'l_neg_plain', counted('l_neg'))
    monkeypatch.setattr(decayed_infonce, 'dq_plain', counted('dq'))
    cfg = tool.arm_cfg(arm, 'tiny', 4, 256, 300, 16, 32)
    cfg['moco_mx_head'] = dict(MSF_MX)
    data = tool.make_videos(4, 32, 4, seed=100)
    batch = tool.make_batch(np.random.default_rng(0), data,
                            np.arange(len(data['labels'])), arm, 4, 4)
    model = build_model_from_cfg(cfg, device='cpu')
    loss, log_vars = model.train_step(to_torch(batch, 'cpu'))
    loss.backward()
    assert calls == STEP_PRODUCTS[arm], calls
    want = {'loss_circle_mx', 'loss_circle_mx_r'}
    if arm == 'mscl':
        want |= {'loss_circle_mx_aug', 'loss_circle_mx_r_aug'}
    assert want <= set(log_vars) and torch.isfinite(loss)


SK, SB, ST, SHW = 32, 4, 8, 32


@pytest.fixture(scope='module')
def runs(xla3d_conv):
    cfg = narrow_flagship_cfg(K=SK, dim=32, rgb_width=8, flow_width=2,
                              num_frames=ST, aug=dict(FLAGSHIP_AUG,
                                                      crop_size=SHW))
    cfg['moco_mx_head'] = dict(MSF_MX)
    batches = [flagship_batch(SB, num_frames=ST, hw=SHW, seed=s)
               for s in (21, 22)]
    return su.two_steps(cfg, batches, SK, SB, ST)


@pytest.mark.parametrize('step', [0, 1])
def test_msf_mx_step_losses_match(runs, step):
    su.check_losses(runs, step)
    assert 'loss_circle_mx_r_aug' in runs['tlogs'][step]


@pytest.mark.parametrize('step', [0, 1])
def test_msf_mx_step_queues_match(runs, step):
    su.check_queues(runs, step, ('recognizer.', 'recognizer_flow.'))


def test_msf_mx_step_ema_and_bn_match(runs):
    su.check_ema(runs)
    su.check_bn_stats(runs)


def test_msf_mx_step_sgd_matches(runs):
    su.check_sgd(runs)
