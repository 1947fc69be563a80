"""The key towers skip their neck's pyramid, whose features nothing reads.

Two train steps of a narrow MSCLWithAug (B=4, T=8, HW=32, K=32, the RGB
tower on TPNMoCo) with the pyramid skipped, as the port runs, and with the
whole key neck run, as it ran before, from the same weights and batches,
give the same bits: every logged value, the queues, counts, pointers and
iters, the EMA'd key towers, the BN statistics and the gradients."""
from unittest import mock

import pytest
import torch
import torch.nn.functional as F

from mscl_torch.apis import (MOCO_FREEZE, build_model_from_cfg,
                             flagship_batch, narrow_flagship_cfg, to_torch)
from mscl_torch.core import build_lr_schedule, build_optimizer, \
    make_train_step
from mscl_torch.models.recognizers import build_ema_fn
from mscl_torch.models.recognizers.moco import MoCoV2


def _whole_key_neck(self, im_q, im_k, gen=None, parts=1):
    """MoCoV2.extract_feat as it was: the key neck's pyramid computed and
    dropped (no ShuffleBN here: gen and parts unused)."""
    q_emb, q_mlvl = self.neck_q(self.encoder_q(im_q))
    q = F.normalize(self.mlp_q(q_emb), dim=1, eps=1e-12)
    with torch.no_grad():
        k_emb, k_mlvl = self.neck_k(self.encoder_k(im_k))
        assert k_mlvl is not None
        k = F.normalize(self.mlp_k(k_emb), dim=1, eps=1e-12)
    return q, q_mlvl, k


def _two_steps():
    model = build_model_from_cfg(narrow_flagship_cfg(), device='cpu', seed=1)
    opt = build_optimizer(
        model, dict(type='SGD', lr=0.02, momentum=0.9, weight_decay=1e-4),
        build_lr_schedule(dict(policy='CosineAnnealing', min_lr=0), 0.02,
                          400, 100),
        grad_clip=dict(max_norm=40), freeze_patterns=MOCO_FREEZE)
    pyramids = {'neck_q': 0, 'neck_k': 0}
    for name in pyramids:
        getattr(model.recognizer, name).tpn.register_forward_hook(
            lambda *_, name=name: pyramids.__setitem__(name,
                                                       pyramids[name] + 1))
    step = make_train_step(model, opt, build_ema_fn(model))
    logs = [step(to_torch(flagship_batch(4, hw=32, seed=s), 'cpu'))
            for s in (1, 2)]
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return dict(logs=logs, state=model.state_dict(), grads=grads,
                pyramids=pyramids)


@pytest.fixture(scope='module')
def runs():
    skipped = _two_steps()
    with mock.patch.object(MoCoV2, 'extract_feat', _whole_key_neck):
        whole = _two_steps()
    return skipped, whole


def test_key_pyramid_is_skipped(runs):
    skipped, whole = runs
    assert skipped['pyramids'] == {'neck_q': 2, 'neck_k': 0}
    assert whole['pyramids'] == {'neck_q': 2, 'neck_k': 2}


def test_logs_are_bit_equal(runs):
    skipped, whole = runs
    for a, b in zip(skipped['logs'], whole['logs']):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize('select', ['moco_state', 'key_towers', 'bn_stats',
                                    'query_towers'])
def test_state_is_bit_equal(runs, select):
    skipped, whole = runs
    moco = ('queue', 'count', 'queue_ptr', 'iters')
    pick = {'moco_state': lambda k: k.rsplit('.', 1)[-1] in moco,
            'key_towers': lambda k: any(f'.{p}.' in k for p in MOCO_FREEZE)
            and 'running' not in k,
            'bn_stats': lambda k: 'running' in k,
            'query_towers': lambda k: '_q.' in k and 'running' not in k}
    keys = [k for k in skipped['state'] if pick[select](k)]
    assert keys and sorted(skipped['state']) == sorted(whole['state'])
    for k in keys:
        assert torch.equal(skipped['state'][k], whole['state'][k]), k


def test_grads_are_bit_equal(runs):
    skipped, whole = runs
    assert skipped['grads'] and sorted(skipped['grads']) == sorted(
        whole['grads'])
    for k, g in skipped['grads'].items():
        assert torch.equal(g, whole['grads'][k]), k
