"""The port's Recognizer3D and I3DHead against mscl_tpu's, on the CPU:
r3d_18 8 wide, 10 classes, B=4, T=4, 32x32, dropout 0, weights converted
from the JAX variables (perturbed) by ``convert.jax_to_state_dict``, which
covers the model both ways. forward_train's losses and accuracies, BN
statistics and gradients; forward_test with 'prob' and 'score' over 1 and
2 segments and extract_features_pooled in eval mode; two SGD steps under
the 'step' lr policy with the gradient clip acting, against JAX's
make_train_step. Then the port's dropout on its own (keep rate, scale,
eval identity, the bits of a generator state) and the surgery's graft."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscl_torch.convert import jax_to_state_dict, load_jax_variables
from mscl_torch.core import build_lr_schedule, build_optimizer
from mscl_torch.core import make_train_step
from mscl_torch.models import HEADS, RECOGNIZERS
from mscl_torch.models.recognizers import (get_ssl_state_dict, graft,
                                           init_from_ssl_pretrain)
from mscl_tpu.core import build_lr_schedule as jax_lr
from mscl_tpu.core import build_optimizer as jax_optimizer
from mscl_tpu.core import init_state
from mscl_tpu.core.train_loop import make_train_step as jax_train_step
from mscl_tpu.models import RECOGNIZERS as J_RECOGNIZERS

from _torch_port_util import perturb, t, xla3d_conv  # noqa: F401

B, T, HW, CLASSES = 4, 4, 32, 10
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-3, atol=1e-4)
OPT = dict(type='SGD', lr=0.1, momentum=0.9, weight_decay=1e-6)
LR = dict(policy='step', step=[1])


def _cfg(average_clips='prob'):
    return dict(backbone=dict(type='torchvision.r3d_18', base_width=8),
                cls_head=dict(type='I3DHead', num_classes=CLASSES,
                              in_channels=64, spatial_type='none',
                              dropout_ratio=0.0),
                test_cfg=dict(average_clips=average_clips))


def _batch(seed, segs=1):
    rng = np.random.default_rng(seed)
    return dict(imgs=rng.normal(size=(B, segs, 3, T, HW, HW)).astype(
        np.float32), label=rng.integers(0, CLASSES, B))


def _port(variables, average_clips='prob'):
    model = RECOGNIZERS.get('Recognizer3D')(**_cfg(average_clips))
    load_jax_variables(model, variables)
    return model


@pytest.fixture(scope='module')
def pair(xla3d_conv):
    jmodel = J_RECOGNIZERS.get('Recognizer3D')(**_cfg())
    b = _batch(0)
    v = jax.jit(jmodel.init)({'params': jax.random.PRNGKey(0),
                              'dropout': jax.random.PRNGKey(1)},
                             jnp.asarray(b['imgs']))
    variables = {'params': perturb(v['params'], 2),
                 'batch_stats': perturb(v['batch_stats'], 3)}

    def loss_fn(params):
        losses, new = jmodel.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jnp.asarray(b['imgs']), jnp.asarray(b['label']), train=True,
            mutable=['batch_stats'])
        return losses['loss_cls'], (losses, new)

    grads, (losses, new) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        variables['params'])
    return dict(jmodel=jmodel, variables=variables, batch=b, grads=grads,
                losses=jax.tree.map(np.asarray, losses),
                new_stats=new['batch_stats'])


def test_conversion_covers_the_model(pair):
    model = RECOGNIZERS.get('Recognizer3D')(**_cfg())
    sd = jax_to_state_dict(pair['variables'])
    assert sorted(sd) == sorted(model.state_dict())
    assert 'cls_head.fc_cls.weight' in sd and 'backbone.stem.0.weight' in sd


def test_forward_train_losses_stats_and_grads(pair):
    model = _port(pair['variables'])
    model.train()
    losses = model.forward_train(t(pair['batch']['imgs']),
                                 t(pair['batch']['label']))
    assert sorted(losses) == sorted(pair['losses']) == \
        ['loss_cls', 'top1_acc', 'top5_acc']
    for k, want in pair['losses'].items():
        np.testing.assert_allclose(losses[k].item(), want, **LOSS_TOL,
                                   err_msg=k)
    losses['loss_cls'].backward()
    want = jax_to_state_dict({'params': pair['grads']})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], **GRAD_TOL,
                                   err_msg=name)
    stats = jax_to_state_dict({'batch_stats': pair['new_stats']})
    got = model.state_dict()
    for name, v in stats.items():
        np.testing.assert_allclose(got[name].numpy(), v, rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize('segs', [1, 2])
@pytest.mark.parametrize('average_clips', ['prob', 'score'])
def test_forward_test_matches(pair, average_clips, segs):
    jmodel = pair['jmodel'].clone(test_cfg=dict(average_clips=average_clips))
    imgs = _batch(5, segs)['imgs']
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(
        v, x, train=False, return_loss=False))(pair['variables'],
                                               jnp.asarray(imgs)))
    model = _port(pair['variables'], average_clips).eval()
    with torch.no_grad():
        got = model.forward_test(t(imgs)).numpy()
    assert got.shape == want.shape == (B, CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    if average_clips == 'prob':
        np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)


@pytest.mark.parametrize('segs', [1, 2])
def test_extract_features_pooled_matches(pair, segs):
    imgs = _batch(6, segs)['imgs']
    want = np.asarray(pair['jmodel'].apply(
        pair['variables'], jnp.asarray(imgs),
        method='extract_features_pooled'))
    model = _port(pair['variables']).eval()
    with torch.no_grad():
        got = model.extract_features_pooled(t(imgs)).numpy()
    assert got.shape == want.shape == (B, 64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_two_sgd_steps_match(pair):
    """Step 1 at lr 0.1, step 2 at 0.01 ('step' at epoch 1 of 1-step
    epochs); the clip's max_norm is half the first gradient's norm."""
    norm = float(np.sqrt(sum(np.sum(np.square(g)) for g in
                             jax.tree.leaves(pair['grads']))))
    clip = dict(max_norm=norm / 2, norm_type=2)
    batches = [pair['batch'], _batch(7)]
    jmodel = pair['jmodel']
    tx = jax_optimizer(dict(OPT), jax_lr(dict(LR), 0.1, 2, 1),
                       grad_clip=clip)
    state = init_state(jmodel, tx, {k: jnp.asarray(v) for k, v in
                                    batches[0].items()},
                       post_init_fn=lambda v: dict(pair['variables']))
    jstep = jax.jit(jax_train_step(jmodel, tx))
    jlogs = []
    for b in batches:
        state, lv = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        jlogs.append({k: float(v) for k, v in lv.items()})

    model = _port(pair['variables'])
    opt = build_optimizer(model, dict(OPT), build_lr_schedule(dict(LR), 0.1,
                                                              2, 1),
                          grad_clip=clip)
    step = make_train_step(model, opt)
    for b, want in zip(batches, jlogs):
        got = {k: v.item() for k, v in step({k: t(v) for k, v in
                                             b.items()}).items()}
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **LOSS_TOL,
                                       err_msg=k)
    assert opt.steps == int(state.step) == 2
    want = jax_to_state_dict({'params': state.params,
                              'batch_stats': state.batch_stats})
    got = model.state_dict()
    for name, v in want.items():
        tol = GRAD_TOL if 'running' not in name else dict(rtol=1e-4,
                                                          atol=1e-4)
        np.testing.assert_allclose(got[name].numpy(), v, **tol,
                                   err_msg=name)


def _head(p):
    head = HEADS.get('I3DHead')(num_classes=3, in_channels=8,
                                dropout_ratio=p)
    head.seed_dropout(5)
    return head.train()


def test_dropout_keep_rate_scale_and_eval():
    p = 0.3
    head = _head(p)
    x = torch.ones(400, 500)
    out = head.dropout(x)
    kept = out != 0
    n = x.numel()
    assert abs(kept.float().mean().item() - (1 - p)) < \
        4 * np.sqrt(p * (1 - p) / n)
    assert torch.equal(out[kept], torch.full((int(kept.sum()),),
                                             1 / (1 - p)))
    head.eval()
    assert head.dropout(x) is x
    y = torch.randn(2, 8)
    torch.testing.assert_close(head(y[:, :, None, None, None]),
                               head.fc_cls(y), rtol=0, atol=0)


def test_dropout_bits_follow_the_generator_state():
    head = _head(0.5)
    x = torch.randn(16, 8)
    first = head.dropout(x)
    state = head.dropout_state()
    second = head.dropout(x)
    assert not torch.equal(first, second)
    head.seed_dropout(5)
    assert torch.equal(head.dropout(x), first)
    head.set_dropout_state(state)
    assert torch.equal(head.dropout(x), second)
    assert _head(0.5).dropout_state() is None     # made at the first batch


def test_graft_skips_extras_and_reports_mismatch():
    target = {'conv.weight': torch.zeros(2, 3), 'fc.weight': torch.zeros(4),
              'bn.running_mean': torch.zeros(2),
              'bn.weight': torch.zeros(5, dtype=torch.float64)}
    source = {'conv.weight': torch.ones(2, 3), 'fc.weight': torch.ones(4),
              'bn.running_mean': torch.ones(3),
              'bn.weight': torch.ones(5), 'bn.num_batches_tracked':
              torch.tensor(7)}
    out, missing = graft(target, source, extras=('fc',))
    assert torch.equal(out['conv.weight'], source['conv.weight'])
    assert torch.equal(out['fc.weight'], target['fc.weight'])
    assert torch.equal(out['bn.running_mean'], target['bn.running_mean'])
    assert out['bn.weight'].dtype == torch.float64
    assert missing == ['bn.running_mean (shape mismatch)']
    assert 'bn.num_batches_tracked' not in out


def test_ssl_state_dict_keys_and_init(capsys):
    ckpt = {'module.recognizer.encoder_q.stem.0.weight': torch.ones(2),
            'module.recognizer.encoder_q.layer1.0.conv1.0.weight':
            torch.full((3,), 2.0),
            'module.recognizer.encoder_k.stem.0.weight': torch.zeros(2)}
    src = get_ssl_state_dict(
        ckpt, revise_keys=[(r'^module\.', '')],
        duplicate_keys=[(r'layer1\.0', 'layer1.1')],
        prefix='recognizer.encoder_q')
    assert sorted(src) == ['layer1.0.conv1.0.weight',
                           'layer1.1.conv1.0.weight', 'stem.0.weight']
    sd = {'backbone.stem.0.weight': torch.zeros(2),
          'backbone.layer1.1.conv1.0.weight': torch.zeros(3),
          'backbone.layer2.0.conv1.0.weight': torch.zeros(1),
          'cls_head.fc_cls.weight': torch.zeros(1)}
    out = init_from_ssl_pretrain(sd, ckpt, revise_keys=[(r'^module\.', '')],
                                 duplicate_keys=[(r'layer1\.0', 'layer1.1')])
    assert torch.equal(out['backbone.stem.0.weight'], torch.ones(2))
    assert torch.equal(out['backbone.layer1.1.conv1.0.weight'],
                       torch.full((3,), 2.0))
    assert out['cls_head.fc_cls.weight'] is sd['cls_head.fc_cls.weight']
    assert "1 params not loaded (first few: ['layer2.0.conv1.0.weight'])" \
        in capsys.readouterr().out
    with pytest.raises(KeyError, match='neck not in the model'):
        init_from_ssl_pretrain(sd, ckpt, module_name='neck')


class _LastStageNeck(torch.nn.Module):
    """A neck with the interface Recognizer3D expects: the stages in, the
    last one out, and an auxiliary loss."""

    def __init__(self, dtype=None):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones(()))

    def forward(self, feats, labels=None):
        aux = {} if labels is None else {
            'loss_aux': self.scale * feats[-1].mean() * 0 + labels.numel()}
        return [feats[0], feats[-1] * self.scale], aux


def test_neck_path():
    from mscl_torch.models import NECKS
    if 'test.LastStageNeck' not in NECKS:
        NECKS.register_module(name='test.LastStageNeck',
                              module=_LastStageNeck)
    cfg = dict(_cfg(), neck=dict(type='test.LastStageNeck'))
    model = RECOGNIZERS.get('Recognizer3D')(**cfg)
    plain = RECOGNIZERS.get('Recognizer3D')(**_cfg())
    plain.load_state_dict({k: v for k, v in model.state_dict().items()
                           if not k.startswith('neck.')})
    b = _batch(8)
    model.train()
    plain.train()
    losses = model.forward_train(t(b['imgs']), t(b['label']))
    want = plain.forward_train(t(b['imgs']), t(b['label']))
    assert sorted(losses) == ['loss_aux', 'loss_cls', 'top1_acc',
                              'top5_acc']
    assert losses['loss_aux'].item() == B
    torch.testing.assert_close(losses['loss_cls'], want['loss_cls'])
    model.eval()
    plain.eval()
    with torch.no_grad():
        torch.testing.assert_close(model.forward_test(t(b['imgs'])),
                                   plain.forward_test(t(b['imgs'])))
