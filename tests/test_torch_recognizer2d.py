"""The frame-based backbones of mscl_torch against mscl_tpu's, on the CPU:
ResNetTSM (depth 18 with norm_eval and every stage out; depth 50 with
temporal_pool and non-local blocks), ResNetTIN and TANet (Bottleneck
blocks, one a stage), MobileNetV2TSM (one block a stage but the second)
and ResNet3d with non-local blocks (C3D is held through its recipe,
tests/test_torch_recognition_tin_tanet.py): every output, every parameter
gradient of a train-mode forward and backward, and the BN running
statistics it leaves, from the same (perturbed) weights carried across by
``mscl_torch.convert``; ``temporal_shift`` bitwise; NonLocal3d in each
mode; Recognizer2D's test paths and its refusal of a neck.

Shapes (ROADMAP): 32x32 frames, 8 segments, a batch of 2.
Tolerances: outputs and BN statistics 1e-4, gradients rtol 5e-3, atol 1e-4.
The Bottleneck stacks, MobileNetV2 and ResNet3d run in float64 on both
sides (JAX with x64 and flax's BatchNorm, as tests/test_torch_resnet3d.py
holds its deep cases; in float32 their train-mode BN at 32x32 is too
ill-conditioned for the gradient tolerance). The backward is that of sum
<out, w> / sqrt(size), w normal from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscl_tpu.models import BACKBONES as JAX_BACKBONES
from mscl_tpu.models import RECOGNIZERS as JAX_RECOGNIZERS
from mscl_tpu.models.backbones import resnet2d as jax_resnet2d
from mscl_tpu.models.backbones import resnet3d as jax_resnet3d
from mscl_torch.convert import jax_to_state_dict, load_jax_variables
from mscl_torch.models import BACKBONES, RECOGNIZERS
from mscl_torch.models.backbones import resnet2d, resnet3d

from _torch_data_util import one_torch_thread  # noqa: F401
from _torch_recognition_util import (ONE_BASIC, ONE_BOTTLENECK, cut_tables,
                                    port_to_jax)
from _torch_port_util import ncthw, nthwc, perturb, t, xla3d_conv  # noqa: F401
from _torch_step_util import jax_float64

pytestmark = pytest.mark.usefixtures('one_torch_thread', 'xla3d_conv')
N, SEGS, HW = 2, 8, 32
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=5e-3, atol=1e-4)

CASES = {
    # name -> (config, float64, input shape as the port takes it)
    'resnet18_tsm_norm_eval': (dict(type='ResNetTSM', depth=18,
                                    shift_div=4, norm_eval=True,
                                    out_indices=(0, 1, 2, 3)),
                               False, (N * SEGS, 3, HW, HW)),
    'tsm_r50_tpool_nonlocal': (dict(
        type='ResNetTSM', depth=50, temporal_pool=True,
        non_local=(0, (1, 0, 1, 0), 0, 0),
        non_local_cfg=dict(sub_sample=True, use_scale=False),
        out_indices=(1, 3)), True, (N * SEGS, 3, HW, HW)),
    'tin_bottleneck': (dict(type='ResNetTIN', depth=ONE_BOTTLENECK), True,
                       (N * SEGS, 3, HW, HW)),
    'tanet_bottleneck': (dict(type='TANet', depth=ONE_BOTTLENECK), True,
                         (N * SEGS, 3, HW, HW)),
    'mobilenet_v2_tsm': (dict(type='MobileNetV2TSM', out_indices=(3, 7)),
                         True, (N * SEGS, 3, HW, HW)),
    'r3d18_nonlocal': (dict(type='ResNet3d', depth=18, base_channels=8,
                            stage_blocks=(1, 1, 1, 1), non_local=(0, 1, 1, 0),
                            non_local_cfg=dict(mode='dot_product'),
                            out_indices=(3,)), True, (N, 3, 4, HW, HW)),
}


def _to_jax(x):
    return nthwc(x) if x.ndim == 5 else np.transpose(x, (0, 2, 3, 1))


def _to_port(x):
    x = np.asarray(x)
    return ncthw(x) if x.ndim == 5 else np.transpose(x, (0, 3, 1, 2))


def _listed(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _port_init(jmodel, tmodel, x, *args):
    """The JAX tree (traced, not run) holding the port's init."""
    tmodel.init_weights(torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(lambda r, v: jmodel.init(r, v, *args),
                            jax.random.PRNGKey(0), x)
    return port_to_jax(shapes, {k: v.numpy() for k, v in
                                tmodel.state_dict().items()}, jnp.float32)


def _jax_pass(jmodel, variables, x, weights):
    def loss(params):
        out, new = jmodel.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            _to_jax(x), train=True, mutable=['batch_stats'])
        out = _listed(out)
        return sum(jnp.sum(o * _to_jax(w)) for o, w in zip(out, weights)), \
            (out, new)

    (_, (outs, new)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables['params'])
    return ([_to_port(o) for o in outs], jax_to_state_dict({'params': grads}),
            jax_to_state_dict({'batch_stats': new['batch_stats']}))


def _torch_pass(tmodel, x, weights):
    tmodel.train()
    outs = _listed(tmodel(t(x)))
    sum((o * t(w)).sum() for o, w in zip(outs, weights)).backward()
    return ([o.detach().numpy() for o in outs],
            {k: p.grad.numpy() for k, p in tmodel.named_parameters()},
            {k: v.numpy() for k, v in tmodel.state_dict().items()
             if 'running' in k})


def _run(name):
    cfg, x64, shape = CASES[name]
    cfg = dict(cfg)
    typ = cfg.pop('type')
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    jmodel = JAX_BACKBONES.get(typ)(**cfg)
    tmodel = BACKBONES.get(typ)(**cfg)
    variables = _port_init(jmodel, tmodel, _to_jax(x))
    variables = {'params': perturb(variables['params'], 2),
                 'batch_stats': perturb(variables['batch_stats'], 3)}
    load_jax_variables(tmodel, variables)
    outs = _listed(jax.eval_shape(lambda v: jmodel.apply(
        variables, v, train=False), _to_jax(x)))
    weights = [(rng.normal(size=_to_port(np.empty(o.shape, bool)).shape) /
                np.sqrt(o.size)).astype(np.float32) for o in outs]
    old = jax_to_state_dict({'batch_stats': variables['batch_stats']})
    if not x64:
        return old, _jax_pass(jmodel, variables, x, weights), \
            _torch_pass(tmodel, x, weights)
    with jax_float64():
        jmodel = JAX_BACKBONES.get(typ)(dtype=jnp.float64, **cfg)
        want = _jax_pass(jmodel, jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), variables),
            x.astype(np.float64), [w.astype(np.float64) for w in weights])
    return old, want, _torch_pass(tmodel.double(), x.astype(np.float64),
                                  [w.astype(np.float64) for w in weights])


@pytest.fixture(scope='module', params=sorted(CASES))
def run(request, xla3d_conv):
    with cut_tables():
        return request.param, _run(request.param)


def test_outputs_match(run):
    name, (_, want, got) = run
    assert len(got[0]) == len(want[0])
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_param_grads_match(run):
    name, (_, want, got) = run
    assert sorted(got[1]) == sorted(want[1])
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k],
                                   err_msg=f'{name} {k}', **GRAD_TOL)


def test_bn_running_stats_match(run):
    name, (old, want, got) = run
    assert sorted(got[2]) == sorted(want[2])
    norm_eval = CASES[name][0].get('norm_eval', False)
    for k in want[2]:
        # norm_eval: the statistics stay; otherwise every one moves
        assert np.allclose(want[2][k], old[k]) == norm_eval, k
        np.testing.assert_allclose(got[2][k], want[2][k],
                                   err_msg=f'{name} {k}', **TOL)


def test_temporal_shift_bitwise():
    x = np.random.default_rng(2).normal(size=(N * SEGS, 16, 5, 3)).astype(
        np.float32)
    for div in (8, 4, 3):
        want = jax_resnet2d.temporal_shift(jnp.asarray(_to_jax(x)), SEGS,
                                           div)
        got = resnet2d.temporal_shift(t(x), SEGS, div)
        np.testing.assert_array_equal(got.numpy(), _to_port(want))


@pytest.mark.parametrize('mode,sub_sample', [
    ('embedded_gaussian', False), ('embedded_gaussian', True),
    ('gaussian', True), ('dot_product', False)])
def test_non_local_block_matches(mode, sub_sample):
    """NonLocal3d alone in train mode: output, gradients in the input and
    the parameters, and its BN statistics."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 4, 6, 6)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32) / 24
    kw = dict(mode=mode, sub_sample=sub_sample)
    jblock = jax_resnet3d.NonLocal3d(16, **kw)
    variables = jblock.init(jax.random.PRNGKey(0), nthwc(x), train=False)
    variables = {'params': perturb(variables['params'], 4, scale=0.5),
                 'batch_stats': perturb(variables['batch_stats'], 5)}

    def loss(params, xx):
        out, new = jblock.apply(
            {'params': params, 'batch_stats': variables['batch_stats']}, xx,
            train=True, mutable=['batch_stats'])
        return jnp.sum(out * nthwc(w)), (out, new)
    (_, (want, new)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables['params'],
                                             jnp.asarray(nthwc(x)))
    tblock = resnet3d.NonLocal3d(16, **kw)
    load_jax_variables(tblock, variables)
    tblock.train()
    tx = t(x).requires_grad_()
    got = tblock(tx)
    (got * t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), ncthw(want), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), ncthw(jgx), **GRAD_TOL)
    for k, v in jax_to_state_dict({'params': jgp}).items():
        np.testing.assert_allclose(
            dict(tblock.named_parameters())[k].grad.numpy(), v, err_msg=k,
            **GRAD_TOL)
    for k, v in jax_to_state_dict({'batch_stats': new['batch_stats']}
                                  ).items():
        np.testing.assert_allclose(tblock.state_dict()[k].numpy(), v,
                                   err_msg=k, **TOL)


def test_non_local_init_is_identity():
    block = resnet3d.NonLocal3d(8)
    block.init_weights(torch.Generator().manual_seed(0))
    block.eval()
    x = torch.randn(1, 8, 2, 4, 4)
    with torch.no_grad():
        assert torch.equal(block(x), x)


MODEL = dict(type='Recognizer2D',
             backbone=dict(type='ResNet', depth=ONE_BOTTLENECK,
                           pretrained='torchvision'),
             cls_head=dict(type='TSNHead', num_classes=5, in_channels=2048,
                           dropout_ratio=0.0))


@pytest.mark.parametrize('test_cfg', [
    dict(average_clips='prob'), dict(average_clips='score'),
    dict(feature_extraction=True), 'headless'])
def test_recognizer2d_test_paths(test_cfg):
    """forward_test (scores, softmaxed with 'prob') and the pooled
    features of a headless or feature_extraction model, from the
    (B, segments, C, H, W) batch, against JAX's."""
    cfg = dict(MODEL, test_cfg=test_cfg)
    if test_cfg == 'headless':
        cfg = dict(MODEL, cls_head=None)
    imgs = np.random.default_rng(6).normal(size=(N, 3, 3, HW, HW)).astype(
        np.float32)
    jcfg = dict(cfg)
    jmodel = JAX_RECOGNIZERS.get(jcfg.pop('type'))(**jcfg)
    tcfg = dict(cfg)
    with cut_tables():
        model = RECOGNIZERS.get(tcfg.pop('type'))(**tcfg)
        variables = _port_init(jmodel, model, jnp.asarray(imgs), None if
                               test_cfg == 'headless' else
                               jnp.zeros(N, jnp.int32))
        variables = {'params': perturb(variables['params'], 7),
                     'batch_stats': perturb(variables['batch_stats'], 8)}
        want = jax.jit(lambda v, x: jmodel.apply(
            v, x, method='forward_test'))(variables, jnp.asarray(imgs))
    load_jax_variables(model, variables)
    model.eval()
    with torch.no_grad():
        got = model.forward_test(t(imgs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_recognizer2d_refuses_a_neck():
    """A neck the port does not register is refused by its name; TPN, now
    ported, builds (tests/test_torch_tpn.py holds it against JAX's)."""
    with pytest.raises(KeyError, match='NoSuchNeck'):
        RECOGNIZERS.get('Recognizer2D')(
            backbone=dict(type='ResNetTSM', depth=18),
            neck=dict(type='NoSuchNeck'), cls_head=dict(type='TSMHead'))
    model = RECOGNIZERS.get('Recognizer2D')(
        backbone=dict(type='ResNetTSM', depth=18, out_indices=(2, 3)),
        neck=dict(type='TPN', in_channels=(256, 512), out_channels=64),
        cls_head=dict(type='TSMHead', in_channels=512))
    assert model.neck is not None


def test_mmaction_names():
    """ConvModule names as mmaction's ResNet: a reference .pth loads."""
    keys = set(BACKBONES.get('ResNetTSM')(depth=50).state_dict())
    for k in ('conv1.conv.weight', 'conv1.bn.running_var',
              'layer1.0.conv2.conv.weight', 'layer1.0.downsample.bn.bias',
              'layer4.2.conv3.bn.running_mean'):
        assert k in keys, k


@pytest.mark.parametrize('head', ['TSMReidSimpleHead', 'FGTSMReidSimpleHead'])
def test_recognizer2d_trains_a_reid_head(head):
    """A train step of Recognizer2D with a reid head: the labels reach the
    head (the cosface margin), the pooled feature its triplet loss; the
    loss terms, every parameter gradient and the BN statistics (the
    BN-neck's too) against JAX's."""
    cfg = dict(type='Recognizer2D',
               backbone=dict(type='ResNetTSM', depth=ONE_BASIC),
               cls_head=dict(type=head, num_classes=4, in_channels=512,
                             num_segments=SEGS, dropout_ratio=0.0,
                             use_cosface=dict(use=True, s=16, m=0.2)))
    rng = np.random.default_rng(9)
    batch = dict(imgs=rng.normal(size=(4, SEGS, 3, HW, HW)).astype(
        np.float32), label=np.array([0, 1, 0, 1]))
    jcfg, tcfg = dict(cfg), dict(cfg)
    jmodel = JAX_RECOGNIZERS.get(jcfg.pop('type'))(**jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with cut_tables():
        model = RECOGNIZERS.get(tcfg.pop('type'))(**tcfg)
        variables = _port_init(jmodel, model, jbatch['imgs'], jbatch['label'])
        variables = {'params': perturb(variables['params'], 10),
                     'batch_stats': perturb(variables['batch_stats'], 11)}

        def loss(params):
            (total, log_vars), new = jmodel.apply(
                dict(variables, params=params), jbatch, method='train_step',
                mutable=['batch_stats'])
            return total, (log_vars, new)
        (_, (jlog, new)), jgrads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(variables['params'])
    load_jax_variables(model, variables)
    model.train()
    total, log_vars = model.train_step({k: t(v) for k, v in batch.items()})
    total.backward()
    assert sorted(log_vars) == sorted(jlog) and 'loss_reid' in log_vars
    for k, v in jlog.items():
        np.testing.assert_allclose(log_vars[k].detach().numpy(),
                                   np.asarray(v), err_msg=k, rtol=2e-4,
                                   atol=2e-4)
    params = dict(model.named_parameters())
    for k, v in jax_to_state_dict({'params': jgrads}).items():
        grad = params[k].grad      # None: cosface leaves the bias unused
        np.testing.assert_allclose(np.zeros_like(v) if grad is None else
                                   grad.numpy(), v, err_msg=k, **GRAD_TOL)
    state = model.state_dict()
    for k, v in jax_to_state_dict({'batch_stats': new['batch_stats']}
                                  ).items():
        np.testing.assert_allclose(state[k].numpy(), v, err_msg=k, **TOL)


def test_recognizer2d_refuses_a_multi_class_target():
    """The JAX Recognizer2D flattens every target, so a multi-class one
    (N, classes), as tsn_r101_..._mmit's data gives, fails to broadcast in
    its loss before any step; the port refuses it by name. The same
    refusal covers tsn_r18_1x1x8_100e_hvu_action_rgb's one-hot target
    under HVULoss (tests/test_torch_localization.py)."""
    cfg = dict(backbone=dict(type='ResNet', depth=ONE_BASIC),
               cls_head=dict(type='TSNHead', num_classes=5, in_channels=512,
                             multi_class=True, dropout_ratio=0.0,
                             loss_cls=dict(type='BCELossWithLogits')))
    imgs, labels = np.zeros((2, 3, 3, HW, HW), np.float32), \
        np.eye(5, dtype=np.float32)[:2]
    with cut_tables():
        jmodel = JAX_RECOGNIZERS.get('Recognizer2D')(**cfg)
        with pytest.raises(ValueError, match='Incompatible shapes'):
            jax.eval_shape(lambda: jmodel.init(
                jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(labels)))
        model = RECOGNIZERS.get('Recognizer2D')(**cfg)
    with pytest.raises(NotImplementedError, match='multi_class'):
        model.train_step(dict(imgs=t(imgs), label=t(labels)))
