"""mscl_torch's ResNet3d / ResNet3dSlowOnly and the bottleneck flow ResNet
(``resnet_flow.r2d_50``) against mscl_tpu's, on the CPU: every stage output
and every parameter gradient of a train-mode forward and backward, and the
BN running statistics it leaves, from the same converted weights.

The backward is that of sum_i <out_i, w_i> / sqrt(size of out_i), w_i
normal from a seed: the random signs scaled so that the parameter gradients
are of order one, as a training loss's are. Tolerances: outputs and BN
statistics 1e-4 (tests/test_torch_backbones.py), gradients rtol 5e-3, atol
1e-4 (the port's gradient tolerance). The depth-50 cases are held against
JAX's float64 run, as the comment on DEEP says.
"""
import contextlib
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscl_tpu.models import BACKBONES as JAX_BACKBONES
from mscl_tpu.models.backbones import resnet3d as jax_resnet3d
from mscl_torch.convert import jax_to_state_dict, load_jax_variables
from mscl_torch.models import BACKBONES
from mscl_torch.models.backbones import resnet3d

from _torch_port_util import ncthw, nthwc, perturb, t, xla3d_conv  # noqa: F401

# the r50 configs' backbone (configs/recognition/moco/mscl_r50_cosm_lr3e-2.py)
R50 = dict(type='ResNet3dSlowOnly', depth=50, pretrained=None,
           pretrained2d=False, lateral=False, num_stages=4,
           conv1_kernel=(5, 7, 7), conv1_stride_t=2, pool1_stride_t=1,
           spatial_strides=(1, 2, 2, 2), out_indices=(0, 1, 2, 3))

CASES = {
    # name -> (config, input (C, T, H, W))
    'slowonly_r50': (dict(R50, base_channels=4), (3, 8, 32, 32)),
    'r18_inflated': (dict(type='ResNet3d', depth=18, base_channels=4,
                          stage_blocks=(1, 1, 1, 1), inflate=(1, 1, 1, 1),
                          temporal_strides=(1, 2, 1, 1),
                          out_indices=(0, 1, 2, 3)), (3, 8, 32, 32)),
    'r18_not_inflated': (dict(type='ResNet3d', depth=18, base_channels=4,
                              stage_blocks=(1, 1, 1, 1), inflate=0,
                              with_pool2=False, out_indices=(1, 3)),
                         (3, 4, 32, 32)),
    'r18_3x3x3': (dict(type='ResNet3dSlowOnly', depth=18, base_channels=4,
                       stage_blocks=(2, 1, 1, 1), inflate_style='3x3x3',
                       inflate=((1, 0), 1, 0, 1), dilations=(1, 1, 2, 1),
                       out_indices=(3,)), (3, 4, 32, 32)),
    'r2d_50': (dict(type='resnet_flow.r2d_50'), (3, 8, 32, 32)),
}


# The depth-50 stacks at 32x32 in train mode are ill-conditioned in
# float32: at the last stages the positions of a channel carry nearly the
# same value (8 of them a channel at layer4), so a BN's variance is small
# beside its mean, and the backward amplifies every rounding. JAX's float32
# (its BN takes E[x^2] - E[x]^2 in float32, mscl_tpu/ops/split_bn.py) lands
# up to 1.9e4 times the gradient tolerance from its own float64 result, and
# 64x64 does not cure it (still 1.6e3 times). So in these cases JAX runs in
# float64 (x64 on, the model's dtype float64, and flax's nn.BatchNorm through
# MSCL_BN_IMPL=flax, since LowPrecisionBatchNorm takes float32 statistics
# whatever its input) and is the reference for two runs of the port:
#  - its float64 run, every tensor within the tolerances above with no
#    exception (a wrong padding, stride or dilation anywhere fails here: the
#    two land within 2e-7 of the tolerances);
#  - its float32 run, every tensor within the tolerances, or, for a tensor
#    that misses them, no farther from JAX's float64 in relative L2 norm
#    than ULP_MULT times the larger distance that one ulp on the input
#    (x * (1 - 2^-24), x * (1 + 2^-23)) moves the port's float32 run: that
#    the gap is the float32 conditioning and not a fault. The ratio measured
#    is at most 3.1 (3.9 on one thread); ULP_MULT leaves twice that.
DEEP = ('slowonly_r50', 'r2d_50')
ULP_MULT = 8.0
ULPS = (1 - 2.0 ** -24, 1 + 2.0 ** -23)


def _build(cfg):
    cfg = dict(cfg)
    typ = cfg.pop('type')
    jmodel = JAX_BACKBONES.get(typ)(**cfg)
    tmodel = BACKBONES.get(typ)(in_channels=3, **cfg)
    return jmodel, tmodel


def _listed(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _jax_pass(jmodel, variables, x, weights):
    """Train-mode outputs (NCTHW), parameter gradients and new BN
    statistics (state dicts) of the JAX model, in the dtype of x."""
    def loss(params):
        out, new = jmodel.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            nthwc(x), train=True, mutable=['batch_stats'])
        out = _listed(out)
        return sum(jnp.sum(o * nthwc(w)) for o, w in zip(out, weights)), \
            (out, new)

    (_, (outs, new)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables['params'])
    return ([ncthw(o) for o in outs], jax_to_state_dict({'params': grads}),
            jax_to_state_dict({'batch_stats': new['batch_stats']}))


@contextlib.contextmanager
def _flax_bn():
    prev = os.environ.get('MSCL_BN_IMPL')
    os.environ['MSCL_BN_IMPL'] = 'flax'
    try:
        yield
    finally:
        if prev is None:
            del os.environ['MSCL_BN_IMPL']
        else:
            os.environ['MSCL_BN_IMPL'] = prev


def _jax64_pass(cfg, variables, x, weights):
    """``_jax_pass`` of cfg's JAX model in float64 throughout."""
    cfg = dict(cfg)
    typ = cfg.pop('type')
    with jax.enable_x64(True), _flax_bn():
        jmodel = JAX_BACKBONES.get(typ)(dtype=jnp.float64, **cfg)
        return _jax_pass(jmodel, jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), variables),
            x.astype(np.float64), [w.astype(np.float64) for w in weights])


def _torch_pass(tmodel, x, weights):
    """The same of the port's model, in the dtype of x."""
    tmodel.train()
    tmodel.zero_grad()
    outs = _listed(tmodel(t(x)))
    sum((o * t(w)).sum() for o, w in zip(outs, weights)).backward()
    return ([o.detach().numpy() for o in outs],
            {k: p.grad.numpy().copy() for k, p in tmodel.named_parameters()},
            {k: v.numpy().copy() for k, v in tmodel.state_dict().items()
             if 'running' in k})


def _run(name):
    cfg, shape = CASES[name]
    jmodel, tmodel = _build(cfg)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2,) + shape).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), nthwc(x), train=False)
    variables = {'params': perturb(variables['params'], 2),
                 'batch_stats': perturb(variables['batch_stats'], 3)}
    load_jax_variables(tmodel, variables)
    start = copy.deepcopy(tmodel.state_dict())
    outs = _listed(jmodel.apply(variables, nthwc(x), train=False))
    weights = [(rng.normal(size=ncthw(o).shape) / np.sqrt(o.size))
               .astype(np.float32) for o in outs]
    r = dict(old_stats=jax_to_state_dict(
        {'batch_stats': variables['batch_stats']}))
    if name not in DEEP:
        r['jax'] = _jax_pass(jmodel, variables, x, weights)
        r['port'] = _torch_pass(tmodel, x, weights)
        return r
    r['jax'] = _jax64_pass(cfg, variables, x, weights)
    model64 = copy.deepcopy(tmodel).double()
    r['port64'] = _torch_pass(model64, x.astype(np.float64),
                              [w.astype(np.float64) for w in weights])
    r['ulp'] = []
    for f in ULPS:
        tmodel.load_state_dict(start)
        r['ulp'].append(_torch_pass(tmodel, x * np.float32(f), weights))
    tmodel.load_state_dict(start)
    r['port'] = _torch_pass(tmodel, x, weights)
    return r


def _held(name, r, part, rtol, atol):
    """Every tensor of ``part`` (0 outputs, 1 gradients, 2 BN statistics)
    of the port within (rtol, atol) of JAX's, or in a DEEP case as the
    comment on DEEP says."""
    want = r['jax'][part]
    keys = range(len(want)) if part == 0 else sorted(want)
    for run in ('port', 'port64') if name in DEEP else ('port',):
        got = r[run][part]
        if part:
            assert sorted(got) == sorted(want), run
        for k in keys:
            gap = np.abs(got[k] - want[k])
            if np.all(gap <= atol + rtol * np.abs(want[k])):
                continue
            assert run == 'port' and name in DEEP, \
                f'{name} {run} {k}: max gap {gap.max()}'
            norm = np.linalg.norm(want[k])
            err = np.linalg.norm(got[k] - want[k]) / norm
            ulp = max(np.linalg.norm(got[k] - c[part][k])
                      for c in r['ulp']) / norm
            assert err <= ULP_MULT * ulp, (name, k, err, ulp)


@pytest.fixture(scope='module', params=sorted(CASES))
def run(request, xla3d_conv):
    return request.param, _run(request.param)


def test_stage_outputs_match(run):
    name, r = run
    assert len(r['port'][0]) == len(r['jax'][0])
    _held(name, r, 0, 1e-4, 1e-4)


def test_param_grads_match(run):
    _held(*run, 1, 5e-3, 1e-4)


def test_bn_running_stats_match(run):
    name, r = run
    for k, before in r['old_stats'].items():
        assert not np.allclose(r['jax'][2][k], before), k
    _held(name, r, 2, 1e-4, 1e-4)


def test_mmaction_names():
    """ConvModule names as mmaction's: a reference .pth loads as it is."""
    model = BACKBONES.get('ResNet3dSlowOnly')(**{
        k: v for k, v in dict(R50, base_channels=4).items() if k != 'type'})
    keys = set(model.state_dict())
    for k in ('conv1.conv.weight', 'conv1.bn.running_var',
              'layer1.0.conv2.conv.weight', 'layer1.0.conv2.bn.weight',
              'layer1.0.downsample.conv.weight',
              'layer4.2.conv3.bn.running_mean'):
        assert k in keys, k
    assert not any('.0.weight' in k.split('conv')[-1] for k in keys
                   if k.endswith('.0.weight'))


@pytest.mark.parametrize('style,inflate', [('3x1x1', True),
                                           ('3x3x3', True),
                                           ('3x3x3', False)])
def test_bottleneck_block_styles(xla3d_conv, style, inflate):
    """Bottleneck3d in either inflate style, strided, dilated, with its
    downsample, against the JAX block built with the same style."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 4, 12, 12)).astype(np.float32)
    kw = dict(spatial_stride=2, temporal_stride=2, dilation=2,
              inflate=inflate, inflate_style=style)
    jblock = jax_resnet3d.Bottleneck3d(4, downsample=True, **kw)
    variables = jblock.init(jax.random.PRNGKey(0), nthwc(x), train=False)
    variables = {'params': perturb(variables['params'], 5),
                 'batch_stats': perturb(variables['batch_stats'], 6)}
    tblock = resnet3d.Bottleneck3d(8, 4, **kw)
    load_jax_variables(tblock, variables)
    tblock.train()
    want, _ = jblock.apply(variables, nthwc(x), train=True,
                           mutable=['batch_stats'])
    with torch.no_grad():
        got = tblock(t(x))
    np.testing.assert_allclose(got.numpy(), ncthw(want), rtol=1e-4,
                               atol=1e-4)


def test_slowonly_r50_geometry():
    """The r50 configs' backbone gives T = 4 at every stage (as
    tests/test_model_zoo.py holds the JAX one), and r2d_50 too."""
    cfg = {k: v for k, v in R50.items() if k != 'type'}
    with torch.no_grad():
        outs = BACKBONES.get('ResNet3dSlowOnly')(**cfg)(
            torch.zeros(1, 3, 8, 64, 64))
        flow = BACKBONES.get('resnet_flow.r2d_50')(in_channels=3)(
            torch.zeros(1, 3, 8, 64, 64))
    assert [o.shape[2] for o in outs] == [4, 4, 4, 4]
    assert [o.shape[1] for o in outs] == [256, 512, 1024, 2048]
    assert [o.shape[2] for o in flow] == [4, 4, 4, 4]
    assert [o.shape[1] for o in flow] == [32, 64, 128, 256]


@pytest.mark.parametrize('kwargs', [
    dict(non_local=(0, 1, 0, 0)), dict(lateral=True), dict(frozen_stages=0),
    dict(norm_eval=True), dict(with_cp=True), dict(return_stem=True),
    dict(style='caffe'), dict(inflate_style='3x3x3')])
def test_refuses_by_name(kwargs):
    """ResNet3d builds non-local blocks (tests/test_torch_recognizer2d.py
    holds them); the TwoR5 pathway, which the JAX module builds without
    them, refuses non_local."""
    name = next(iter(kwargs))
    cls = resnet3d.ResNet3dSlowOnly_TwoR5 if name == 'non_local' \
        else resnet3d.ResNet3d
    with pytest.raises(NotImplementedError, match=name):
        cls(depth=50, base_channels=4, **kwargs)
