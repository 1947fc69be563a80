"""mscl_torch's video ResNets against mscl_tpu's, on the CPU: per-stage
outputs in train and eval mode, and the BN running statistics after one
train-mode forward (the JAX rule: momentum 0.9, biased batch variance)."""
import jax
import numpy as np
import pytest
import torch

from mscl_tpu.models import BACKBONES as JAX_BACKBONES
from mscl_torch.convert import jax_to_state_dict, load_jax_variables
from mscl_torch.models import BACKBONES

from _torch_port_util import ncthw, nthwc, perturb, t, xla3d_conv  # noqa: F401

# name -> (input channels, base width); layers (1, 1, 1, 1)
CASES = {'torchvision.r3d_18': (3, 8), 'resnet_flow.r2d_18': (2, 4)}


def _pair(name):
    cin, width = CASES[name]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, cin, 8, 32, 32)).astype(np.float32)
    jmodel = JAX_BACKBONES.get(name)(layers=(1, 1, 1, 1), base_width=width)
    variables = jmodel.init(jax.random.PRNGKey(0), nthwc(x), train=False)
    variables = {'params': perturb(variables['params'], 2),
                 'batch_stats': perturb(variables['batch_stats'], 3)}
    tmodel = BACKBONES.get(name)(layers=(1, 1, 1, 1), base_width=width,
                                 in_channels=cin)
    load_jax_variables(tmodel, variables)
    return jmodel, variables, tmodel, x


@pytest.mark.parametrize('train', [True, False])
@pytest.mark.parametrize('name', sorted(CASES))
def test_stage_outputs_match(xla3d_conv, name, train):
    jmodel, variables, tmodel, x = _pair(name)
    if train:
        want, _ = jmodel.apply(variables, nthwc(x), train=True,
                               mutable=['batch_stats'])
    else:
        want = jmodel.apply(variables, nthwc(x), train=False)
    tmodel.train(train)
    with torch.no_grad():
        got = tmodel(t(x))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), ncthw(w), rtol=1e-4, atol=1e-4,
                                   err_msg=f'{name} stage {i + 1}')


@pytest.mark.parametrize('name', sorted(CASES))
def test_bn_running_stats_match(xla3d_conv, name):
    jmodel, variables, tmodel, x = _pair(name)
    _, new_vars = jmodel.apply(variables, nthwc(x), train=True,
                               mutable=['batch_stats'])
    want = jax_to_state_dict({'batch_stats': new_vars['batch_stats']})
    before = jax_to_state_dict({'batch_stats': variables['batch_stats']})
    tmodel.train()
    with torch.no_grad():
        tmodel(t(x))
    got = tmodel.state_dict()
    assert len(want) == 2 * sum(1 for k in got if k.endswith('running_mean'))
    for key, w in want.items():
        assert not np.allclose(w, before[key]), key
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def test_bn_variance_is_biased():
    """The running variance takes the biased batch variance with weight
    0.1, which nn.BatchNorm3d does not."""
    from mscl_torch.ops import BatchNorm3d
    bn = BatchNorm3d(3)
    x = torch.randn(2, 3, 2, 3, 3)
    bn.train()
    bn(x)
    var = x.var(dim=(0, 2, 3, 4), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean(dim=(0, 2, 3, 4)))


# the other registrations of video_resnet.py: name -> (input channels,
# base width); layers (1, 1, 1, 1)
ZOO = {'torchvision.mc3_18': (3, 8), 'resnet_flow.r2dv2_18': (2, 4),
       'resnet_flow.r2dv3_18': (2, 4), 'resnet_flow.mx2d_18': (2, 4),
       'resnet_flow.r3d_18': (2, 4), 'resnet_flow.r3dv2_18': (2, 4),
       'resnet_flow.mc3_18': (2, 4)}


@pytest.mark.parametrize('name', sorted(ZOO))
def test_registered_video_resnets_match(xla3d_conv, name):
    """Each registration (the flow_2d and flow_2d_v2 stems, the
    no_downsample and mixed conv makers): train-mode stage outputs, every
    parameter gradient of sum_i <out_i, w_i>, and the BN statistics."""
    cin, width = ZOO[name]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, cin, 8, 32, 32)).astype(np.float32)
    jmodel = JAX_BACKBONES.get(name)(layers=(1, 1, 1, 1), base_width=width)
    variables = jmodel.init(jax.random.PRNGKey(0), nthwc(x), train=False)
    variables = {'params': perturb(variables['params'], 2),
                 'batch_stats': perturb(variables['batch_stats'], 3)}
    tmodel = BACKBONES.get(name)(layers=(1, 1, 1, 1), base_width=width,
                                 in_channels=cin)
    load_jax_variables(tmodel, variables)
    shapes = [ncthw(o).shape for o in jmodel.apply(variables, nthwc(x))]
    weights = [(rng.normal(size=s) / np.sqrt(np.prod(s))).astype(np.float32)
               for s in shapes]

    def loss(params):
        out, new = jmodel.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            nthwc(x), train=True, mutable=['batch_stats'])
        return sum(jax.numpy.sum(o * nthwc(w))
                   for o, w in zip(out, weights)), (out, new)

    (_, (want, new)), jgrads = jax.value_and_grad(loss, has_aux=True)(
        variables['params'])
    tmodel.train()
    got = tmodel(t(x))
    sum((o * t(w)).sum() for o, w in zip(got, weights)).backward()
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.detach().numpy(), ncthw(w), rtol=1e-4,
                                   atol=1e-4, err_msg=f'{name} stage {i + 1}')
    grads = jax_to_state_dict({'params': jgrads})
    assert sorted(grads) == sorted(n for n, _ in tmodel.named_parameters())
    for k, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[k], rtol=5e-3,
                                   atol=1e-4, err_msg=f'{name} {k}')
    stats = tmodel.state_dict()
    for k, w in jax_to_state_dict({'batch_stats': new['batch_stats']}).items():
        np.testing.assert_allclose(stats[k].numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=f'{name} {k}')
