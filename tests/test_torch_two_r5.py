"""ResNet3dSlowOnly_TwoR5 (a SlowOnly whose last stage runs twice with its
own weights) in mscl_torch against mscl_tpu, on the CPU: at depth 18,
narrow, every output (the earlier stage and the (global, local) pair), every
parameter gradient of a train-mode backward and the BN statistics it
leaves, and the eval-mode outputs, from the same converted weights (the
JAX ``layer4_{j}_local`` blocks as the port's ``layer4_local.{j}``); at
depth 50 the parameter shapes only (the depth-50 stage code is held by
tests/test_torch_resnet3d.py). The return structure is JAX's, so with the
default ``out_indices=(3,)`` the backbone gives the bare pair, which
BaseMoCo_TwoR5 refuses by name (JAX's neck would split the local feature
along its batch); with the last stage and another the MoCo tower trains.
Tolerances: outputs and BN statistics 1e-4, gradients rtol 5e-3 / atol
1e-4 (tests/test_torch_resnet3d.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscl_tpu.models import BACKBONES as JAX_BACKBONES
from mscl_torch.apis import build_model_from_cfg
from mscl_torch.convert import jax_to_state_dict, load_jax_variables
from mscl_torch.models import BACKBONES, NECKS

from _torch_data_util import one_torch_thread  # noqa: F401
from _torch_port_util import ncthw, nthwc, perturb, t, xla3d_conv  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')
NARROW = dict(depth=18, base_channels=4, stage_blocks=(1, 1, 1, 2),
              out_indices=(1, 3))
OUT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=5e-3, atol=1e-4)


def _flat(out):
    """The backbone's output as a flat list, the pair unpacked."""
    flat = []
    for o in (out if isinstance(out, tuple) and isinstance(out[-1], tuple)
              else (out,)):
        flat.extend(o if isinstance(o, tuple) else (o,))
    return flat


@pytest.fixture(scope='module')
def case(xla3d_conv):
    jmodel = JAX_BACKBONES.get('ResNet3dSlowOnly_TwoR5')(**NARROW)
    tmodel = BACKBONES.build(dict(NARROW, type='ResNet3dSlowOnly_TwoR5'))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 4, 32, 32)).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), nthwc(x), train=False)
    variables = {'params': perturb(variables['params'], 2),
                 'batch_stats': perturb(variables['batch_stats'], 3)}
    load_jax_variables(tmodel, variables)
    return jmodel, tmodel, variables, x, rng


def test_structure_and_names(case):
    jmodel, tmodel, variables, x, _ = case
    jout = jmodel.apply(variables, nthwc(x), train=False)
    assert isinstance(jout, tuple) and len(jout) == 2
    assert isinstance(jout[1], tuple) and len(jout[1]) == 2
    tmodel.eval()
    with torch.no_grad():
        out = tmodel(t(x))
    assert isinstance(out, tuple) and isinstance(out[1], tuple)
    names = set(tmodel.state_dict())
    assert {'layer4_local.0.conv1.conv.weight',
            'layer4_local.1.conv2.bn.running_var'} <= names
    assert sorted(names) == sorted(jax_to_state_dict(variables))


def test_eval_outputs_match(case):
    jmodel, tmodel, variables, x, _ = case
    want = _flat(jmodel.apply(variables, nthwc(x), train=False))
    tmodel.eval()
    with torch.no_grad():
        got = _flat(tmodel(t(x)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), ncthw(w), **OUT_TOL)
    # the two last stages have their own weights
    assert not np.allclose(got[1].numpy(), got[2].numpy())


def test_train_outputs_grads_and_bn_stats_match(case):
    jmodel, tmodel, variables, x, rng = case
    outs = _flat(jmodel.apply(variables, nthwc(x), train=False))
    weights = [(rng.normal(size=ncthw(o).shape) / np.sqrt(o.size))
               .astype(np.float32) for o in outs]

    def loss(params):
        out, new = jmodel.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            nthwc(x), train=True, mutable=['batch_stats'])
        out = _flat(out)
        return sum(jnp.sum(o * nthwc(w)) for o, w in zip(out, weights)), \
            (out, new)
    (_, (jouts, new)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables['params'])
    tmodel.train()
    tmodel.zero_grad()
    touts = _flat(tmodel(t(x)))
    sum((o * t(w)).sum() for o, w in zip(touts, weights)).backward()
    for g, w in zip(touts, jouts):
        np.testing.assert_allclose(g.detach().numpy(), ncthw(w), **OUT_TOL)
    jgrads = jax_to_state_dict({'params': grads})
    tgrads = {k: p.grad.numpy() for k, p in tmodel.named_parameters()}
    assert sorted(tgrads) == sorted(jgrads)
    for k in jgrads:
        np.testing.assert_allclose(tgrads[k], jgrads[k], err_msg=k,
                                   **GRAD_TOL)
    stats = jax_to_state_dict({'batch_stats': new['batch_stats']})
    got = tmodel.state_dict()
    assert any('_local' in k for k in stats)
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), stats[k], err_msg=k,
                                   **OUT_TOL)


def test_depth50_parameter_shapes_match():
    cfg = dict(depth=50, out_indices=(2, 3))
    jmodel = JAX_BACKBONES.get('ResNet3dSlowOnly_TwoR5')(**cfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 4, 32, 32, 3)), train=False))
    want = {k: v.shape for k, v in jax_to_state_dict(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), dict(shapes))).items()}
    with torch.device('meta'):
        tmodel = BACKBONES.build(dict(cfg, type='ResNet3dSlowOnly_TwoR5'))
    got = {k: tuple(v.shape) for k, v in tmodel.state_dict().items()}
    assert got == want
    assert got['layer4_local.2.conv3.conv.weight'] == (2048, 512, 1, 1, 1)


def test_the_neck_refuses_what_is_not_a_pair():
    """The default out_indices=(3,) gives the bare (global, local) pair:
    JAX's neck would unpack the local feature along its batch; the port's
    refuses it by name, and takes the last stage with another."""
    neck = NECKS.build(dict(type='BaseMoCo_TwoR5'))
    backbone = BACKBONES.build(dict(NARROW, type='ResNet3dSlowOnly_TwoR5',
                                    out_indices=(3,)))
    x = torch.zeros(2, 3, 4, 32, 32)
    out = backbone(x)
    assert isinstance(out, tuple) and len(out) == 2
    with pytest.raises(ValueError, match='BaseMoCo_TwoR5'):
        neck(out)
    with pytest.raises(ValueError, match='ResNet3dSlowOnly_TwoR5'):
        neck([torch.zeros(2, 8, 1, 8, 8)])
    emb, feats = neck(BACKBONES.build(dict(
        NARROW, type='ResNet3dSlowOnly_TwoR5'))(x))
    assert emb.shape == (2, 32) and len(feats) == 2


def test_a_moco_tower_trains_on_the_pair():
    """A MoCo tower on ResNet3dSlowOnly_TwoR5 and BaseMoCo_TwoR5 takes a
    train step (the key side through the same neck); its InfoNCE reads the
    embedding of the global stage, the local one feeds the level list."""
    model = build_model_from_cfg(dict(
        type='MoCo', backbone=dict(NARROW, type='ResNet3dSlowOnly_TwoR5'),
        neck=dict(type='BaseMoCo_TwoR5'), dim_in=32, K=16, dim=8,
        moco_head=dict(type='MoCoHead'), aug=dict(type='IdentityAug')),
        device='cpu')
    rng = np.random.default_rng(0)
    batch = {'imgs': [t(rng.uniform(size=(2, 3, 4, 32, 32)).astype(
        np.float32)) for _ in range(2)]}
    loss, log_vars = model.train_step(batch)
    loss.backward()
    assert torch.isfinite(loss) and 'loss_cls' in log_vars
    assert model.encoder_q.layer4[0].conv1.conv.weight.grad is not None
