"""The external-name 2D backbones of mscl_torch (ResNeXt, DenseNet, Swin)
against mscl_tpu's ``extern_2d.py``, on the CPU, and TSMHead3D in
Recognizer2D.

- The Swin helpers ``_rel_position_index`` and ``_shift_attn_mask``
  bitwise.
- The blocks (BottleneckX, DenseLayer, SwinBlock shifted and not at a map
  the window does not divide, PatchMerging at odd sizes) and the whole
  backbones narrowed (ResNeXt with ``ARCH_NEXT`` cut to one block a stage
  in both packages, DenseNet with a short ``block_config`` and a small
  growth, Swin with a small ``embed_dim`` and ``depths`` at a size that
  pads), in train mode from the same perturbed weights carried across by
  ``mscl_torch.convert``: every output and BN statistic within 1e-4,
  every gradient (the parameters' and the input's) within rtol 5e-3 /
  atol 1e-4, of sum <out, w> / sqrt(size), w normal from a seed. ResNeXt
  runs in float64 on both sides (JAX with x64 and flax's BatchNorm): its
  train-mode BN over the 1x1 maps of layer4 is too ill-conditioned in
  float32 for the gradient tolerance.
- Two ``train_model`` steps of each ``custom_backbones`` recipe, narrowed,
  in both packages (``_torch_recognition_util.check``).
- TSMHead3D as Recognizer2D's head: a train step (losses, gradients, BN
  statistics) and forward_test, with one and two classifiers.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mscl_tpu.models import BACKBONES as JAX_BACKBONES
from mscl_tpu.models import RECOGNIZERS as JAX_RECOGNIZERS
from mscl_tpu.models.backbones import extern_2d as jax_extern
from mscl_torch.convert import jax_to_state_dict, load_jax_variables
from mscl_torch.models import BACKBONES, RECOGNIZERS
from mscl_torch.models.backbones import extern_2d

from _torch_data_util import one_torch_thread  # noqa: F401
from _torch_port_util import perturb, t, xla3d_conv  # noqa: F401
from _torch_recognition_util import (ONE_BASIC, ONE_NEXT, check, cut_tables,
                                     port_to_jax, sets)  # noqa: F401
from _torch_step_util import jax_float64

pytestmark = pytest.mark.usefixtures('one_torch_thread', 'xla3d_conv')
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=5e-3, atol=1e-4)


def nhwc(x):
    return np.transpose(np.asarray(x), (0, 2, 3, 1))


def nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def same(x):
    return np.asarray(x)


def _hold(jfactory, tmodel, x, to_jax=nhwc, to_port=nchw, x64=False,
          train_kw=True, seed=1):
    """``jfactory(dtype)`` the JAX module, ``tmodel`` the port's, ``x`` the
    port's input; the port's init carried into JAX's tree (traced, not
    run), perturbed, loaded back; then one train-mode pass and backward in
    each (float64 on both sides with ``x64``): outputs, every parameter's
    and the input's gradient, the BN statistics."""
    jkw = dict(train=True) if train_kw else {}
    jmodel = jfactory(jnp.float32)
    if hasattr(tmodel, 'init_weights'):
        tmodel.init_weights(torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(lambda r, v: jmodel.init(r, v, **jkw),
                            jax.random.PRNGKey(0), to_jax(x))
    variables = port_to_jax(shapes, {k: v.numpy() for k, v in
                                     tmodel.state_dict().items()},
                            jnp.float32)
    variables = {'params': perturb(variables['params'], seed + 1),
                 'batch_stats': perturb(variables.get('batch_stats', {}),
                                        seed + 2)}
    load_jax_variables(tmodel, {k: v for k, v in variables.items() if v})
    rng = np.random.default_rng(seed)
    out_shape = jax.eval_shape(lambda v, xx: jmodel.apply(
        v, xx, **jkw, mutable=['batch_stats'])[0], variables, to_jax(x))
    w = rng.normal(size=to_port(np.empty(out_shape.shape, bool)).shape) / \
        np.sqrt(np.prod(out_shape.shape))
    dt, tdt = (np.float64, torch.float64) if x64 else \
        (np.float32, torch.float32)
    with jax_float64() if x64 else contextlib.nullcontext():
        jm = jfactory(jnp.float64 if x64 else jnp.float32)
        cast = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, dt)),
                            variables)

        def loss(params, xx):
            out, new = jm.apply({'params': params,
                                 'batch_stats': cast['batch_stats']}, xx,
                                **jkw, mutable=['batch_stats'])
            return jnp.sum(out * jnp.asarray(to_jax(w).astype(dt))), \
                (out, new)
        (_, (jout, jnew)), (jgp, jgx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(
            cast['params'], jnp.asarray(to_jax(x).astype(dt)))
    tmodel = tmodel.to(tdt).train()
    tx = t(x.astype(dt)).requires_grad_()
    out = tmodel(tx)
    (out * t(w.astype(dt))).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), to_port(jout),
                               err_msg='output', **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), to_port(jgx),
                               err_msg='input gradient', **GRAD_TOL)
    want = jax_to_state_dict({'params': jgp})
    got = {k: p.grad.numpy() for k, p in tmodel.named_parameters()}
    assert sorted(got) == sorted(want), set(got) ^ set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)
    want = jax_to_state_dict({'batch_stats': jnew.get('batch_stats', {})})
    got = {k: v.numpy() for k, v in tmodel.state_dict().items()
           if 'running' in k}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_swin_helpers_bitwise():
    for ws in range(1, 8):
        np.testing.assert_array_equal(extern_2d._rel_position_index(ws),
                                      jax_extern._rel_position_index(ws))
    for hp, wp, ws, shift in ((14, 14, 7, 3), (12, 8, 4, 2), (6, 9, 3, 1)):
        got = extern_2d._shift_attn_mask(hp, wp, ws, shift)
        want = jax_extern._shift_attn_mask(hp, wp, ws, shift)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


BLOCKS = {
    # name -> (JAX factory of dtype, the port's module, port input shape,
    #          its layout: 'nchw' or channels-last tokens, train kwarg)
    'bottleneck_x': (
        lambda dt: jax_extern.BottleneckX(16, 2, True, groups=8, dtype=dt),
        lambda: extern_2d.BottleneckX(32, 16, 2, True, groups=8),
        (2, 32, 9, 9), 'nchw', True),
    'dense_layer': (
        lambda dt: jax_extern.DenseLayer(8, bn_size=2, dtype=dt),
        lambda: extern_2d.DenseLayer(12, 8, bn_size=2),
        (4, 12, 6, 6), 'nchw', True),
    'swin_shifted_padded': (
        lambda dt: jax_extern.SwinBlock(2, window=4, shift=True, dtype=dt),
        lambda: extern_2d.SwinBlock(16, 2, 4, True, input_hw=(9, 10)),
        (2, 9, 10, 16), 'tokens', True),
    'swin_plain_padded': (
        lambda dt: jax_extern.SwinBlock(2, window=4, dtype=dt),
        lambda: extern_2d.SwinBlock(16, 2, 4, False, input_hw=(9, 10)),
        (2, 9, 10, 16), 'tokens', True),
    'swin_one_window': (
        lambda dt: jax_extern.SwinBlock(2, window=7, shift=True, dtype=dt),
        lambda: extern_2d.SwinBlock(16, 2, 7, True, input_hw=(5, 6)),
        (2, 5, 6, 16), 'tokens', True),
    'patch_merging_odd': (
        lambda dt: jax_extern.PatchMerging(dtype=dt),
        lambda: extern_2d.PatchMerging(8), (2, 5, 7, 8), 'tokens', False),
}


@pytest.mark.parametrize('name', sorted(BLOCKS))
def test_block_matches(name):
    jfactory, tfactory, shape, layout, train_kw = BLOCKS[name]
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    kw = {} if layout == 'nchw' else dict(to_jax=same, to_port=same)
    _hold(jfactory, tfactory(), x, train_kw=train_kw, **kw)


BACKBONE_CASES = {
    # name -> (config, float64, input shape as the port takes it; the
    #          port's extra arguments)
    'resnext_one_block': (dict(type='mmcls.ResNeXt', depth=ONE_NEXT,
                               out_indices=(3,), groups=32,
                               width_per_group=4, style='pytorch'),
                          True, (4, 3, 32, 32), {}),
    'densenet_short': (dict(type='torchvision.densenet161',
                            num_init_features=16, growth_rate=8,
                            block_config=(2, 2, 1), bn_size=2),
                       False, (4, 3, 32, 32), {}),
    'swin_small_padded': (dict(type='timm.swin_base_patch4_window7_224',
                               embed_dim=16, depths=(2, 2, 1),
                               num_heads=(1, 2, 2)),
                          False, (2, 3, 44, 44), dict(img_size=44)),
}


@pytest.mark.parametrize('name', sorted(BACKBONE_CASES))
def test_backbone_matches(name):
    cfg, x64, shape, port_kw = BACKBONE_CASES[name]
    cfg = dict(cfg)
    typ = cfg.pop('type')
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    with cut_tables():
        tmodel = BACKBONES.get(typ)(**cfg, **port_kw)
        _hold(lambda dt: JAX_BACKBONES.get(typ)(dtype=dt, **cfg), tmodel, x,
              x64=x64, seed=5)


def test_external_names_are_the_classes():
    for name, cls in (('mmcls.ResNeXt', extern_2d.ResNeXt),
                      ('ResNeXt', extern_2d.ResNeXt),
                      ('torchvision.densenet161', extern_2d.DenseNet),
                      ('DenseNet', extern_2d.DenseNet),
                      ('timm.swin_base_patch4_window7_224',
                       extern_2d.SwinTransformer),
                      ('SwinTransformer', extern_2d.SwinTransformer)):
        assert BACKBONES.get(name) is cls, name


def test_full_width_shapes_match_jax():
    """The three configs' own backbones, built on the meta device: every
    parameter and statistic has JAX's shape (at 224x224, traced), and the
    outputs are (N, 2048 | 2208 | 1024, 7, 7)."""
    x = jnp.zeros((1, 224, 224, 3))
    for typ, cfg, channels in (
            ('mmcls.ResNeXt', dict(depth=101, groups=32, width_per_group=4),
             2048), ('torchvision.densenet161', {}, 2208),
            ('timm.swin_base_patch4_window7_224', {}, 1024)):
        jm = JAX_BACKBONES.get(typ)(**cfg)
        shapes = jax.eval_shape(lambda r: jm.init(r, x), jax.random.PRNGKey(0))
        out = jax.eval_shape(lambda v: jm.apply(v, x), shapes)
        want = {k: v.shape for k, v in jax_to_state_dict(
            jax.tree.map(lambda s: np.empty(s.shape, np.float32),
                         shapes)).items()}
        with torch.device('meta'):
            tm = BACKBONES.get(typ)(**cfg)
            got = tm(torch.empty(1, 3, 224, 224))
        assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == \
            {k: tuple(v) for k, v in want.items()}, typ
        assert tuple(got.shape) == (1, channels, 7, 7) == \
            tuple(nchw(np.empty(out.shape, bool)).shape), typ


def test_swin_refuses_a_map_of_another_window():
    block = extern_2d.SwinBlock(16, 2, 7, input_hw=(56, 56))
    with pytest.raises(ValueError, match='window of 7'):
        block(torch.zeros(1, 5, 5, 16))


RECIPES = ('tsn_dense161_1x1x3_100e_kinetics400_rgb.py',
           'tsn_rn101_32x4d_1x1x3_100e_kinetics400_rgb.py',
           'tsn_swin_base_1x1x3_100e_kinetics400_rgb.py')


@pytest.mark.parametrize('name', RECIPES)
def test_custom_backbone_recipe_trains(name, sets, tmp_path):
    """Two train_model steps of the recipe narrowed, validation after
    them, in the port and in mscl_tpu (float64 for ResNeXt's depth)."""
    root, ann = sets['rgb']
    check('recognition/tsn/custom_backbones/' + name, root, ann,
          str(tmp_path), True, x64='rn101' in name)


@pytest.mark.parametrize('num_clfs', [1, 2])
@pytest.mark.parametrize('mode', ['train', 'test'])
def test_tsm_head3d_in_recognizer2d(num_clfs, mode):
    """Recognizer2D's generic head path with TSMHead3D, which splits the
    segments over its own classifiers: a train step's losses, gradients
    and BN statistics, or forward_test's scores, against JAX's."""
    segs = 4
    cfg = dict(type='Recognizer2D',
               backbone=dict(type='ResNetTSM', depth=ONE_BASIC,
                             num_segments=segs),
               cls_head=dict(type='TSMHead3D', num_classes=5,
                             in_channels=512, num_segments=segs,
                             num_clfs=num_clfs, dropout_ratio=0.0),
               test_cfg=dict(average_clips='prob'))
    rng = np.random.default_rng(7 + num_clfs)
    batch = dict(imgs=rng.normal(size=(2, segs, 3, 32, 32)).astype(
        np.float32), label=np.array([1, 4]))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jcfg, tcfg = dict(cfg), dict(cfg)
    jmodel = JAX_RECOGNIZERS.get(jcfg.pop('type'))(**jcfg)
    with cut_tables():
        model = RECOGNIZERS.get(tcfg.pop('type'))(**tcfg)
        model.init_weights(torch.Generator().manual_seed(0))
        shapes = jax.eval_shape(lambda r: jmodel.init(
            r, jbatch['imgs'], jbatch['label']), jax.random.PRNGKey(0))
        variables = port_to_jax(shapes, {k: v.numpy() for k, v in
                                         model.state_dict().items()},
                                jnp.float32)
        variables = {'params': perturb(variables['params'], 12),
                     'batch_stats': perturb(variables['batch_stats'], 13)}
        if mode == 'test':
            want = jax.jit(lambda v, x: jmodel.apply(
                v, x, method='forward_test'))(variables, jbatch['imgs'])
        else:
            def loss(params):
                (total, log_vars), new = jmodel.apply(
                    dict(variables, params=params), jbatch,
                    method='train_step', mutable=['batch_stats'])
                return total, (log_vars, new)
            (_, (jlog, new)), jgrads = jax.jit(jax.value_and_grad(
                loss, has_aux=True))(variables['params'])
    load_jax_variables(model, variables)
    if mode == 'test':
        model.eval()
        with torch.no_grad():
            got = model.forward_test(t(batch['imgs']))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    model.train()
    total, log_vars = model.train_step({k: t(v) for k, v in batch.items()})
    total.backward()
    assert sorted(log_vars) == sorted(jlog)
    for k, v in jlog.items():
        np.testing.assert_allclose(log_vars[k].detach().numpy(),
                                   np.asarray(v), err_msg=k, rtol=2e-4,
                                   atol=2e-4)
    params = dict(model.named_parameters())
    for k, v in jax_to_state_dict({'params': jgrads}).items():
        np.testing.assert_allclose(params[k].grad.numpy(), v, err_msg=k,
                                   **GRAD_TOL)
    state = model.state_dict()
    for k, v in jax_to_state_dict({'batch_stats': new['batch_stats']}
                                  ).items():
        np.testing.assert_allclose(state[k].numpy(), v, err_msg=k, **TOL)
