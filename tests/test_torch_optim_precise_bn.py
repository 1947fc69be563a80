"""The optimizers, PreciseBN and the samplers of mscl_torch against
mscl_tpu's, on the CPU.

- ``convert.jax_param_paths``: every parameter's JAX path, as JAX's own
  params tree names it, for the recognizers whose names the converter
  maps (2D ResNets with non-local blocks, VideoResNet's stem, ResNet3d's
  bare ``conv2_conv``, CSN, TimeSformer's raw parameters, Swin's bias
  tables, the flagship's towers and heads); the TSM constructor's group of
  each, as JAX's ``_tsm_label`` gives it.
- ``train_model`` of the narrowed TSN recipe over 2 epochs of 2 steps in
  both packages (JAX in float64, ``_torch_recognition_util.check``: losses
  2e-4, each tensor's change 5e-3) with Adam, AdamW with
  ``paramwise_cfg.custom_keys`` (decay_mult 0 on the norms), PreciseBN and
  the class-balanced sampler (the card's derived run), SGD with custom
  keys, and the TSM constructor with ``fc_lr5``. The Adam runs hold the
  port in float64 too (``port64``): Adam moves each element by about the
  rate whatever its gradient's size, so a BN bias whose gradient is a
  near-cancelling sum (layer2's in the narrowed ResNet) moves by the sign
  of float32's one-pass BN statistics' error, 13x what one ulp on the
  input moves it. The derived run resumed from its first epoch ends
  bitwise where it ended.
- PreciseBN alone: the running statistics after ``num_iters`` forwards
  (wrapping round the loader) within 1e-4 of JAX's, and nothing else
  moved.
- The class-balanced and PK orders bitwise, epoch by epoch, and the port's
  loader yielding its order.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import tree_flatten_with_path

from mscl_tpu.core import optimizer as jax_optimizer
from mscl_tpu.core.precise_bn import precise_bn_update as jax_precise_bn
from mscl_tpu.core.train_loop import TrainState
from mscl_tpu.datasets.loader import NumpyLoader as JaxLoader
from mscl_tpu.models import RECOGNIZERS as JAX_RECOGNIZERS
from mscl_tpu.parallel.mesh import create_mesh
from mscl_torch.apis import narrow_flagship_cfg, train_model
from mscl_torch.config import Config
from mscl_torch.convert import jax_param_paths, jax_to_state_dict
from mscl_torch.core import load_checkpoint, to_torch
from mscl_torch.core.optimizer import tsm_groups
from mscl_torch.core.precise_bn import precise_bn_update
from mscl_torch.datasets.loader import NumpyLoader
from mscl_torch.models import RECOGNIZERS

from _torch_data_util import one_torch_thread  # noqa: F401
from _torch_port_util import perturb, t, xla3d_conv  # noqa: F401
from _torch_recognition_util import (ONE_BASIC, ONE_BOTTLENECK, check,
                                     cut_tables, narrow_cfg, port_to_jax,
                                     sets)  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread', 'xla3d_conv')
TSN = 'recognition/tsn/tsn_r50_1x1x3_100e_kinetics400_rgb.py'
SEGS, HW = 3, 32

MODELS = {
    # name -> (model config, the JAX init's batch: imgs shape)
    'tsm_nonlocal': (dict(
        type='Recognizer2D',
        backbone=dict(type='ResNetTSM', depth=ONE_BOTTLENECK,
                      num_segments=4, non_local=(0, (1,), 0, 0),
                      non_local_cfg=dict(sub_sample=True)),
        cls_head=dict(type='TSMHead', num_classes=5, in_channels=2048,
                      num_segments=4)), (2, 4, 3, HW, HW)),
    'r3d_stem': (dict(
        type='Recognizer3D',
        backbone=dict(type='torchvision.r3d_18', base_width=8),
        cls_head=dict(type='I3DHead', num_classes=5, in_channels=64)),
        (2, 1, 3, 4, HW, HW)),
    'i3d_bottleneck': (dict(
        type='Recognizer3D',
        backbone=dict(type='ResNet3d', depth=50, base_channels=8,
                      stage_blocks=(1, 1, 1, 1)),
        cls_head=dict(type='I3DHead', num_classes=5, in_channels=256)),
        (2, 1, 3, 4, HW, HW)),
    'ircsn': (dict(
        type='Recognizer3D',
        backbone=dict(type='ResNet3dCSN', depth=50, base_channels=8,
                      stage_blocks=(1, 1, 1, 1), bottleneck_mode='ir'),
        cls_head=dict(type='I3DHead', num_classes=5, in_channels=256)),
        (2, 1, 3, 4, HW, HW)),
    'timesformer': (dict(
        type='Recognizer3D',
        backbone=dict(type='TimeSformer', num_frames=4, img_size=HW,
                      embed_dims=16, num_heads=2, num_transformer_layers=1),
        cls_head=dict(type='TimeSformerHead', num_classes=5,
                      in_channels=16)), (2, 1, 3, 4, HW, HW)),
    'swin': (dict(
        type='Recognizer2D',
        backbone=dict(type='timm.swin_base_patch4_window7_224',
                      embed_dim=8, depths=(2, 1), num_heads=(1, 2)),
        cls_head=dict(type='TSNHead', num_classes=5, in_channels=16)),
        (2, SEGS, 3, HW, HW)),
}


def _paths_by_name(params):
    """Each JAX parameter's '/'-joined path (a params tree of shapes),
    keyed by the port's name (``jax_to_state_dict`` of a tree of the
    paths' indices)."""
    leaves, _ = tree_flatten_with_path(params)
    paths = [jax_optimizer._path_str(p) for p, _ in leaves]
    index = jax.tree.unflatten(jax.tree.structure(params), [
        np.full(leaf.shape, i, np.float64) for i, (_, leaf) in
        enumerate(leaves)])
    return {k: paths[int(v.ravel()[0])] for k, v in
            jax_to_state_dict({'params': index}).items()}


def _jax_paths(jmodel, imgs):
    shapes = jax.eval_shape(lambda r: jmodel.init(
        {'params': r, 'dropout': r, 'moco': r}, imgs,
        jnp.zeros(imgs.shape[0], jnp.int32)), jax.random.PRNGKey(0))
    return _paths_by_name(shapes['params'])


@pytest.mark.parametrize('name', sorted(MODELS))
def test_jax_param_paths_match_jax(name):
    cfg, shape = MODELS[name]
    jcfg, tcfg = dict(cfg), dict(cfg)
    if name == 'swin':        # the port sizes its bias tables when built
        tcfg['backbone'] = dict(tcfg['backbone'], img_size=HW)
    with cut_tables():
        jmodel = JAX_RECOGNIZERS.get(jcfg.pop('type'))(**jcfg)
        with torch.device('meta'):
            model = RECOGNIZERS.get(tcfg.pop('type'))(**tcfg)
        want = _jax_paths(jmodel, jnp.zeros(shape))
    got = jax_param_paths(model)
    assert got == want
    for fc_lr5 in (False, True):
        assert tsm_groups(model, fc_lr5) == {
            k: jax_optimizer._tsm_label(p, fc_lr5) for k, p in want.items()}


def test_jax_param_paths_of_the_flagship():
    """MSCLWithAug's towers, necks and heads (``recognizer_m``,
    ``recognizer_flow_m``, ``sup_head_m`` ...), narrowed."""
    import mscl_tpu.apis.train as jax_train
    cfg = narrow_flagship_cfg(K=16, dim=16, rgb_width=4, flow_width=2,
                              num_frames=4)
    with torch.device('meta'):
        c = dict(cfg)
        model = RECOGNIZERS.get(c.pop('type'))(**c)
    batch = {'imgs': [np.zeros((2, 3, 4, 16, 16), np.float32)] * 2,
             'flow_imgs': [np.zeros((2, 2, 8, 16, 16), np.float32)] * 2}
    shapes = jax.eval_shape(
        lambda: jax_train.build_model_from_cfg(cfg).init(
            {k: jax.random.PRNGKey(0) for k in ('params', 'dropout', 'moco')},
            batch, method='train_step'))
    assert jax_param_paths(model) == _paths_by_name(shapes['params'])


def _derived(cfg):
    """The card's derived TSN run: AdamW, no decay on the norms, PreciseBN
    every epoch, class-balanced sampling."""
    cfg['optimizer'] = dict(type='AdamW', lr=1e-3, weight_decay=1e-2,
                            paramwise_cfg=dict(custom_keys=dict(
                                bn=dict(decay_mult=0.0))))
    cfg['precise_bn'] = dict(num_iters=3, interval=1)
    cfg['data']['train']['sample_by_class'] = True


OPTIMIZERS = {
    'adam': lambda cfg: cfg.update(optimizer=dict(
        type='Adam', lr=1e-3, weight_decay=1e-4)),
    'adamw_custom_keys_precise_bn_by_class': _derived,
    'sgd_custom_keys': lambda cfg: cfg.update(optimizer=dict(
        type='SGD', lr=0.01, momentum=0.9, weight_decay=1e-4,
        paramwise_cfg=dict(custom_keys={'layer4': dict(lr_mult=0.1),
                                        'fc_cls': dict(decay_mult=0.0)}))),
    'tsm_constructor': lambda cfg: cfg.update(optimizer=dict(
        type='SGD', lr=0.01, momentum=0.9, weight_decay=1e-4,
        constructor='TSMOptimizerConstructor',
        paramwise_cfg=dict(fc_lr5=True))),
}


@pytest.mark.parametrize('name', sorted(OPTIMIZERS))
def test_train_model_optimizer_matches_jax(name, sets, tmp_path):
    root, ann = sets['rgb']
    runner = check(TSN, root, ann, str(tmp_path), False, x64=True,
                   port64='adam' in name, update=OPTIMIZERS[name], epochs=2)
    assert runner.optimizer.kind == ('adam' if 'adam' in name else 'sgd')


def test_adamw_resume_is_bitwise(sets, tmp_path, monkeypatch):
    """The derived run (AdamW with custom keys, PreciseBN, class-balanced
    sampling) for 2 epochs, and again resumed from its first epoch's
    checkpoint: the second epoch's checkpoints equal bitwise, Adam's
    moments and counts too. The host crops' global generators are seeded
    by the epoch, as tests/test_torch_runner.py's exact resume seeds them
    (a checkpoint holds the model's and optimizer's state, not the
    decoders')."""
    real = NumpyLoader.set_epoch

    def set_epoch(self, epoch):
        random.seed(epoch)
        np.random.seed(epoch)
        real(self, epoch)
    monkeypatch.setattr(NumpyLoader, 'set_epoch', set_epoch)
    root, ann = sets['rgb']
    ends = []
    for name, resume in (('whole', None), ('resumed', 'whole')):
        cfg = narrow_cfg(TSN, root, ann, str(tmp_path / name), False,
                         update=_derived, epochs=2)
        with cut_tables():
            train_model(Config.fromdict(cfg), validate=False, seed=0,
                        device='cpu', resume_from=resume and str(
                            tmp_path / resume / 'epoch_1.pth'))
        ends.append(load_checkpoint(str(tmp_path / name / 'epoch_2.pth')))
    a, b = ends
    assert sorted(a['state_dict']) == sorted(b['state_dict'])
    for k, v in a['state_dict'].items():
        assert torch.equal(v, b['state_dict'][k]), k
    assert a['optimizer']['steps'] == b['optimizer']['steps'] == 4
    sa, sb = a['optimizer']['adam']['state'], b['optimizer']['adam']['state']
    assert sorted(sa) == sorted(sb) and sa
    for i in sa:
        for key in ('step', 'exp_avg', 'exp_avg_sq'):
            assert torch.equal(sa[i][key], sb[i][key]), (i, key)


def test_precise_bn_matches_jax():
    """Three train-mode forwards over a loader of two batches (the third
    its first again) in both packages from the same weights: the running
    statistics within 1e-4; the port's parameters and dropout generator as
    they were."""
    cfg = dict(type='Recognizer2D',
               backbone=dict(type='ResNetTSM', depth=ONE_BASIC,
                             num_segments=SEGS),
               cls_head=dict(type='TSMHead3D', num_classes=5,
                             in_channels=512, num_segments=SEGS,
                             dropout_ratio=0.5))
    rng = np.random.default_rng(11)
    batches = [dict(imgs=rng.normal(size=(2, SEGS, 3, HW, HW)).astype(
        np.float32), label=np.array([i, 4 - i])) for i in range(2)]
    jcfg, tcfg = dict(cfg), dict(cfg)
    jmodel = JAX_RECOGNIZERS.get(jcfg.pop('type'))(**jcfg)
    with cut_tables():
        model = RECOGNIZERS.get(tcfg.pop('type'))(**tcfg)
        model.init_weights(torch.Generator().manual_seed(0))
        model.seed_dropout(0)
        shapes = jax.eval_shape(lambda r: jmodel.init(
            {'params': r, 'dropout': r}, batches[0], method='train_step'),
            jax.random.PRNGKey(0))
        variables = port_to_jax(shapes, {k: v.numpy() for k, v in
                                         model.state_dict().items()},
                                jnp.float32)
        variables = {'params': perturb(variables['params'], 14),
                     'batch_stats': perturb(variables['batch_stats'], 15)}
        state = TrainState(step=jnp.zeros((), jnp.int32),
                           params=variables['params'],
                           batch_stats=variables['batch_stats'],
                           moco_state={}, opt_state=None,
                           rng=jax.random.PRNGKey(0))
        want = jax_precise_bn(jmodel, state, batches, num_iters=3,
                              mesh=create_mesh(1))
    from mscl_torch.convert import load_jax_variables
    load_jax_variables(model, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.cls_head.dropout_generator(torch.device('cpu'))
    gen = model.dropout_state()
    precise_bn_update(model, batches, lambda b: to_torch(b, 'cpu'), 3)
    stats = jax_to_state_dict({'batch_stats': want.batch_stats})
    after = model.state_dict()
    for k, v in after.items():
        if k in stats:
            assert not torch.equal(v, before[k]), k
            np.testing.assert_allclose(v.numpy(), stats[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)
        else:
            assert torch.equal(v, before[k]), k
    assert torch.equal(model.dropout_state(), gen)
    assert model.training


class _Labelled:
    """A dataset of labels only: sample i is its index."""

    def __init__(self, labels, sample_by_class=False, power=0.0):
        self.video_infos = [dict(label=int(lab)) for lab in labels]
        self.sample_by_class, self.power = sample_by_class, power
        if sample_by_class:
            self.video_infos_by_class = {}
            for info in self.video_infos:
                self.video_infos_by_class.setdefault(info['label'],
                                                     []).append(info)

    def __len__(self):
        return len(self.video_infos)

    def __getitem__(self, i):
        return dict(idx=np.array([i]))


LABELS = np.random.default_rng(5).integers(0, 5, 23)
LABELS[LABELS == 3] = 1
LABELS[-1] = 7          # a class of one


@pytest.mark.parametrize('case', ['class_power0', 'class_power0.5',
                                  'class_power1', 'pk2', 'pk3',
                                  'pk2_unshuffled'])
def test_sampler_orders_bitwise(case):
    if case.startswith('class'):
        ds = _Labelled(LABELS, True, float(case[len('class_power'):]))
        sampler, shuffle = None, True
    else:
        ds = _Labelled(LABELS)
        sampler = dict(type='PKSampler' if case == 'pk3' else
                       'PKDistributedSampler', pk_sample_num=int(case[2]))
        shuffle = not case.endswith('unshuffled')
    for seed in (0, 3):
        jloader = JaxLoader(ds, 4, shuffle=shuffle, seed=seed,
                            sampler=sampler)
        loader = NumpyLoader(ds, 4, shuffle=shuffle, seed=seed,
                             sampler=sampler)
        for epoch in range(3):
            rng = np.random.default_rng(seed + epoch)
            want = jloader._class_balanced_order(rng) \
                if case.startswith('class') else \
                jloader._pk_order(rng, sampler['pk_sample_num'])
            loader.set_epoch(epoch)
            got = loader.epoch_order()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            it = iter(loader)
            served = np.concatenate([b['idx'] for b in it])
            np.testing.assert_array_equal(served, want[:len(served)])
            assert len(served) == len(want) // 4 * 4 or not loader.drop_last
