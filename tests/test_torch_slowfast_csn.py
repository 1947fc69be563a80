"""ResNet3d's pathway options, ResNet3dSlowFast, ResNet3dCSN (ir and ip)
and ResNet3dLayer of mscl_torch against mscl_tpu's on the CPU
(tests/_torch_zoo_util.py: eval and train outputs, gradients, BN
statistics), and the SlowFast and ir-CSN recipes through ``train_model``
(tests/_torch_recognition_util.py, clips formatted NCTHW).

Sizes as the slice's other tests: base_channels 8 (SlowFast's fast path
2), one block a stage, T = 8 (in the 4x16 geometry the fast path sees
every frame and the slow path one; the 8x8 geometry at T = 4, the slow
path one frame of them), 32x32. The depth-50
stacks run in float64 on both sides (``hold``'s ``x64``).
"""
import numpy as np
import pytest

from mscl_tpu.models import BACKBONES as JAX_BACKBONES
from mscl_torch.config import Config
from mscl_torch.models import BACKBONES
from mscl_torch.models.backbones import resnet3d

from _torch_data_util import one_torch_thread  # noqa: F401
from _torch_port_util import xla3d_conv  # noqa: F401
from _torch_recognition_util import ROOT, check, narrow_model, sets  # noqa
from _torch_zoo_util import from_jax_init, hold

pytestmark = pytest.mark.usefixtures('xla3d_conv', 'one_torch_thread')


def _pathway(**kw):
    return dict(dict(type='resnet3d', depth=50, pretrained=None,
                     stage_blocks=(1, 1, 1, 1)), **kw)


SLOW = _pathway(lateral=True, conv1_kernel=(1, 7, 7), dilations=(1, 1, 1, 1),
                conv1_stride_t=1, pool1_stride_t=1, inflate=(0, 0, 1, 1),
                base_channels=8)
FAST = _pathway(lateral=False, base_channels=2, conv1_kernel=(5, 7, 7),
                conv1_stride_t=1, pool1_stride_t=1)

CASES = {
    # name -> (config, input (C, T, H, W), x64)
    'slowfast_4x16': (dict(type='ResNet3dSlowFast', resample_rate=8,
                           speed_ratio=8, slow_pathway=SLOW,
                           fast_pathway=FAST), (3, 8, 32, 32), True),
    'slowfast_8x8': (dict(type='ResNet3dSlowFast', resample_rate=4,
                          speed_ratio=4, slow_pathway=SLOW,
                          fast_pathway=FAST), (3, 4, 32, 32), True),
    'slowfast_no_lateral': (dict(type='ResNet3dSlowFast', resample_rate=4,
                                 speed_ratio=4,
                                 slow_pathway=dict(SLOW, lateral=False,
                                                   fusion_kernel=3),
                                 fast_pathway=FAST), (3, 4, 32, 32), True),
    'ircsn': (dict(type='ResNet3dCSN', depth=50, base_channels=8,
                   stage_blocks=(1, 1, 1, 1), bottleneck_mode='ir',
                   out_indices=(2, 3)), (3, 8, 32, 32), True),
    'ipcsn_bn_frozen': (dict(type='ResNet3dCSN', depth=50, base_channels=8,
                             stage_blocks=(1, 1, 1, 1), bottleneck_mode='ip',
                             bn_frozen=True, temporal_strides=(1, 2, 1, 1)),
                        (3, 8, 32, 32), True),
    'r18_return_stem': (dict(type='ResNet3d', depth=18, base_channels=8,
                             stage_blocks=(1, 1, 1, 1), return_stem=True,
                             out_indices=(0, 3), frozen_stages=2,
                             with_cp=True), (3, 8, 32, 32), False),
    'slowonly_norm_eval': (dict(type='ResNet3dSlowOnly', depth=50,
                                base_channels=8, stage_blocks=(1, 1, 1, 1),
                                norm_eval=True), (3, 8, 32, 32), True),
    'layer_stage2': (dict(type='ResNet3dLayer', depth=18, stage=2,
                          base_channels=8, temporal_stride=2),
                     (16, 8, 16, 16), False),
    'layer_all_frozen': (dict(type='ResNet3dLayer', depth=50, stage=3,
                              base_channels=8, spatial_stride=1, dilation=2,
                              all_frozen=True), (128, 4, 8, 8), True),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_backbone_matches_jax(name):
    cfg, shape, x64 = CASES[name]
    cfg = dict(cfg)
    typ = cfg.pop('type')
    x = np.random.default_rng(1).normal(size=(2,) + shape).astype(np.float32)
    hold(lambda dt: JAX_BACKBONES.get(typ)(dtype=dt, **cfg),
         BACKBONES.get(typ)(**cfg), x, x64=x64)


@pytest.mark.parametrize('name', ['slowfast_8x8', 'ipcsn_bn_frozen',
                                  'layer_stage2'])
def test_a_jax_init_carries_across(name):
    """The JAX modules' own init (lecun-normal laterals, depthwise kernels
    included), read by ``mscl_torch/convert.py``: the port computes what
    JAX computes."""
    cfg, shape, _ = CASES[name]
    cfg = dict(cfg)
    typ = cfg.pop('type')
    x = np.random.default_rng(4).normal(size=(2,) + shape).astype(np.float32)
    from_jax_init(JAX_BACKBONES.get(typ)(**cfg), BACKBONES.get(typ)(**cfg), x)


def test_norm_eval_and_all_frozen_modes():
    """norm_eval leaves every BN of the backbone in eval mode under
    model.train(); all_frozen the stage's; the gradient of a frozen stage's
    parameters is zeros, not none (weight decay and momentum act on them,
    as on JAX's stop_gradient)."""
    import torch
    model = BACKBONES.get('ResNet3d')(depth=18, base_channels=4,
                                      norm_eval=True).train()
    assert model.training and not any(m.training for m in model.modules()
                                      if m is not model)
    layer = BACKBONES.get('ResNet3dLayer')(depth=18, stage=1,
                                           base_channels=4,
                                           all_frozen=True).train()
    out = layer(torch.randn(1, 4, 2, 8, 8, requires_grad=True))
    out.sum().backward()
    assert all(p.grad is not None and not p.grad.any()
               for p in layer.parameters())


def test_fast_path_inflate_is_slowonly_default():
    """The fast path is a ResNet3dSlowOnly, as in the JAX module: with no
    inflate given, stages 1 and 2 are not inflated (ROADMAP.md Queue 3)."""
    model = BACKBONES.get('ResNet3dSlowFast')(slow_pathway=SLOW,
                                              fast_pathway=FAST)
    fast = model.fast_path
    assert fast.layer1[0].conv1.conv.kernel_size == (1, 1, 1)
    assert fast.layer3[0].conv1.conv.kernel_size == (3, 1, 1)


def test_csn_keeps_its_own_inflate_style():
    """ResNet3dCSN takes its '3x3x3' default (its depthwise conv) where
    ResNet3d refuses the style with Bottleneck blocks."""
    resnet3d.ResNet3dCSN(depth=50, base_channels=8, stage_blocks=(1,) * 4)
    with pytest.raises(NotImplementedError, match='inflate_style'):
        resnet3d.ResNet3d(depth=50, inflate_style='3x3x3')


R = 'recognition/'


@pytest.mark.parametrize('name', [
    R + 'slowfast/slowfast_r50_4x16x1_256e_kinetics400_rgb.py',
    R + 'slowfast/slowfast_r50_8x8x1_256e_kinetics400_rgb.py',
    R + 'csn/ircsn_r152_32x2x1_180e_kinetics400_rgb.py'])
def test_train_model_matches_jax(sets, tmp_path, name):
    """ir-CSN's layer4 runs its depthwise convs over 1x1 positions at
    these crops, and in float32 both packages drift from float64 there
    (JAX's own float32 up to 49 % of a change, the port's 3 %), so that
    recipe runs the port in float64 too (``check``'s ``port64``)."""
    check(name, *sets['rgb'], str(tmp_path), False, x64=True, ncthw=True,
          port64='/csn/' in name)


@pytest.mark.parametrize('deep,shallow', [
    ('slowfast/slowfast_r101_8x8x1_256e_kinetics400_rgb.py',
     'slowfast/slowfast_r50_8x8x1_256e_kinetics400_rgb.py')])
def test_narrowed_deeper_recipe_is_the_tested_one(deep, shallow):
    """Narrowed to one block a stage, the r101 recipe builds the very model
    of the r50 one that test_train_model_matches_jax holds."""
    def narrowed(name):
        cfg = Config.fromfile(f'{ROOT}/configs/recognition/{name}')
        model = narrow_model(cfg.to_dict()['model'])
        for path in ('slow_pathway', 'fast_pathway'):
            model['backbone'][path].pop('depth')
        return model
    assert narrowed(deep) == narrowed(shallow)
