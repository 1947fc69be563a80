"""Video ResNets: torchvision r3d_18 / mc3_18, the slim MSCL flow family,
R(2+1)D and the configurable R3D.

Port of ``mscl_tpu/models/backbones/video_resnet.py`` (``ConvBN``,
``BasicBlock3D``, ``Bottleneck3D``, ``VideoResNet`` and its registrations:
the ``r3d``, ``r3d_pool``, ``flow_basic``, ``flow_2d``, ``flow_2d_v2``
and ``flow_bottleneck`` stems, the ``simple3d``, ``no_temporal`` and
``no_downsample`` conv makers, ``out_indices``, ``single_out`` and
``frozen_stages``; ``R2Plus1dBlock`` and ``ResNet2Plus1d``; the ``R3D``
adapter). NCTHW activations, ``nn.Conv3d``
(cuDNN) convolutions, torchvision module names (``stem``, ``layer1.0.conv1``
with the conv at index 0 and the BN at index 1). The model returns its
per-stage outputs. BN statistics are taken over the whole batch it is given
(the JAX package's replacement for ShuffleBN). ``ConvModule`` is the JAX
``ConvBN`` where the tree names its parts ``conv`` and ``bn`` (ResNet3d,
R(2+1)D, S3D).

With a compute dtype other than float32 (``dtype``), each convolution casts
its input and kernel to it and its BN is ``LowPrecisionBatchNorm`` (the JAX
package's default BN); parameters and statistics stay float32.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ..builder import BACKBONES
from ...ops.batch_norm import BatchNorm3d, LowPrecisionBatchNorm


class Conv3dNoBias(nn.Conv3d):
    """Bias-free Conv3d that computes in ``dtype`` (x and kernel cast)."""

    def __init__(self, cin, cout, kernel, stride, padding,
                 dtype: torch.dtype = torch.float32, dilation=1,
                 groups: int = 1):
        super().__init__(cin, cout, kernel, stride, padding, dilation,
                         groups=groups, bias=False)
        self.compute_dtype = dtype

    def forward(self, x):
        return compute_dtype.conv3d(self, x, self.compute_dtype)


def make_bn(channels: int, dtype: torch.dtype) -> BatchNorm3d:
    """The JAX package's BN in the compute dtype: float32 BatchNorm3d, else
    LowPrecisionBatchNorm."""
    return BatchNorm3d(channels) if dtype == torch.float32 else \
        LowPrecisionBatchNorm(channels, dtype)


def _triple(v) -> Tuple[int, int, int]:
    return (v,) * 3 if isinstance(v, int) else tuple(v)


class ConvModule(nn.Module):
    """mmcv's ConvModule as the configs build it (the JAX package's ConvBN
    outside a VideoResNet): a bias-free Conv3d (``conv``), BN (``bn``),
    then a ReLU unless ``relu=False``."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0,
                 dilation=1, relu: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv3dNoBias(cin, cout, _triple(kernel), _triple(stride),
                                 _triple(padding), dtype, _triple(dilation))
        self.bn = make_bn(cout, dtype)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x, inplace=True) if self.relu else x


class _StopGradient(torch.autograd.Function):
    """The identity whose gradient is zero: ``jax.lax.stop_gradient``, so
    the parameters before it get a gradient of zeros (which weight decay
    and momentum then act on, as in the JAX step), not none."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return torch.zeros_like(grad)


def stop_gradient(x: torch.Tensor) -> torch.Tensor:
    return _StopGradient.apply(x) if x.requires_grad else x


class ConvBN(nn.Sequential):
    """Conv3d (no bias) -> BN (-> ReLU), torch-style symmetric padding."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int, int],
                 stride: Tuple[int, int, int] = (1, 1, 1),
                 padding: Optional[Tuple[int, int, int]] = None,
                 relu: bool = True, dtype: torch.dtype = torch.float32):
        if padding is None:
            padding = tuple(k // 2 for k in kernel)
        layers = [Conv3dNoBias(cin, cout, kernel, stride, padding, dtype),
                  make_bn(cout, dtype)]
        if relu:
            layers.append(nn.ReLU(inplace=True))
        super().__init__(*layers)


# conv maker -> (kernel, stride, padding) for a given stride; the stride is
# also the 1x1x1 downsample's
_CONV_MAKERS = {
    'simple3d': lambda s: ((3, 3, 3), (s, s, s), (1, 1, 1)),
    'no_temporal': lambda s: ((1, 3, 3), (1, s, s), (0, 1, 1)),
    'no_downsample': lambda s: ((3, 3, 3), (1, s, s), (1, 1, 1)),
}


class BasicBlock3D(nn.Module):
    """conv-bn-relu, conv-bn, plus an identity or 1x1x1 downsample."""

    def __init__(self, cin: int, planes: int, maker: str, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kernel, stride3, pad = _CONV_MAKERS[maker](stride)
        kernel2, _, pad2 = _CONV_MAKERS[maker](1)
        self.conv1 = ConvBN(cin, planes, kernel, stride3, pad, dtype=dtype)
        self.conv2 = ConvBN(planes, planes, kernel2, (1, 1, 1), pad2,
                            relu=False, dtype=dtype)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = ConvBN(cin, planes, (1, 1, 1), stride3,
                                     (0, 0, 0), relu=False, dtype=dtype)

    def forward(self, x):
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv2(self.conv1(x)) + res, inplace=True)


class Bottleneck3D(nn.Module):
    """1x1x1, the maker's conv, 1x1x1 to 4x the planes, plus an identity or
    1x1x1 downsample (torchvision's Bottleneck layout)."""
    expansion = 4

    def __init__(self, cin: int, planes: int, maker: str, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kernel, stride3, pad = _CONV_MAKERS[maker](stride)
        out = planes * self.expansion
        self.conv1 = ConvBN(cin, planes, (1, 1, 1), (1, 1, 1), (0, 0, 0),
                            dtype=dtype)
        self.conv2 = ConvBN(planes, planes, kernel, stride3, pad, dtype=dtype)
        self.conv3 = ConvBN(planes, out, (1, 1, 1), (1, 1, 1), (0, 0, 0),
                            relu=False, dtype=dtype)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = ConvBN(cin, out, (1, 1, 1), stride3, (0, 0, 0),
                                     relu=False, dtype=dtype)

    def forward(self, x):
        res = x if self.downsample is None else self.downsample(x)
        out = self.conv3(self.conv2(self.conv1(x)))
        return F.relu(out + res, inplace=True)


class _PairFrames(nn.Module):
    """flow_2d: adjacent frames paired into channels, (N, C, T, H, W) ->
    (N, 2C, T/2, H, W), the second frame's channels after the first's."""

    def forward(self, x):
        n, c, t, h, w = x.shape
        x = x.reshape(n, c, t // 2, 2, h, w).permute(0, 3, 1, 2, 4, 5)
        return x.reshape(n, 2 * c, t // 2, h, w)


class _EveryOtherFrame(nn.Module):
    """flow_2d_v2: frames 0, 2, 4, ... (``temporal_subsample(x, 2)``)."""

    def forward(self, x):
        return x[:, :, ::2]


class VideoResNet(nn.Module):
    """Video ResNet over NCTHW clips with BasicBlock3D or Bottleneck3D
    stages.

    stem: 'r3d' (torchvision: (3,7,7), stride (1,2,2)), 'r3d_pool' (r3d's
    conv, then a (1,3,3) max-pool at (1,2,2): the reference r3d.py's
    BasicDownSampleStem), 'flow_basic' ((1,7,7), stride (2,2,2), halves
    T), 'flow_2d' (frame pairs as channels, then (1,7,7) at (1,2,2)),
    'flow_2d_v2' (every other frame, then the same conv) or
    'flow_bottleneck' (flow_basic's conv, then the (1,3,3) max-pool). A
    max-pool is appended to the stem's Sequential, so its state keys stay
    ``stem.0`` and ``stem.1``.

    Returns the stages of ``out_indices`` as a list, or with ``single_out``
    the last stage alone. ``frozen_stages`` as the JAX module takes it: -1
    none, 0 the stem, n >= 1 the stem and stages 1..n; a frozen part's BN
    runs on its running statistics in training too, and the gradient stops
    after it (``stop_gradient``: its parameters get zeros).
    """

    def __init__(self, block: str = 'basic',
                 conv_makers: Sequence[str] = ('simple3d',) * 4,
                 layers: Sequence[int] = (2, 2, 2, 2), stem: str = 'r3d',
                 base_width: int = 64, in_channels: int = 3,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 single_out: bool = False, frozen_stages: int = -1,
                 dtype=None):
        super().__init__()
        dtype = compute_dtype.resolve_dtype(dtype)
        self.frames = None
        pool = nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        if stem in ('r3d', 'r3d_pool'):
            self.stem = ConvBN(in_channels, base_width, (3, 7, 7), (1, 2, 2),
                               (1, 3, 3), dtype=dtype)
            if stem == 'r3d_pool':
                self.stem.append(pool)
        elif stem in ('flow_basic', 'flow_bottleneck'):
            self.stem = ConvBN(in_channels, base_width, (1, 7, 7), (2, 2, 2),
                               (0, 3, 3), dtype=dtype)
            if stem == 'flow_bottleneck':
                self.stem.append(pool)
        elif stem in ('flow_2d', 'flow_2d_v2'):
            cin = 2 * in_channels if stem == 'flow_2d' else in_channels
            self.stem = ConvBN(cin, base_width, (1, 7, 7), (1, 2, 2),
                               (0, 3, 3), dtype=dtype)
            self.frames = _PairFrames() if stem == 'flow_2d' else \
                _EveryOtherFrame()
        else:
            raise ValueError(f'unknown stem {stem}')
        if block not in ('basic', 'bottleneck'):
            raise ValueError(f'unknown block {block}')
        block_cls = BasicBlock3D if block == 'basic' else Bottleneck3D
        expansion = 1 if block == 'basic' else Bottleneck3D.expansion
        cin = base_width
        for i in range(4):
            planes = base_width * 2 ** i
            blocks = []
            for j in range(layers[i]):
                stride = 2 if (i > 0 and j == 0) else 1
                blocks.append(block_cls(cin, planes, conv_makers[i], stride,
                                        dtype))
                cin = planes * expansion
            setattr(self, f'layer{i + 1}', nn.Sequential(*blocks))
        self.out_indices = tuple(out_indices)
        self.single_out = single_out
        self.frozen_stages = frozen_stages

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        """torchvision init: kaiming-normal fan_out convs, BN 1/0."""
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                nn.init.kaiming_normal_(m.weight, mode='fan_out',
                                        nonlinearity='relu', generator=gen)
            elif isinstance(m, BatchNorm3d):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def _frozen(self):
        """The stem and the stages that ``frozen_stages`` freezes."""
        parts = [self.stem] + [getattr(self, f'layer{i + 1}')
                               for i in range(4)]
        return parts[:self.frozen_stages + 1]

    def train(self, mode: bool = True):
        super().train(mode)
        for part in self._frozen():
            part.train(False)
        return self

    def forward(self, x):
        if self.frames is not None:
            x = self.frames(x)
        x = self.stem(x)
        if self.frozen_stages >= 0:
            x = stop_gradient(x)
        outs = []
        for i in range(4):
            x = getattr(self, f'layer{i + 1}')(x)
            if self.frozen_stages >= i + 1:
                x = stop_gradient(x)
            outs.append(x)
        if self.single_out:
            return outs[-1]
        return [outs[i] for i in self.out_indices]


def _register(name, **kwargs):
    BACKBONES.register_module(name=name, module=partial(VideoResNet, **kwargs))


# torchvision family
_register('torchvision.r3d_18', conv_makers=('simple3d',) * 4,
          layers=(2, 2, 2, 2), stem='r3d', base_width=64)
_register('torchvision.mc3_18',
          conv_makers=('simple3d',) + ('no_temporal',) * 3,
          layers=(2, 2, 2, 2), stem='r3d', base_width=64)

# slim flow family
_register('resnet_flow.r2d_18', conv_makers=('no_temporal',) * 4,
          layers=(2, 2, 2, 2), stem='flow_basic', base_width=16)
_register('resnet_flow.r2dv2_18', conv_makers=('no_temporal',) * 4,
          layers=(2, 2, 2, 2), stem='flow_2d', base_width=16)
_register('resnet_flow.r2dv3_18', conv_makers=('no_temporal',) * 4,
          layers=(2, 2, 2, 2), stem='flow_2d_v2', base_width=16)
_register('resnet_flow.mx2d_18',
          conv_makers=('no_temporal',) * 3 + ('simple3d',),
          layers=(2, 2, 2, 2), stem='flow_basic', base_width=16)
_register('resnet_flow.r3d_18', conv_makers=('simple3d',) * 4,
          layers=(2, 2, 2, 2), stem='flow_basic', base_width=16)
_register('resnet_flow.r3dv2_18', conv_makers=('no_downsample',) * 4,
          layers=(2, 2, 2, 2), stem='flow_basic', base_width=16)
_register('resnet_flow.mc3_18',
          conv_makers=('simple3d',) + ('no_temporal',) * 3,
          layers=(2, 2, 2, 2), stem='flow_basic', base_width=16)
_register('resnet_flow.r2d_50', block='bottleneck',
          conv_makers=('no_temporal',) * 4, layers=(3, 4, 6, 3),
          stem='flow_bottleneck', base_width=8)


class R2Plus1dBlock(nn.Module):
    """The (2+1)D block: each 3x3x3 conv factorised into a (1,3,3) spatial
    ConvBN-ReLU to torchvision's middle width and a (3,1,1) temporal conv
    (``conv{n}_s``, ``conv{n}_t``), then BN (``bn{n}``); the stride on both
    halves of the first; an identity or a 1x1x1 downsample at the stride in
    all three axes."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for n, (i, s) in enumerate(((cin, stride), (planes, 1)), 1):
            mid = (i * planes * 3 * 3 * 3) // (i * 3 * 3 + 3 * planes)
            setattr(self, f'conv{n}_s', ConvModule(
                i, mid, (1, 3, 3), (1, s, s), (0, 1, 1), dtype=dtype))
            setattr(self, f'conv{n}_t', Conv3dNoBias(
                mid, planes, (3, 1, 1), (s, 1, 1), (1, 0, 0), dtype))
            setattr(self, f'bn{n}', make_bn(planes, dtype))
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = ConvModule(cin, planes, 1, stride, 0,
                                         relu=False, dtype=dtype)

    def forward(self, x):
        res = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1_t(self.conv1_s(x))), inplace=True)
        out = self.bn2(self.conv2_t(self.conv2_s(out)))
        return F.relu(out + res, inplace=True)


@BACKBONES.register_module()
class ResNet2Plus1d(nn.Module):
    """R(2+1)D-18/34 (torchvision r2plus1d_18's geometry): a (1,7,7) stem to
    45 channels at (1,2,2) and a (3,1,1) one to ``base_width``
    (``stem_s``, ``stem_t``, each ConvBN-ReLU), then four stages of
    ``R2Plus1dBlock``, the first block of stages 2-4 at stride 2 in T, H
    and W. Returns the four stages as a list.

    The reference config surface (``pretrained2d``, ``norm_eval``,
    ``conv1_kernel``, ``inflate``, ``spatial_strides``, ``temporal_strides``,
    ``zero_init_residual``, the cfg dicts ...) is accepted and, as in the
    JAX module, not read: the shipped values are this fixed geometry, and
    ``norm_eval`` is not applied there either."""

    def __init__(self, depth: int = 18, pretrained=None, base_width: int = 64,
                 layers=None, pretrained2d: bool = False,
                 norm_eval: bool = False, conv_cfg=None, norm_cfg=None,
                 act_cfg=None, conv1_kernel=(3, 7, 7),
                 conv1_stride_t: int = 1, pool1_stride_t: int = 1,
                 inflate=(1, 1, 1, 1), spatial_strides=(1, 2, 2, 2),
                 temporal_strides=(1, 2, 2, 2),
                 zero_init_residual: bool = False, in_channels: int = 3,
                 dtype=None):
        super().__init__()
        dtype = compute_dtype.resolve_dtype(dtype)
        layers = layers or {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}[depth]
        self.stem_s = ConvModule(in_channels, 45, (1, 7, 7), (1, 2, 2),
                                 (0, 3, 3), dtype=dtype)
        self.stem_t = ConvModule(45, base_width, (3, 1, 1), 1, (1, 0, 0),
                                 dtype=dtype)
        cin = base_width
        for i, num_blocks in enumerate(layers):
            planes = base_width * 2 ** i
            blocks = []
            for b in range(num_blocks):
                blocks.append(R2Plus1dBlock(
                    cin, planes, 2 if (i > 0 and b == 0) else 1, dtype))
                cin = planes
            setattr(self, f'layer{i + 1}', nn.Sequential(*blocks))
        self.num_stages = len(layers)

    init_weights = VideoResNet.init_weights

    def forward(self, x):
        x = self.stem_t(self.stem_s(x))
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f'layer{i + 1}')(x)
            outs.append(x)
        return outs


# the configurable R3D's names (reference r3d.py:216-363)
_R3D_BLOCKS = {'BasicBlock': 'basic', 'Bottleneck': 'bottleneck'}
_R3D_MAKERS = {'Conv3DSimple': 'simple3d',
               'Conv3DNoTemporal': 'no_temporal',
               'Conv3DNoDownSample': 'no_downsample'}
_R3D_STEMS = {'BasicStem': 'r3d', 'BasicDownSampleStem': 'r3d_pool'}


def r3d(block='BasicBlock', conv_makers='Conv3DSimple',
        layers=(2, 2, 2, 2), stem='BasicStem', frozen_stages=-1,
        zero_init_residual=False, use_dilation=False, num_classes=400,
        pretrained=None, **kwargs):
    """The configurable R3D with the reference's names: blocks BasicBlock /
    Bottleneck, conv makers Conv3DSimple / Conv3DNoTemporal /
    Conv3DNoDownSample (one name or one a stage), stems BasicStem /
    BasicDownSampleStem, as a 64-wide ``VideoResNet`` (``out_indices``,
    ``single_out`` and ``frozen_stages`` passed on). Conv2Plus1D in every
    stage with the R2Plus1dStem is ``ResNet2Plus1d`` with these
    ``layers``; a mix of Conv2Plus1D and other makers is refused, as the
    JAX adapter refuses it. ``zero_init_residual``, ``use_dilation``,
    ``num_classes`` and ``pretrained`` are accepted and not read."""
    if isinstance(conv_makers, str):
        conv_makers = [conv_makers] * 4
    if 'Conv2Plus1D' in conv_makers or stem == 'R2Plus1dStem':
        if not (all(m == 'Conv2Plus1D' for m in conv_makers) and
                stem == 'R2Plus1dStem'):
            raise NotImplementedError(
                'R3D: mixed Conv2Plus1D conv_makers are not supported (the '
                'factorised geometry is ResNet2Plus1d in every stage)')
        return ResNet2Plus1d(layers=tuple(layers), **kwargs)
    return VideoResNet(
        block=_R3D_BLOCKS[block],
        conv_makers=tuple(_R3D_MAKERS[m] for m in conv_makers),
        layers=tuple(layers), stem=_R3D_STEMS[stem], base_width=64,
        frozen_stages=frozen_stages, **kwargs)


BACKBONES.register_module(name='R3D', module=r3d)
