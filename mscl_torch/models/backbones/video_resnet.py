"""Video ResNets: torchvision r3d_18 / mc3_18 and the slim MSCL flow family.

Port of ``mscl_tpu/models/backbones/video_resnet.py`` (``ConvBN``,
``BasicBlock3D``, ``Bottleneck3D``, ``VideoResNet`` and its registrations:
the ``r3d``, ``flow_basic``, ``flow_2d``, ``flow_2d_v2`` and
``flow_bottleneck`` stems, the ``simple3d``, ``no_temporal`` and
``no_downsample`` conv makers). NCTHW activations, ``nn.Conv3d``
(cuDNN) convolutions, torchvision module names (``stem``, ``layer1.0.conv1``
with the conv at index 0 and the BN at index 1). The model returns its
per-stage outputs. BN statistics are taken over the whole batch it is given
(the JAX package's replacement for ShuffleBN).

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
                 dtype: torch.dtype = torch.float32, dilation=1):
        super().__init__(cin, cout, kernel, stride, padding, dilation,
                         bias=False)
        self.compute_dtype = dtype

    def forward(self, x):
        return compute_dtype.conv3d(self, x, self.compute_dtype)


def make_bn(channels: int, dtype: torch.dtype) -> BatchNorm3d:
    """The JAX package's BN in the compute dtype: float32 BatchNorm3d, else
    LowPrecisionBatchNorm."""
    return BatchNorm3d(channels) if dtype == torch.float32 else \
        LowPrecisionBatchNorm(channels, dtype)


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

    stem: 'r3d' (torchvision: (3,7,7), stride (1,2,2)), 'flow_basic'
    ((1,7,7), stride (2,2,2), halves T), 'flow_2d' (frame pairs as
    channels, then (1,7,7) at (1,2,2)), 'flow_2d_v2' (every other frame,
    then the same conv) or 'flow_bottleneck' (flow_basic's conv, then a
    (1,3,3) max-pool at (1,2,2), appended to the stem's Sequential, so
    its state keys stay ``stem.0`` and ``stem.1``).
    """

    def __init__(self, block: str = 'basic',
                 conv_makers: Sequence[str] = ('simple3d',) * 4,
                 layers: Sequence[int] = (2, 2, 2, 2), stem: str = 'r3d',
                 base_width: int = 64, in_channels: int = 3, dtype=None):
        super().__init__()
        dtype = compute_dtype.resolve_dtype(dtype)
        self.frames = None
        if stem == 'r3d':
            self.stem = ConvBN(in_channels, base_width, (3, 7, 7), (1, 2, 2),
                               (1, 3, 3), dtype=dtype)
        elif stem in ('flow_basic', 'flow_bottleneck'):
            self.stem = ConvBN(in_channels, base_width, (1, 7, 7), (2, 2, 2),
                               (0, 3, 3), dtype=dtype)
            if stem == 'flow_bottleneck':
                self.stem.append(nn.MaxPool3d((1, 3, 3), (1, 2, 2),
                                              (0, 1, 1)))
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

    def forward(self, x):
        if self.frames is not None:
            x = self.frames(x)
        x = self.stem(x)
        outs = []
        for i in range(4):
            x = getattr(self, f'layer{i + 1}')(x)
            outs.append(x)
        return outs


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
