"""ResNetAudio: a 2D ResNet over spectrograms, with the frequency/time
factorized convolution pair ``ConvAudio``.

Port of ``mscl_tpu/models/backbones/resnet_audio.py`` (reference mmaction
backbones/resnet_audio.py and common/conv_audio.py), NCHW: a spectrogram
batch is (N, C, T, F), time as H and frequency as W.

- ``ConvAudio``: a (k, 1) and a (1, k) convolution side by side, each with
  its own BN and ReLU (``conv_1_conv`` / ``conv_1_bn``, ``conv_2_conv`` /
  ``conv_2_bn``), merged by 'concat' (2x the channels) or 'sum'.
- ``Bottleneck2dAudio``: 1x1 (``conv1_conv``, ``conv1_bn``, ReLU), then a
  factorized 'concat' ``ConvAudio`` (``conv2``) or, where the stage is not
  factorized, a plain 3x3 convolution with no BN and no ReLU
  (``conv2.conv``, the JAX block's ``conv2_conv``; the reference's has
  both), which carries the stride; 1x1 to 4x the planes (``conv3_conv``,
  ``conv3_bn``); a 1x1 ``downsample`` pair on the first block of a stage
  whose stride or width changes; the ReLU of the sum.
- ``ResNetAudio``: the stem ``conv1`` = ConvAudio(in, base_channels,
  ``conv1_kernel``, op 'sum'), no pooling, then depth 50 / 101 / 152's
  stages (``ARCH_AUDIO``) at ``base_channels`` x 2^i planes, the stages
  in ``factorize`` factorized. It returns the last stage.

Input layout, as JAX accepts it: a 4-D tensor whose axis 1 equals
``in_channels`` is taken as NCHW (the reference's and the port's
recognizer's); any other 4-D tensor as JAX's own (N, T, F, C) and moved to
NCHW. So with ``in_channels=1`` a (N, 1, T, F) spectrogram is NCHW, and a
(N, T, F, 1) one, whose axis 1 is T, is channels-last -- but a clip of
T = 1 frame, (N, 1, F, C), reads as NCHW there too (in both packages).

``frozen_stages``, ``norm_eval``, ``zero_init_residual`` and
``pretrained`` are accepted as the JAX module accepts them, and applied as
it applies them: not at all. The init is the JAX package's:
kaiming-normal fan_out kernels, BN 1/0.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ..builder import BACKBONES
from .resnet2d import Conv2d
from .resnet3d import init_convs_bn
from .video_resnet import make_bn

ARCH_AUDIO = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _conv(cin, cout, kernel, stride, padding, dtype):
    return Conv2d(cin, cout, kernel, stride, padding, bias=False,
                  dtype=dtype)


@BACKBONES.register_module()
class ConvAudio(nn.Module):
    """The factorized (k, 1) + (1, k) pair (reference conv_audio.py)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, op: str = 'concat', dtype=None):
        super().__init__()
        if op not in ('concat', 'sum'):
            raise ValueError(f'ConvAudio op {op!r}: concat or sum')
        dtype = compute_dtype.resolve_dtype(dtype)
        k = kernel
        self.op = op
        self.conv_1_conv = _conv(in_channels, features, (k, 1), stride,
                                 (k // 2, 0), dtype)
        self.conv_1_bn = make_bn(features, dtype)
        self.conv_2_conv = _conv(in_channels, features, (1, k), stride,
                                 (0, k // 2), dtype)
        self.conv_2_bn = make_bn(features, dtype)
        self.out_channels = features * (2 if op == 'concat' else 1)

    def forward(self, x):
        b1 = F.relu(self.conv_1_bn(self.conv_1_conv(x)))
        b2 = F.relu(self.conv_2_bn(self.conv_2_conv(x)))
        if self.op == 'concat':
            return torch.cat([b1, b2], dim=1)
        return b1 + b2


class _Conv(nn.Module):
    """A bare convolution under the name ``conv`` (the JAX block's
    ``conv2_conv``)."""

    def __init__(self, cin, cout, stride, dtype):
        super().__init__()
        self.conv = _conv(cin, cout, 3, stride, 1, dtype)

    def forward(self, x):
        return self.conv(x)


class Bottleneck2dAudio(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 2,
                 factorize: bool = True, downsample: bool = False,
                 dtype=torch.float32):
        super().__init__()
        out = planes * self.expansion
        self.conv1_conv = _conv(cin, planes, 1, 1, 0, dtype)
        self.conv1_bn = make_bn(planes, dtype)
        if factorize:
            self.conv2 = ConvAudio(planes, planes, 3, stride, op='concat',
                                   dtype=dtype)
            mid = self.conv2.out_channels
        else:
            self.conv2 = _Conv(planes, planes, stride, dtype)
            mid = planes
        self.conv3_conv = _conv(mid, out, 1, 1, 0, dtype)
        self.conv3_bn = make_bn(out, dtype)
        if downsample:
            self.downsample_conv = _conv(cin, out, 1, stride, 0, dtype)
            self.downsample_bn = make_bn(out, dtype)
        else:
            self.downsample_conv = None

    def forward(self, x):
        out = F.relu(self.conv1_bn(self.conv1_conv(x)))
        out = self.conv3_bn(self.conv3_conv(self.conv2(out)))
        res = x if self.downsample_conv is None else \
            self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + res)


@BACKBONES.register_module()
class ResNetAudio(nn.Module):

    def __init__(self, depth: int = 50, pretrained=None, in_channels: int = 1,
                 num_stages: int = 4, base_channels: int = 32,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 conv1_kernel: int = 9, conv1_stride: int = 1,
                 frozen_stages: int = -1,
                 factorize: Sequence[int] = (1, 1, 0, 0),
                 norm_eval: bool = False, zero_init_residual: bool = True,
                 dtype=None):
        super().__init__()
        dtype = compute_dtype.resolve_dtype(dtype)
        self.in_channels = in_channels
        self.conv1 = ConvAudio(in_channels, base_channels, conv1_kernel,
                               conv1_stride, op='sum', dtype=dtype)
        cin = base_channels
        for i, num_blocks in enumerate(ARCH_AUDIO[depth][:num_stages]):
            planes = base_channels * 2 ** i
            layer = []
            for b in range(num_blocks):
                stride = strides[i] if b == 0 else 1
                need_ds = b == 0 and (stride != 1 or cin != planes * 4)
                layer.append(Bottleneck2dAudio(
                    cin, planes, stride, bool(factorize[i]), need_ds, dtype))
                cin = planes * 4
            setattr(self, f'layer{i + 1}', nn.Sequential(*layer))
        self.num_stages = len(ARCH_AUDIO[depth][:num_stages])

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        init_convs_bn(self, gen)

    def forward(self, x):
        if not (x.dim() == 4 and x.shape[1] == self.in_channels):
            x = x.permute(0, 3, 1, 2)           # JAX's (N, T, F, C)
        x = self.conv1(x)
        for i in range(self.num_stages):
            x = getattr(self, f'layer{i + 1}')(x)
        return x
