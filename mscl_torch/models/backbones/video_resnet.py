"""Video ResNets: torchvision r3d_18 and the slim MSCL flow ResNet.

Port of ``mscl_tpu/models/backbones/video_resnet.py`` (``ConvBN``,
``BasicBlock3D``, ``VideoResNet``). NCTHW activations, ``nn.Conv3d``
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
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, kernel, stride, padding, bias=False)
        self.compute_dtype = dtype

    def forward(self, x):
        return compute_dtype.conv3d(self, x, self.compute_dtype)


class ConvBN(nn.Sequential):
    """Conv3d (no bias) -> BN (-> ReLU), torch-style symmetric padding."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int, int],
                 stride: Tuple[int, int, int] = (1, 1, 1),
                 padding: Optional[Tuple[int, int, int]] = None,
                 relu: bool = True, dtype: torch.dtype = torch.float32):
        if padding is None:
            padding = tuple(k // 2 for k in kernel)
        bn = BatchNorm3d(cout) if dtype == torch.float32 else \
            LowPrecisionBatchNorm(cout, dtype)
        layers = [Conv3dNoBias(cin, cout, kernel, stride, padding, dtype), bn]
        if relu:
            layers.append(nn.ReLU(inplace=True))
        super().__init__(*layers)


# conv maker -> (kernel, stride, padding) for a given stride
_CONV_MAKERS = {
    'simple3d': lambda s: ((3, 3, 3), (s, s, s), (1, 1, 1)),
    'no_temporal': lambda s: ((1, 3, 3), (1, s, s), (0, 1, 1)),
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


class VideoResNet(nn.Module):
    """Video ResNet over NCTHW clips with BasicBlock3D stages.

    stem: 'r3d' (torchvision: (3,7,7), stride (1,2,2)) or 'flow_basic'
    ((1,7,7), stride (2,2,2), halves T).
    """

    def __init__(self, conv_makers: Sequence[str] = ('simple3d',) * 4,
                 layers: Sequence[int] = (2, 2, 2, 2), stem: str = 'r3d',
                 base_width: int = 64, in_channels: int = 3, dtype=None):
        super().__init__()
        dtype = compute_dtype.resolve_dtype(dtype)
        if stem == 'r3d':
            self.stem = ConvBN(in_channels, base_width, (3, 7, 7), (1, 2, 2),
                               (1, 3, 3), dtype=dtype)
        elif stem == 'flow_basic':
            self.stem = ConvBN(in_channels, base_width, (1, 7, 7), (2, 2, 2),
                               (0, 3, 3), dtype=dtype)
        else:
            raise ValueError(f'unknown stem {stem}')
        cin = base_width
        for i in range(4):
            planes = base_width * 2 ** i
            blocks = []
            for j in range(layers[i]):
                stride = 2 if (i > 0 and j == 0) else 1
                blocks.append(BasicBlock3D(cin, planes, conv_makers[i],
                                           stride, dtype))
                cin = planes
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
        x = self.stem(x)
        outs = []
        for i in range(4):
            x = getattr(self, f'layer{i + 1}')(x)
            outs.append(x)
        return outs


def _register(name, **kwargs):
    BACKBONES.register_module(name=name, module=partial(VideoResNet, **kwargs))


_register('torchvision.r3d_18', conv_makers=('simple3d',) * 4,
          layers=(2, 2, 2, 2), stem='r3d', base_width=64)
_register('resnet_flow.r2d_18', conv_makers=('no_temporal',) * 4,
          layers=(2, 2, 2, 2), stem='flow_basic', base_width=16)
