"""MobileNetV2 and its TSM variant over frames (NCHW).

Port of ``mscl_tpu/models/backbones/mobilenet_v2.py`` (reference mmaction
mobilenet_v2.py and mobilenet_v2_tsm.py): a 3x3 stem at stride 2, the
inverted-residual stages of the (expand ratio, channels, blocks, stride)
table, then a 1x1 conv to 1280 (scaled by ``widen_factor`` above 1);
ReLU6 throughout, no activation after a block's projection. The TSM
variant shifts the input of every block that has a residual connection
(``resnet2d.temporal_shift``). Returns the stages of ``out_indices`` (0-6
the seven stages, 7 the last conv).

Names are the JAX tree's: ``conv1``, ``layer{i}.{j}`` (``expand``,
``depthwise``: conv ``conv`` and BN ``bn``; ``project``, ``project_bn``),
``conv2``; the depthwise kernels in torch's grouped layout (C, 1, 3, 3).
``frozen_stages`` and ``norm_eval`` are accepted and ignored, as the JAX
module ignores them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ..builder import BACKBONES
from .resnet2d import Conv2d, temporal_shift
from .resnet3d import init_convs_bn
from .video_resnet import make_bn

# (expand_ratio, channels, num_blocks, stride)
ARCH = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _ConvBNReLU6(nn.Module):

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2,
                           groups=groups, bias=False, dtype=dtype)
        self.bn = make_bn(cout, dtype)

    def forward(self, x):
        return F.relu6(self.bn(self.conv(x)))


class InvertedResidual(nn.Module):

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 expand_ratio: int = 6, shift: bool = False,
                 num_segments: int = 8, shift_div: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_res = stride == 1 and cin == cout
        self.shift = shift and self.use_res
        self.num_segments, self.shift_div = num_segments, shift_div
        hidden = int(round(cin * expand_ratio))
        self.expand = _ConvBNReLU6(cin, hidden, 1, dtype=dtype) \
            if expand_ratio != 1 else None
        self.depthwise = _ConvBNReLU6(hidden, hidden, 3, stride,
                                      groups=hidden, dtype=dtype)
        self.project = Conv2d(hidden, cout, 1, bias=False, dtype=dtype)
        self.project_bn = make_bn(cout, dtype)

    def forward(self, x):
        y = temporal_shift(x, self.num_segments, self.shift_div) \
            if self.shift else x
        if self.expand is not None:
            y = self.expand(y)
        y = self.project_bn(self.project(self.depthwise(y)))
        return x + y if self.use_res else y


@BACKBONES.register_module()
class MobileNetV2(nn.Module):
    shift_default = False

    def __init__(self, pretrained=None, widen_factor: float = 1.0,
                 out_indices=(7,), frozen_stages: int = -1,
                 norm_eval: bool = False, shift=None, is_shift: bool = True,
                 num_segments: int = 8, shift_div: int = 8, dtype=None):
        super().__init__()
        dtype = compute_dtype.resolve_dtype(dtype)
        shift = (self.shift_default if shift is None else shift) and is_shift
        self.out_indices = tuple(out_indices)
        c = _make_divisible(32 * widen_factor)
        self.conv1 = _ConvBNReLU6(3, c, 3, 2, dtype=dtype)   # RGB frames
        for i, (t, ch, n, s) in enumerate(ARCH):
            out_c = _make_divisible(ch * widen_factor)
            blocks = []
            for b in range(n):
                blocks.append(InvertedResidual(
                    c, out_c, s if b == 0 else 1, t, shift=shift,
                    num_segments=num_segments, shift_div=shift_div,
                    dtype=dtype))
                c = out_c
            setattr(self, f'layer{i + 1}', nn.Sequential(*blocks))
        self.conv2 = _ConvBNReLU6(
            c, _make_divisible(1280 * max(widen_factor, 1.0)), 1,
            dtype=dtype)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        init_convs_bn(self, gen)

    def forward(self, x):
        x = self.conv1(x)
        outs = []
        for i in range(len(ARCH)):
            x = getattr(self, f'layer{i + 1}')(x)
            outs.append(x)
        outs.append(self.conv2(x))
        picked = [outs[i] for i in self.out_indices]
        return picked[0] if len(picked) == 1 else picked


@BACKBONES.register_module()
class MobileNetV2TSM(MobileNetV2):
    shift_default = True
